"""Build and bind the port's CUDA kernels (``csrc/legion_kernels.cu``).

``nvcc`` compiles the source for Hopper (``sm_90a``) into a shared
library with a plain C interface, which ``ctypes`` loads. The build runs
at the first kernel launch, never at import, into
``legion_tpu_torch/_build/``; the file name carries a hash of the
source, so an edited ``.cu`` rebuilds. A failed build raises.

Every launcher takes pointers and the CUDA stream as ``c_void_p`` (a
bare Python int would be cut to 32 bits) and returns
``cudaGetLastError()`` so a refused launch is seen at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "legion_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# launcher name -> argtypes (every launcher returns a cudaError_t as int)
_SIGNATURES = {
    # x, x_dtype, mask, out, out_dtype, n, p, f, d, offset, norm, stream
    "legion_identity_masked_mean": (_P, _I, _P, _P, _I, _L, _L, _I, _I, _L,
                                    _I, _P),
    # h, dtype, pos, mask, out, n, p, f, d, ld (h's row stride), norm, stream
    "legion_gathered_masked_mean": (_P, _I, _P, _P, _P, _L, _L, _I, _I, _L,
                                    _I, _P),
    # g, g_dtype, pos, mask, dx (f32 staging), n, p, f, d, ld (dx's row
    # stride), norm, stream
    "legion_gathered_masked_mean_bwd": (_P, _I, _P, _P, _P, _L, _L, _I, _I,
                                        _L, _I, _P),
    # in (f32 staging), out, out_dtype, n, d, ld, stream
    "legion_narrow_rows": (_P, _P, _I, _L, _I, _L, _P),
    # table, ids, out, m, n, row_bytes, stream
    "legion_gather_rows": (_P, _P, _P, _L, _L, _L, _P),
    # indptr, indices, frontier, u, out, p, f, stream
    "legion_sample_neighbors": (_P, _P, _P, _P, _P, _L, _I, _P),
    # x, dtype, mask, mask_is_weight, out, p, f, d, stream
    "legion_grouped_masked_sum": (_P, _I, _P, _I, _P, _L, _I, _I, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NORM_CODES = {"mean": 0, "sqrt": 1, "sum": 2}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"legion_kernels_{digest}.so"


def build() -> Path:
    """Compile the kernels unless a build of this exact source exists.
    The compiler's output (register and spill counts from ``-Xptxas -v``)
    is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr[-4000:]}")
    os.replace(tmp, so)          # atomic: a reader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> None:
    """The kernel path takes contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"kernel inputs must share one CUDA device; "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
