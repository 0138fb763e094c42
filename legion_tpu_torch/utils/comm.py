"""Communication accounting (counterpart of ``legion_tpu/utils/comm.py``).

The reference asserts closed forms of each collective's volume against the
collectives in a program's compiled HLO. The port has no HLO: every
collective it makes goes through the wrappers below, which count the
bytes of each call by op kind on this rank. ``reset_counts`` and
``read_counts`` bracket a step (or any span), and the closed forms are
asserted against what was read.

A call's bytes are the reference's HLO output bytes of the same op: the
tensor handed in for ``all_reduce`` and ``all_to_all`` (whose output is as
large), the gathered tensor for ``all_gather``, this rank's share for
``reduce_scatter``, the received tensor for ``ppermute`` (counted as the
reference's ``collective-permute``), and the pickled object for
``all_gather_object``.

The all-gather and the reduce-scatter are ``dist.all_gather`` and
``dist.reduce_scatter`` over lists of tensors: the tensor forms
(``all_gather_into_tensor``, ``reduce_scatter_tensor``) print a
deprecation warning under gloo on newer torch, and their replacements do
not exist on older torch; the list forms run on both and on NCCL.

``stage_through_host(True)`` is the share-device mode of
``parallel.mesh`` (several gloo ranks on one card): each wrapper then
copies CUDA tensors to host memory, runs the collective there and copies
the result back, counting the same bytes. Nothing else stages: a CUDA
tensor handed to a gloo group outside that mode fails in ``dist``. A
staging copy reads the device on the host, so in that mode a wrapper
called while the current stream is capturing a CUDA graph raises before
it breaks the capture.

Counts survive replays of captured steps: a replay makes no Python call,
so ``train/graphed.py`` takes a ``snapshot`` before a capture, keeps what
the capture counted (``since``), puts the counts back (``restore``) and
``add``s that much at every replay.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

_COUNTS: Dict[str, int] = {}
_CALLS: Dict[str, int] = {}
_STAGE = {"on": False}


def _count(op: str, nbytes: int) -> None:
    _COUNTS[op] = _COUNTS.get(op, 0) + int(nbytes)
    _CALLS[op] = _CALLS.get(op, 0) + 1


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def reset_counts() -> None:
    _COUNTS.clear()
    _CALLS.clear()


def read_counts() -> Dict[str, int]:
    """Bytes by op kind since the last reset."""
    return dict(_COUNTS)


def read_calls() -> Dict[str, int]:
    """Calls by op kind since the last reset."""
    return dict(_CALLS)


def snapshot() -> Tuple[Dict[str, int], Dict[str, int]]:
    """(bytes, calls) by op kind as they stand."""
    return dict(_COUNTS), dict(_CALLS)


def since(before: Tuple[Dict[str, int], Dict[str, int]]
          ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(bytes, calls) counted since ``before`` was taken."""
    return tuple({op: n - old.get(op, 0) for op, n in now.items()
                  if n != old.get(op, 0)}
                 for now, old in zip(snapshot(), before))


def restore(before: Tuple[Dict[str, int], Dict[str, int]]) -> None:
    """The counts put back as ``before`` holds them."""
    for now, old in zip((_COUNTS, _CALLS), before):
        now.clear()
        now.update(old)


def add(delta: Tuple[Dict[str, int], Dict[str, int]]) -> None:
    """``since``'s (bytes, calls) added to the counts."""
    for now, more in zip((_COUNTS, _CALLS), delta):
        for op, n in more.items():
            now[op] = now.get(op, 0) + n


def stage_through_host(on: bool) -> None:
    """Set by ``parallel.mesh.init_process``: on only in its share-device
    mode."""
    _STAGE["on"] = bool(on)


def _host(t: torch.Tensor) -> torch.Tensor:
    if not _STAGE["on"]:
        return t
    if _capturing():
        raise RuntimeError(
            "a collective of the share-device mode stages through host "
            "memory and cannot run while a CUDA graph is being captured")
    return t.cpu() if t.is_cuda else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(tensor: torch.Tensor) -> torch.Tensor:
    """In-place sum over every rank (``dist.all_reduce``); returns
    ``tensor``."""
    _count("all_reduce", _nbytes(tensor))
    buf = _host(tensor)
    dist.all_reduce(buf)
    if buf is not tensor:
        tensor.copy_(buf)
    return tensor


def all_to_all(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_to_all_single`` with equal splits along dim 0: block p
    of the result is block ``me`` of rank p's ``tensor``."""
    _count("all_to_all", _nbytes(tensor))
    src = _host(tensor.contiguous())
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(tensor.device)


def all_gather(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``tensor`` of ``group``, concatenated in rank order
    along dim 0."""
    k = dist.get_world_size(group)
    _count("all_gather", k * _nbytes(tensor))
    src = _host(tensor.contiguous())
    parts = [torch.empty_like(src) for _ in range(k)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(tensor.device)


def reduce_scatter(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of ``group`` of ``tensor``'s block ``me``
    along dim 0 (k equal blocks)."""
    k = dist.get_world_size(group)
    src = _host(tensor.contiguous())
    parts = list(src.chunk(k))
    out = torch.empty_like(parts[0])
    _count("reduce_scatter", _nbytes(out))
    dist.reduce_scatter(out, parts, group=group)
    return out.to(tensor.device)


def ppermute(tensor: torch.Tensor, shift: int, group=None) -> torch.Tensor:
    """A ring shift over the ranks of ``group``: this rank's ``tensor``
    goes to rank ``(me + shift) % k`` and the result is what rank ``(me -
    shift) % k`` sent, of the same shape (every rank sends one). The send
    and the receive sit in one ``dist.batch_isend_irecv``; every rank must
    call with the same shift. ``shift`` must not be a multiple of k."""
    k = dist.get_world_size(group)
    me = dist.get_rank(group)
    if shift % k == 0:
        raise ValueError(f"ppermute by {shift} over {k} ranks sends to self")
    _count("collective-permute", _nbytes(tensor))
    src = _host(tensor.contiguous())
    out = torch.empty_like(src)
    to, frm = (me + shift) % k, (me - shift) % k
    if group is not None:
        to = dist.get_global_rank(group, to)
        frm = dist.get_global_rank(group, frm)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, to, group),
            dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out.to(tensor.device)


def all_gather_object(obj) -> List:
    """Every rank's ``obj``, in rank order."""
    _count("all_gather_object", len(pickle.dumps(obj)))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# Closed forms (bytes per rank per step)
# ---------------------------------------------------------------------------

def exact_exchange_bytes(m: int, k: int, d: int, itemsize: int = 4,
                         cap: Optional[int] = None,
                         payload: bool = False) -> Dict[str, int]:
    """``sharded_row_fetch`` / ``StripedTopoCache.sample_hot`` (the exact
    route-by-owner exchange): a (k, cap) int32 id all-to-all (twice the
    ids when the draw-grid index rides along) and a (k, cap, d) response
    all-to-all."""
    from legion_tpu_torch.parallel.feature_exchange import owner_cap
    cap = cap if cap is not None else owner_cap(m, k)
    ids = k * cap * 4 * (2 if payload else 1)
    return {"all_to_all": ids + k * cap * d * itemsize}


def psum_exchange_bytes(m: int, k: int, d: int,
                        itemsize: int = 4) -> Dict[str, int]:
    """``sharded_row_fetch_psum``: the all-gather of every rank's (m,)
    ids and the reduce-scatter of the (k*m, d) one-hot response, as the
    wrappers count them (the reduce-scatter's share (m, d); its whole
    input crosses the links, see ``link_bytes``)."""
    return {"all_gather": k * m * 4, "reduce_scatter": m * d * itemsize}


def halo_exact_fetch_bytes(dist_caps, d: int,
                           itemsize: int = 4) -> Dict[str, int]:
    """``partitioned_row_fetch_exact``: per ring distance r one forward
    ppermute of (C_r,) int32 request ids and one backward ppermute of
    (C_r, d) rows; self-requests enter no collective."""
    s = int(sum(dist_caps))
    return {"collective-permute": s * 4 + s * d * itemsize}


def halo_exact_hop_bytes(dist_caps, fanout: int) -> Dict[str, int]:
    """``partitioned_sample_hop_exact``: per distance one forward
    ppermute of (C_r, 2) int32 (id and draw-grid row) and one backward
    ppermute of (C_r, fanout) int32 draws."""
    s = int(sum(dist_caps))
    return {"collective-permute": s * 8 + s * fanout * 4}


def link_bytes(out_bytes: Dict[str, int], k: int) -> int:
    """Approximate per-rank link traffic of ``read_counts()``-style bytes
    on a ring of k ranks (the reference's factors): an all-gather's output
    crossed ~(k-1)/k, a reduce-scatter's input (k x its share) crosses,
    an all-to-all moves (k-1)/k of itself, an all-reduce ~2 (k-1)/k of
    its input, a collective-permute once; anything else counts once."""
    f = {"all_gather": (k - 1) / k, "reduce_scatter": k - 1,
         "all_to_all": (k - 1) / k, "all_reduce": 2 * (k - 1) / k,
         "collective-permute": 1.0}
    return int(sum(v * f.get(op, 1.0) for op, v in out_bytes.items()))


def grad_allreduce_bytes(param_count: int, itemsize: int = 4) -> int:
    """The DP gradient all-reduce (DDP's): 2 x param bytes on a ring."""
    return 2 * param_count * itemsize


def param_bytes(module: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())
