"""The port must not load JAX: importing legion_tpu_torch and its sampling,
ops, models (GAT and its plain reference too), cache, data, train (its
command line included), parallel, utils and tools modules and its
benchmark in a fresh interpreter leaves
jax, flax, optax and orbax out of sys.modules, and bench.py and the root
tools/ too."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import legion_tpu_torch
import legion_tpu_torch.cache.cost_model
import legion_tpu_torch.cache.feature_cache
import legion_tpu_torch.cache.hotness
import legion_tpu_torch.cache.hybrid
import legion_tpu_torch.cache.topo_cache
import legion_tpu_torch.runtime
import legion_tpu_torch.train.hybrid_driver
import legion_tpu_torch.tools.hybrid_cell
import legion_tpu_torch.cache.pipeline
import legion_tpu_torch.data.format
import legion_tpu_torch.models
import legion_tpu_torch.ops.sample
import legion_tpu_torch.train.cached_driver
import legion_tpu_torch.utils.logging
import legion_tpu_torch.models.convert
import legion_tpu_torch.ops.gather
import legion_tpu_torch.ops.identity_agg
import legion_tpu_torch.ops.segment
import legion_tpu_torch.ops.spmm
import legion_tpu_torch.models.gcn
import legion_tpu_torch.models.gat
import legion_tpu_torch.models.gat_reference
import legion_tpu_torch.ops.gat_attention
import legion_tpu_torch.train.train_state
import legion_tpu_torch.sampling.sampler
import legion_tpu_torch.sampling.seeds
import legion_tpu_torch.train.loop
import legion_tpu_torch.train.graphed
import legion_tpu_torch.config
import legion_tpu_torch.data.synthetic
import legion_tpu_torch.tools.k2_bench
import legion_tpu_torch.tools.k4_bench
import legion_tpu_torch.tools.pa_cell
import legion_tpu_torch.tools.scale
import legion_tpu_torch.tools.smoke_pa_scale
import legion_tpu_torch.tools.smoke_uk_scale
import legion_tpu_torch.tools.profile_cached
import legion_tpu_torch.parallel
import legion_tpu_torch.parallel.dp
import legion_tpu_torch.parallel.mesh
import legion_tpu_torch.parallel.trainer
import legion_tpu_torch.parallel.feature_exchange
import legion_tpu_torch.cache.striped
import legion_tpu_torch.cache.striped_pipeline
import legion_tpu_torch.cache.striped_hybrid
import legion_tpu_torch.tools.cache_group_cell
import legion_tpu_torch.utils.comm
import legion_tpu_torch.utils.trace
import legion_tpu_torch.train.__main__
import legion_tpu_torch.data.partition
import legion_tpu_torch.parallel.halo
import legion_tpu_torch.parallel.multihost
import legion_tpu_torch.parallel.launch
import legion_tpu_torch.train.partitioned_driver
import legion_tpu_torch.tools.partition_cell
import legion_tpu_torch.data.ogb
import legion_tpu_torch.tools.parity_ogb
import legion_tpu_torch.tools.products_cell
import legion_tpu_torch.bench
import legion_tpu_torch.tools.bench_kernels
import legion_tpu_torch.tools.sol_model
loaded = sorted(m for m in ("jax", "flax", "optax", "orbax")
                if m in sys.modules)
print("LOADED", loaded)
print("REFERENCE", sorted(m for m in sys.modules
                          if m.split(".")[0] == "legion_tpu"))
print("ROOT", sorted(m for m in sys.modules
                     if m.split(".")[0] in ("bench", "tools")))
"""


def _probe():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_port_imports_no_jax():
    out = _probe()
    assert "LOADED []" in out, out


def test_port_imports_nothing_of_the_reference_package():
    out = _probe()
    assert "REFERENCE []" in out, out


def test_port_imports_neither_bench_py_nor_the_root_tools():
    """The port's benchmark and its tools are its own: bench.py and the
    root tools/ (whose bench_kernels imports JAX) stay out."""
    out = _probe()
    assert "ROOT []" in out, out


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py runs where JAX is absent: its own imports name the
    standard library, torch and legion_tpu_torch, nothing else."""
    import ast
    with open(os.path.join(_ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    allowed = set(sys.stdlib_module_names) | {"torch", "legion_tpu_torch"}
    assert names <= allowed, sorted(names - allowed)
    assert "legion_tpu_torch" in names
