"""The port must not load JAX: importing legion_tpu_torch and its sampling,
ops, models, cache, data, train and tools modules in a fresh interpreter leaves
jax, flax, optax and orbax out of sys.modules."""

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
import legion_tpu_torch.train.train_state
import legion_tpu_torch.sampling.sampler
import legion_tpu_torch.sampling.seeds
import legion_tpu_torch.train.loop
import legion_tpu_torch.config
import legion_tpu_torch.data.synthetic
import legion_tpu_torch.tools.ab_trainer
import legion_tpu_torch.tools.k2_bench
import legion_tpu_torch.tools.pa_cell
import legion_tpu_torch.tools.profile_cached
loaded = sorted(m for m in ("jax", "flax", "optax", "orbax")
                if m in sys.modules)
print("LOADED", loaded)
print("REFERENCE", sorted(m for m in sys.modules
                          if m.split(".")[0] == "legion_tpu"))
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
