"""Weights from a ``legion_tpu`` (flax) SAGE or GCN into the port's
modules.

flax keeps ``layer_i/{fc_self,fc_neigh}/{kernel,bias}`` (SAGE) or
``layer_i/{dense/kernel,bias}`` (GCN) with kernels of shape (in, out);
``nn.Linear`` keeps weights of shape (out, in). The input is any nested
mapping of array-likes (numpy arrays, or JAX arrays, which ``np.asarray``
reads without this module importing JAX).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _weight(kernel) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(kernel, np.float32).T))


def _vector(v) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float32).copy())


def params_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """flax SAGE or GCN params -> a state_dict for the port's ``SAGE``
    (also the LP-SAGE encoder) or ``GCN``, by the groups each layer
    holds."""
    state = {}
    for name, layer in params_np.items():
        if not name.startswith("layer_"):
            raise ValueError(f"unexpected flax param group {name!r}")
        i = int(name[len("layer_"):])
        groups = set(layer)
        if groups == {"fc_self", "fc_neigh"}:
            for fc in ("fc_self", "fc_neigh"):
                state[f"layers.{i}.{fc}.weight"] = _weight(layer[fc]["kernel"])
            state[f"layers.{i}.fc_self.bias"] = _vector(
                layer["fc_self"]["bias"])
        elif groups == {"dense", "bias"}:
            state[f"layers.{i}.dense.weight"] = _weight(
                layer["dense"]["kernel"])
            state[f"layers.{i}.bias"] = _vector(layer["bias"])
        else:
            raise ValueError(f"unexpected flax param groups {sorted(groups)} "
                             f"in {name!r}")
    return state
