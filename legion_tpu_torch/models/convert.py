"""Weights from a ``legion_tpu`` (flax) SAGE into the port's ``SAGE``.

flax keeps ``layer_i/{fc_self,fc_neigh}/{kernel,bias}`` with kernels of
shape (in, out); ``nn.Linear`` keeps weights of shape (out, in). The
input is any nested mapping of array-likes (numpy arrays, or JAX arrays,
which ``np.asarray`` reads without this module importing JAX).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_flax(params_np: Mapping) -> Dict[str, torch.Tensor]:
    """flax SAGE params -> a state_dict for ``legion_tpu_torch`` SAGE."""
    state = {}
    for name, layer in params_np.items():
        if not name.startswith("layer_"):
            raise ValueError(f"unexpected flax param group {name!r}")
        i = int(name[len("layer_"):])
        for fc in ("fc_self", "fc_neigh"):
            kernel = np.asarray(layer[fc]["kernel"], np.float32)
            state[f"layers.{i}.{fc}.weight"] = torch.from_numpy(
                np.ascontiguousarray(kernel.T))
        state[f"layers.{i}.fc_self.bias"] = torch.from_numpy(
            np.asarray(layer["fc_self"]["bias"], np.float32).copy())
    return state
