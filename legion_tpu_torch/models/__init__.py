from typing import Dict, Optional

import torch

from legion_tpu_torch.config import ModelConfig
from legion_tpu_torch.models.gat import GAT  # noqa: F401
from legion_tpu_torch.models.gcn import GCN  # noqa: F401
from legion_tpu_torch.models.sage import SAGE  # noqa: F401

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_args(model: ModelConfig, in_dim: int, num_classes: int,
               seed: int) -> Dict:
    """``build_model``'s keyword arguments for the configuration ``model``
    at input width ``in_dim`` and ``num_classes`` classes, its initial
    weights drawn from a CPU generator seeded ``seed``: the one mapping
    from the config to the model."""
    return dict(arch=model.arch, in_dim=in_dim, hidden_dim=model.hidden_dim,
                num_classes=num_classes, num_layers=model.num_layers,
                dropout=model.dropout, dtype=model.dtype,
                num_heads=model.num_heads,
                generator=torch.Generator().manual_seed(seed))


def build_model(arch: str, in_dim: int, hidden_dim: int, num_classes: int,
                num_layers: int, dropout: float, dtype=None,
                generator: Optional[torch.Generator] = None,
                num_heads: int = 1) -> torch.nn.Module:
    """Model factory keyed by the config's arch string (port of
    ``legion_tpu.models.build_model``). Unlike flax, a torch module needs
    its input width up front: ``in_dim`` is the (padded) feature width.

    dtype: compute dtype ("float32" | "bfloat16" or a torch dtype);
    params stay float32. generator: source of the initial weights.
    num_heads: GAT's attention heads (``hidden_dim`` is a head's width);
    the other archs have none and take only 1.
    """
    if isinstance(dtype, str):
        dtype = _DTYPES[dtype]
    dtype = dtype or torch.float32
    if arch != "gat" and num_heads != 1:
        raise ValueError(f"arch {arch!r} has no attention heads; "
                         f"num_heads={num_heads}")
    if arch == "gat":
        return GAT(in_dim, hidden_dim, num_classes, num_layers, num_heads,
                   dropout, dtype=dtype, generator=generator)
    if arch == "sage":
        return SAGE(in_dim, hidden_dim, num_classes, num_layers, dropout,
                    dtype=dtype, generator=generator)
    if arch == "gcn":
        return GCN(in_dim, hidden_dim, num_classes, num_layers, dropout,
                   dtype=dtype, generator=generator)
    if arch == "lp_sage":
        # link prediction: a SAGE encoder whose output is the embedding
        return SAGE(in_dim, hidden_dim, hidden_dim, num_layers, dropout,
                    dtype=dtype, generator=generator)
    raise ValueError(f"unknown arch {arch!r}")
