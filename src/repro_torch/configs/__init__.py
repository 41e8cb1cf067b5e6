"""Config registry — importing this package registers every ported
architecture (counterpart of ``repro.configs``; the MoE, GNN and recsys
configs are not ported yet)."""

from repro_torch.configs import base
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    colbert_base,
    minitron_4b,
    qwen2_5_32b,
    stablelm_3b,
)
from repro_torch.configs.base import ArchEntry, ShapeSpec, all_archs, get

__all__ = ["ArchEntry", "ShapeSpec", "all_archs", "get", "base"]
