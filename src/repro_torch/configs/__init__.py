"""Config registry — importing this package registers every ported
architecture (counterpart of ``repro.configs``): the ColBERT encoder,
the dense LM family (minitron-4b, stablelm-3b, qwen2.5-32b) and the
recsys CTR family (dlrm-rm2, dcn-v2, wide-deep).  Not ported yet:
bert4rec, the MoE family (mixtral-8x7b, granite-moe-3b-a800m) and the
GNN family (gin-tu)."""

from repro_torch.configs import base
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    colbert_base,
    dcn_v2,
    dlrm_rm2,
    minitron_4b,
    qwen2_5_32b,
    stablelm_3b,
    wide_deep,
)
from repro_torch.configs.base import ArchEntry, ShapeSpec, all_archs, get

__all__ = ["ArchEntry", "ShapeSpec", "all_archs", "get", "base"]
