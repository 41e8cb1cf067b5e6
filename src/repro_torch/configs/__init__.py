"""Config registry — importing this package registers every ported
architecture (counterpart of ``repro.configs``): the ColBERT encoder,
the LM family — dense (minitron-4b, stablelm-3b, qwen2.5-32b) and MoE
(granite-moe-3b-a800m, mixtral-8x7b) — and the recsys family
(dlrm-rm2, dcn-v2, wide-deep, bert4rec).  Not ported yet: the GNN
family (gin-tu)."""

from repro_torch.configs import base
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    bert4rec,
    colbert_base,
    dcn_v2,
    dlrm_rm2,
    granite_moe_3b_a800m,
    minitron_4b,
    mixtral_8x7b,
    qwen2_5_32b,
    stablelm_3b,
    wide_deep,
)
from repro_torch.configs.base import ArchEntry, ShapeSpec, all_archs, get

__all__ = ["ArchEntry", "ShapeSpec", "all_archs", "get", "base"]
