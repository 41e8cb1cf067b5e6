"""mixtral-8x7b [arXiv:2401.04088; hf]

Counterpart of ``repro.configs.mixtral_8x7b``: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts top-2, sliding-window
attention (W=4096).  ~46.7B total / ~12.9B active.  SWA ring-buffer KV
cache makes `long_500k` a bounded-memory decode.
"""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, moe_experts=8, moe_top_k=2,
    window=4096, rope_theta=1e6, attn_chunk=1024,
)

SMOKE = LMConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128, moe_experts=4, moe_top_k=2, window=8,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

SHAPES = base.lm_shapes(long_ok=True)

base.register(base.ArchEntry(
    arch_id="mixtral-8x7b", family="lm", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="SWA window 4096 -> sub-quadratic long_500k"))
