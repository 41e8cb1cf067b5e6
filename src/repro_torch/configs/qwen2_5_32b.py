"""qwen2.5-32b [hf:Qwen/Qwen2.5-0.5B; hf]

Counterpart of ``repro.configs.qwen2_5_32b``: 64L d_model=5120 40H
(GQA kv=8) head_dim=128 d_ff=27648 vocab=152064, QKV bias, rope theta
1e6, ~32.8B params, untied.  Pure full attention -> long_500k skipped.
"""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1e6,
    attn_chunk=1024,
)

SMOKE = LMConfig(
    name="qwen-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=128, qkv_bias=True,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

SHAPES = base.lm_shapes(long_ok=False)

base.register(base.ArchEntry(
    arch_id="qwen2.5-32b", family="lm", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="GQA + QKV bias; long_500k skipped"))
