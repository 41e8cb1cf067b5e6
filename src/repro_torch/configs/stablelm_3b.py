"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified]

Counterpart of ``repro.configs.stablelm_3b``: 32L d_model=2560 32H
(GQA kv=32 = MHA) head_dim=80 d_ff=6912 vocab=50304, ~2.8B params,
untied embeddings.  Pure full attention -> long_500k skipped.
"""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="stablelm-3b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304, attn_chunk=1024,
)

SMOKE = LMConfig(
    name="stablelm-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=128,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

SHAPES = base.lm_shapes(long_ok=False)

base.register(base.ArchEntry(
    arch_id="stablelm-3b", family="lm", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="full attention; long_500k skipped"))
