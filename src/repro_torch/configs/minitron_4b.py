"""minitron-4b [arXiv:2407.14679; hf] — pruned nemotron.

Counterpart of ``repro.configs.minitron_4b``: 32L d_model=3072 24H
(GQA kv=8) head_dim=128 d_ff=9216 vocab=256000, ~4.3B params, tied
embeddings, bf16.  Full attention -> long_500k skipped.
"""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="minitron-4b",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000, tie_embeddings=True, attn_chunk=1024,
)

SMOKE = LMConfig(
    name="minitron-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, tie_embeddings=True,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat=False,
)

SHAPES = base.lm_shapes(long_ok=False)

base.register(base.ArchEntry(
    arch_id="minitron-4b", family="lm", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="pruned nemotron; long_500k skipped"))
