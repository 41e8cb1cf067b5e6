"""bert4rec [arXiv:1904.06690; paper]

Counterpart of ``repro.configs.bert4rec``: embed_dim=64 n_blocks=2
n_heads=2 seq_len=200 d_ff=256, bidirectional, fp32.  Catalog: 1M items
(1,000,002 embedding rows with [MASK] and pad; matches retrieval_cand's
n_candidates).  Training uses sampled softmax (1,024 negatives, 30
masked positions) — a full (B, S, 1M) logit tensor is not a real
system's training path.

BERT4Rec is the recsys arch the paper's pruning applies to: its
sequence-token embeddings are a late-interaction index over user
histories.
"""

from repro_torch.configs import base
from repro_torch.models.recsys import Bert4RecConfig

CONFIG = Bert4RecConfig(name="bert4rec", n_items=1_000_000, embed_dim=64,
                        n_blocks=2, n_heads=2, seq_len=200, d_ff=256)

SMOKE = Bert4RecConfig(name="bert4rec-smoke", n_items=200, embed_dim=16,
                       n_blocks=2, n_heads=2, seq_len=24, d_ff=32)

SHAPES = {
    "train_batch": base.ShapeSpec(
        "train_batch", "train",
        {"batch": 65_536, "seq_len": 200, "n_negatives": 1024,
         "n_masked": 30}),
    "serve_p99": base.ShapeSpec(
        "serve_p99", "serve",
        {"batch": 512, "seq_len": 200, "full_catalog": True}),
    "serve_bulk": base.ShapeSpec(
        "serve_bulk", "serve",
        {"batch": 262_144, "seq_len": 200, "full_catalog": False}),
    "retrieval_cand": base.ShapeSpec(
        "retrieval_cand", "retrieval",
        {"batch": 1, "seq_len": 200, "n_candidates": 1_000_000}),
}

base.register(base.ArchEntry(
    arch_id="bert4rec", family="recsys", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES,
    notes="encoder-only: serve_* are encoder inference (no decode); "
          "serve_p99 ranks the full 1M catalog, serve_bulk scores given "
          "(user, item) pairs offline"))
