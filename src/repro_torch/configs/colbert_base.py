"""colbert — the paper's own architecture (ColBERTv2-style encoder).

Counterpart of ``repro.configs.colbert_base``: BERT-base backbone
(12 layers, width 768, 12 heads, d_ff 3072) plus the 128-d
late-interaction projection, bf16 params and compute; ``SMOKE`` is the
reference's reduced same-family config for CPU tests.
"""

import torch

from repro_torch.configs import base
from repro_torch.models.colbert import ColBERTConfig

CONFIG = ColBERTConfig(name="colbert", vocab=30_522, n_layers=12,
                       d_model=768, n_heads=12, d_ff=3072, out_dim=128,
                       query_len=32, doc_len=180, norm="sphere",
                       param_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16)

SMOKE = ColBERTConfig(name="colbert-smoke", vocab=512, n_layers=2,
                      d_model=64, n_heads=4, d_ff=128, out_dim=32,
                      query_len=8, doc_len=24, norm="sphere")

SHAPES = {
    "train_contrastive": base.ShapeSpec(
        "train_contrastive", "train",
        {"batch": 2048, "query_len": 32, "doc_len": 180}),
    "encode_corpus": base.ShapeSpec(
        "encode_corpus", "serve", {"batch": 4096, "doc_len": 180}),
    "prune_index": base.ShapeSpec(
        "prune_index", "serve",
        {"docs_per_block": 1024, "doc_len": 180, "n_samples": 10_000,
         "out_dim": 128}),
    "rerank": base.ShapeSpec(
        "rerank", "serve",
        {"n_queries": 128, "n_candidates": 1024, "query_len": 32,
         "doc_len": 180}),
}

base.register(base.ArchEntry(
    arch_id="colbert", family="retrieval", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="the paper's model"))
