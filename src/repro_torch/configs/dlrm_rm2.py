"""dlrm-rm2 [arXiv:1906.00091; paper]

Counterpart of ``repro.configs.dlrm_rm2``: n_dense=13 n_sparse=26
embed_dim=64 bot_mlp=13-512-256-64 top_mlp=512-512-256-1
interaction=dot, fp32.  Tables: 26 x 1,048,576 x 64 (6.98 GB),
1,745,592,641 parameters.
"""

from repro_torch.configs import base
from repro_torch.models.recsys import DLRMConfig

CONFIG = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                    table_rows=1_048_576, bot_mlp=(13, 512, 256, 64),
                    top_mlp_hidden=(512, 512, 256, 1), interaction="dot")

SMOKE = DLRMConfig(name="dlrm-smoke", n_dense=13, n_sparse=26, embed_dim=16,
                   table_rows=100, bot_mlp=(13, 32, 16),
                   top_mlp_hidden=(32, 1))

RECSYS_SHAPES = {
    "train_batch": base.ShapeSpec("train_batch", "train", {"batch": 65_536}),
    "serve_p99": base.ShapeSpec("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": base.ShapeSpec("serve_bulk", "serve", {"batch": 262_144}),
    "retrieval_cand": base.ShapeSpec(
        "retrieval_cand", "retrieval",
        {"batch": 1, "n_candidates": 1_000_000}),
}

SHAPES = dict(RECSYS_SHAPES)

base.register(base.ArchEntry(
    arch_id="dlrm-rm2", family="recsys", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES,
    notes="retrieval_cand scores the user tower against the item table "
          "with one sharded matmul (two-tower head)"))
