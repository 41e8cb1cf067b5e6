"""dcn-v2 [arXiv:2008.13535; paper]

Counterpart of ``repro.configs.dcn_v2``: n_dense=13 n_sparse=26
embed_dim=16 n_cross_layers=3 mlp=1024-1024-512 interaction=cross, fp32.
Tables: 26 x 1,048,576 x 16 (1.74 GB).
"""

from repro_torch.configs import base
from repro_torch.configs.dlrm_rm2 import RECSYS_SHAPES
from repro_torch.models.recsys import DCNConfig

CONFIG = DCNConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                   table_rows=1_048_576, n_cross_layers=3,
                   mlp=(1024, 1024, 512))

SMOKE = DCNConfig(name="dcn-smoke", n_dense=13, n_sparse=26, embed_dim=8,
                  table_rows=100, n_cross_layers=2, mlp=(32, 16))

SHAPES = dict(RECSYS_SHAPES)

base.register(base.ArchEntry(
    arch_id="dcn-v2", family="recsys", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="full-rank DCN-v2 cross layers"))
