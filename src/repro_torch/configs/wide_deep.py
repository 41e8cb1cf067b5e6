"""wide-deep [arXiv:1606.07792; paper]

Counterpart of ``repro.configs.wide_deep``: n_sparse=40 embed_dim=32
mlp=1024-512-256 interaction=concat, fp32.  Tables: 40 x 1,048,576 x 32
(5.37 GB) plus a 40 x 1,048,576 wide scalar table (0.17 GB).
"""

from repro_torch.configs import base
from repro_torch.configs.dlrm_rm2 import RECSYS_SHAPES
from repro_torch.models.recsys import WideDeepConfig

CONFIG = WideDeepConfig(name="wide-deep", n_sparse=40, embed_dim=32,
                        table_rows=1_048_576, mlp=(1024, 512, 256))

SMOKE = WideDeepConfig(name="wide-deep-smoke", n_sparse=40, embed_dim=8,
                       table_rows=100, mlp=(32, 16))

SHAPES = dict(RECSYS_SHAPES)

base.register(base.ArchEntry(
    arch_id="wide-deep", family="recsys", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES, notes="wide scalar table + deep concat MLP"))
