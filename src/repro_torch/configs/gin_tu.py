"""gin-tu [arXiv:1810.00826; paper]

Counterpart of ``repro.configs.gin_tu``.  GIN: n_layers=5 d_hidden=64
aggregator=sum eps=learnable.  Shapes: full_graph_sm (Cora-like),
minibatch_lg (Reddit-like, fanout 15-10), ogb_products (full-batch 2.4M
nodes / 61.9M edges), molecule (batched small graphs).
"""

from repro_torch.configs import base
from repro_torch.models.gnn import GINConfig

CONFIG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_feat=1433,
                   n_classes=16)

SMOKE = GINConfig(name="gin-smoke", n_layers=3, d_hidden=16, d_feat=8,
                  n_classes=4)

SHAPES = {
    "full_graph_sm": base.ShapeSpec(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    "minibatch_lg": base.ShapeSpec(
        "minibatch_lg", "train",
        {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
         "fanout": (15, 10), "d_feat": 602,
         # padded sampled-block sizes (static shapes):
         "max_nodes": 169_984, "max_edges": 168_960}),
    "ogb_products": base.ShapeSpec(
        "ogb_products", "train",
        {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    "molecule": base.ShapeSpec(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128}),
}

base.register(base.ArchEntry(
    arch_id="gin-tu", family="gnn", config=CONFIG, smoke=SMOKE,
    shapes=SHAPES,
    notes="message passing via segment_gather_sum (a fixed-order "
          "segment sum); minibatch_lg uses the real fanout "
          "NeighborSampler (data/graph_sampler.py)"))
