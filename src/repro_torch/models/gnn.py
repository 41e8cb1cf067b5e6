"""GIN (Graph Isomorphism Network) [arXiv:1810.00826].

Counterpart of ``repro.models.gnn``: ``GINConfig``, the model drawn by
:func:`init_params`, :func:`gin_layer` and :func:`forward`, in fp32
(TF32 off, ``core.backend``).  Three regimes, as the reference's:

  * full graph: one (n_nodes, d_feat) feature matrix and a (2, n_edges)
    edge index [src; dst];
  * sampled minibatch: the fanout ``data.graph_sampler.NeighborSampler``
    gives fixed-size padded blocks with an edge mask;
  * batched small graphs (molecules): a disjoint union with a graph-id
    vector; the readout sums each graph's nodes.

Message passing is ``core.segment.segment_gather_sum``, where the
reference gathers ``x[src]`` and calls ``jax.ops.segment_sum``: the same
sums without the (E, d) message tensor, in a fixed order (no atomics),
over a ``GatherPlan`` of the edge index and mask.  :func:`forward`
builds the plan unless the caller passes one (a full-batch trainer
builds it once for its fixed graph).  The readout is the same sum with
one edge a node, node -> its graph.

Parameters keep the reference's names and (in, out) layout: layer i is
``layers.{i}.{w1, b1, w2, b2, eps}`` (layer 0's ``w1`` is (d_feat,
d_hidden)), the head ``head.{w, b}``.  ``eps`` is a trained scalar in
every layer whatever ``learnable_eps`` says, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import backend as _backend  # noqa: F401  (TF32 off)
from repro_torch.core.segment import gather_plan, segment_gather_sum
from repro_torch.models.common import dense_init
from repro_torch.sharding.specs import constrain

__all__ = ["GIN", "GINConfig", "forward", "gin_layer", "init_params"]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 16
    learnable_eps: bool = True
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def param_count(self) -> int:
        d_in, d = self.d_feat, self.d_hidden
        total = 0
        for i in range(self.n_layers):
            fin = d_in if i == 0 else d
            total += fin * d + d + d * d + d + 1  # MLP(2 layer) + eps
        total += d * self.n_classes + self.n_classes
        return total


class GINLayer(nn.Module):
    def __init__(self, fin: int, d: int, dtype):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros((fin, d), dtype=dtype))
        self.b1 = nn.Parameter(torch.zeros((d,), dtype=dtype))
        self.w2 = nn.Parameter(torch.zeros((d, d), dtype=dtype))
        self.b2 = nn.Parameter(torch.zeros((d,), dtype=dtype))
        self.eps = nn.Parameter(torch.zeros((), dtype=dtype))


class Head(nn.Module):
    def __init__(self, d: int, n_classes: int, dtype):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d, n_classes), dtype=dtype))
        self.b = nn.Parameter(torch.zeros((n_classes,), dtype=dtype))


class GIN(nn.Module):
    def __init__(self, cfg: GINConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            GINLayer(cfg.d_feat if i == 0 else cfg.d_hidden, cfg.d_hidden,
                     cfg.param_dtype) for i in range(cfg.n_layers))
        self.head = Head(cfg.d_hidden, cfg.n_classes, cfg.param_dtype)

    def forward(self, x, edge_index, *, edge_mask=None, graph_ids=None,
                n_graphs: int | None = None, plan=None):
        return forward(self, x, edge_index, edge_mask=edge_mask,
                       graph_ids=graph_ids, n_graphs=n_graphs, plan=plan)


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GINConfig,
                device=None) -> GIN:
    """A GIN drawn from ``generator`` on its device: per layer ``w1``
    then ``w2`` N(0, 1/in), then the head's ``w``; zero biases and eps."""
    device = torch.device(device or generator.device)
    model = GIN(cfg).to(device)
    for layer in model.layers:
        for w in (layer.w1, layer.w2):
            w.copy_(dense_init(generator, *w.shape, cfg.param_dtype))
    model.head.w.copy_(dense_init(generator, *model.head.w.shape,
                                  cfg.param_dtype))
    return model


def _msg(m):
    return constrain(m, "edges", "feat")


def gin_layer(layer: GINLayer, x, plan):
    """x' = MLP((1 + eps) * x + sum_{j in N(i)} x_j) over ``plan``'s
    kept edges."""
    agg = segment_gather_sum(x, plan, msg_hook=_msg)
    h = (1.0 + layer.eps) * x + agg
    h = F.relu(h @ layer.w1 + layer.b1)
    h = h @ layer.w2 + layer.b2
    return F.relu(h)


def forward(model: GIN, x, edge_index, *, edge_mask=None, graph_ids=None,
            n_graphs: int | None = None, plan=None):
    """Node logits (node classification) or graph logits (with
    ``graph_ids`` (n_nodes,) in [0, n_graphs)).  x (n_nodes, d_feat);
    edge_index (2, n_edges) integers [src; dst]; ``plan``:
    ``gather_plan(src, dst, n_nodes, edge_mask)``, built here if None
    (then ``edge_index`` and ``edge_mask`` define it, else they are
    unused)."""
    cfg = model.cfg
    n_nodes = x.shape[0]
    if plan is None:
        plan = gather_plan(edge_index[0], edge_index[1], n_nodes, edge_mask)
    h = x.to(cfg.compute_dtype)
    for layer in model.layers:
        h = gin_layer(layer, h, plan)
        h = constrain(h, "nodes", "hidden")
    if graph_ids is not None:
        # sum-readout per graph (molecule regime)
        nodes = torch.arange(n_nodes, device=h.device)
        h = segment_gather_sum(h, gather_plan(nodes, graph_ids, n_graphs,
                                              n_in=n_nodes))
    return h @ model.head.w + model.head.b
