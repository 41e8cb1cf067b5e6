"""Graph data: synthetic graph generation and a fanout neighbor sampler.

Counterpart of ``repro.data.graph_sampler``, in numpy on the host: from
the same seed every array equals the reference's element for element
(the same generator calls in the same order).  `NeighborSampler`
implements GraphSAGE-style layered fanout sampling (15-10 for the
`minibatch_lg` shape) over a CSR adjacency of incoming edges built once;
sampled blocks are padded to static shapes.  A block's node ids are
remapped by a binary search over its sorted node set, where the
reference looks each id up in a dict (the same ids, faster).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Graph", "NeighborSampler", "synthetic_graph"]


@dataclasses.dataclass
class Graph:
    edge_index: np.ndarray     # (2, E) int32 [src; dst]
    x: np.ndarray              # (N, F) float32
    labels: np.ndarray         # (N,) int32
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return self.edge_index.shape[1]


def synthetic_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                    n_classes: int = 16, *, community: bool = True) -> Graph:
    """Degree-skewed random graph with community-correlated features so a
    GNN can learn (labels = community).  ``community`` is unused, as in
    the reference."""
    rng = np.random.default_rng(seed)
    n_comm = n_classes
    comm = rng.integers(0, n_comm, size=n_nodes)
    # preferential-attachment-ish degree skew
    deg_w = rng.zipf(1.5, size=n_nodes).astype(np.float64)
    deg_w /= deg_w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=deg_w).astype(np.int32)
    # 70% of edges stay within a community
    intra = rng.random(n_edges) < 0.7
    dst = np.where(
        intra,
        _sample_same_comm(rng, comm, src, n_comm),
        rng.integers(0, n_nodes, size=n_edges),
    ).astype(np.int32)
    centers = rng.normal(size=(n_comm, d_feat)).astype(np.float32)
    x = centers[comm] + 0.5 * rng.normal(size=(n_nodes, d_feat)).astype(
        np.float32)
    return Graph(edge_index=np.stack([src, dst]), x=x,
                 labels=comm.astype(np.int32), n_nodes=n_nodes)


def _sample_same_comm(rng, comm, src, n_comm):
    # bucket nodes per community once, then sample within src's bucket
    buckets = [np.where(comm == c)[0] for c in range(n_comm)]
    out = np.empty_like(src)
    src_comm = comm[src]
    for c in range(n_comm):
        mask = src_comm == c
        if mask.any():
            out[mask] = rng.choice(buckets[c], size=int(mask.sum()))
    return out


class NeighborSampler:
    """Layered fanout sampling over CSR adjacency (incoming edges)."""

    def __init__(self, graph: Graph, fanouts: tuple[int, ...], seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)
        order = np.argsort(graph.edge_index[1], kind="stable")
        self._src_sorted = graph.edge_index[0][order]
        dst_sorted = graph.edge_index[1][order]
        self._indptr = np.searchsorted(dst_sorted, np.arange(graph.n_nodes + 1))

    def _neighbors(self, node: int, k: int) -> np.ndarray:
        lo, hi = self._indptr[node], self._indptr[node + 1]
        if hi == lo:
            return np.empty((0,), np.int32)
        idx = self.rng.integers(lo, hi, size=min(k, hi - lo))
        return self._src_sorted[idx]

    def sample_block(self, batch_nodes: np.ndarray) -> dict:
        """Returns a subgraph block: node set, remapped edge index, node
        features and labels, seed-node positions."""
        layers = [np.asarray(batch_nodes, np.int32)]
        edges_src, edges_dst = [], []
        frontier = layers[0]
        for k in self.fanouts:
            nxt = []
            for v in frontier:
                nb = self._neighbors(int(v), k)
                nxt.append(nb)
                edges_src.append(nb)
                edges_dst.append(np.full(len(nb), v, np.int32))
            frontier = np.concatenate(nxt) if nxt else np.empty((0,), np.int32)
            layers.append(frontier)
        all_nodes = np.unique(np.concatenate(layers))
        src = np.concatenate(edges_src) if edges_src else np.empty((0,), np.int32)
        dst = np.concatenate(edges_dst) if edges_dst else np.empty((0,), np.int32)

        def remap(ids):
            return np.searchsorted(all_nodes, ids).astype(np.int32)
        sub_src = remap(src) if len(src) else src
        sub_dst = remap(dst) if len(dst) else dst
        seeds = remap(np.asarray(batch_nodes))
        return {
            "nodes": all_nodes.astype(np.int32),
            "x": self.g.x[all_nodes],
            "edge_index": np.stack([sub_src, sub_dst]),
            "labels": self.g.labels[all_nodes],
            "seeds": seeds,
        }

    def padded_batch(self, batch_nodes: np.ndarray, max_nodes: int,
                     max_edges: int) -> dict:
        """Static-shape version: pads/truncates nodes & edges."""
        blk = self.sample_block(batch_nodes)
        n = min(len(blk["nodes"]), max_nodes)
        e = min(blk["edge_index"].shape[1], max_edges)
        x = np.zeros((max_nodes, self.g.x.shape[1]), np.float32)
        x[:n] = blk["x"][:n]
        labels = np.zeros((max_nodes,), np.int32)
        labels[:n] = blk["labels"][:n]
        ei = np.zeros((2, max_edges), np.int32)
        keep = (blk["edge_index"][0][:e] < max_nodes) & \
               (blk["edge_index"][1][:e] < max_nodes)
        ei[:, :e] = blk["edge_index"][:, :e] * keep
        edge_mask = np.zeros((max_edges,), bool)
        edge_mask[:e] = keep
        label_mask = np.zeros((max_nodes,), np.float32)
        seeds = blk["seeds"][blk["seeds"] < max_nodes]
        label_mask[seeds] = 1.0
        return {"x": x, "edge_index": ei, "edge_mask": edge_mask,
                "labels": labels, "label_mask": label_mask}
