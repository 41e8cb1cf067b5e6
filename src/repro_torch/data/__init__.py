"""Data: synthetic corpora and batches, the step-indexed pipeline, and
the graph generator and fanout neighbor sampler of the GNN family."""

from repro_torch.data.graph_sampler import Graph, NeighborSampler, synthetic_graph

__all__ = ["Graph", "NeighborSampler", "synthetic_graph"]
