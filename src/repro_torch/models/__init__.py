"""Models of the port; the GNN family's are exported here."""

from repro_torch.models.gnn import GIN, GINConfig

__all__ = ["GIN", "GINConfig"]
