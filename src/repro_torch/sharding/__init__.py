"""Sharding of the port: only the bucket placement plan so far (the
reference's ``sharding/specs.py`` axis rules and ``launch/mesh.py``
meshes come with multi-GPU serving)."""

from repro_torch.sharding.placement import (PLACEMENT_FORMAT, PlacementPlan,
                                            bucket_weights)

__all__ = ["PLACEMENT_FORMAT", "PlacementPlan", "bucket_weights"]
