"""Sharding of the port: the serving and pruning axis rules
(``specs.py``) and the bucket placement plan of the grid tier
(``placement.py``); the meshes are ``repro_torch.launch.mesh``'s."""

from repro_torch.sharding.placement import (PLACEMENT_FORMAT, PlacementPlan,
                                            bucket_weights)
from repro_torch.sharding.specs import (axis_rules, constrain, current_rules,
                                        data_mesh_for, grid_axes_for,
                                        logical_to_spec, mesh_axes_for,
                                        serve_rules, spec_for)

__all__ = ["PLACEMENT_FORMAT", "PlacementPlan", "axis_rules",
           "bucket_weights", "constrain", "current_rules", "data_mesh_for",
           "grid_axes_for", "logical_to_spec", "mesh_axes_for",
           "serve_rules", "spec_for"]
