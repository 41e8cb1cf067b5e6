"""Sharding of the port: the axis rules of serving, pruning and the
LM, GNN and recsys cells (``specs.py``) and the bucket placement plan of the grid tier
(``placement.py``); the meshes are ``repro_torch.launch.mesh``'s."""

from repro_torch.sharding.placement import (PLACEMENT_FORMAT, PlacementPlan,
                                            bucket_weights)
from repro_torch.sharding.specs import (axis_rules, constrain, counting,
                                        current_rules,
                                        data_mesh_for, gnn_rules,
                                        grid_axes_for, lm_decode_rules,
                                        lm_prefill_rules, lm_rules_ep_moe,
                                        lm_train_rules, logical_to_spec,
                                        mesh_axes_for, note_attention,
                                        note_lookup, note_topk,
                                        recsys_rules,
                                        recsys_rules_rowsharded, serve_rules,
                                        spec_for)

__all__ = ["PLACEMENT_FORMAT", "PlacementPlan", "axis_rules",
           "bucket_weights", "constrain", "counting", "current_rules",
           "data_mesh_for",
           "gnn_rules", "grid_axes_for", "lm_decode_rules",
           "lm_prefill_rules", "lm_rules_ep_moe", "lm_train_rules",
           "logical_to_spec", "mesh_axes_for", "note_attention", "note_lookup",
           "note_topk", "recsys_rules",
           "recsys_rules_rowsharded", "serve_rules", "spec_for"]
