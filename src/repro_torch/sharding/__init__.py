"""Sharding of the port: the axis rules of serving, pruning and the
LM, GNN and recsys cells (``specs.py``), the bucket placement plan of the
grid tier (``placement.py``) and the placed LM train step (``placed.py``:
tensors cut over a mesh's positions by their specs, and a train cell's
step run over them from one controller); the meshes are
``repro_torch.launch.mesh``'s."""

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
           "recsys_rules_rowsharded", "serve_rules", "spec_for",
           "Placed", "gather", "gather_state", "place", "place_state",
           "placed_specs", "placed_step"]

_PLACED = frozenset(["Placed", "gather", "gather_state", "place",
                     "place_state", "placed_specs", "placed_step"])


def __getattr__(name):
    # placed.py imports the train step and the models, which import
    # specs.py: it loads on first use, not with this package
    if name in _PLACED:
        from repro_torch.sharding import placed
        return getattr(placed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
