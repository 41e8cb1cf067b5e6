"""Logical-axis sharding rules, thread-local.

Counterpart of ``repro.sharding.specs``: the serving and pruning rules,
and the LM, GNN and recsys rule sets the cell builders read
(``launch.steps``).  A launcher activates a rule set mapping logical axis names
("candidates", "batch", ...) to mesh axis names; the explicit
multi-device consumers (the sharded streaming top-k and the grid merge
tier of ``serve.retrieval``, the sharded pruning of ``core.voronoi``
and ``core.pruning_pipeline``) read the concrete mesh the rules carry
under ``"__mesh__"`` and the grid placement under ``"__placement__"``.

Rules are thread-local, as in the reference: a worker thread starts
with none, so code that fans work out to threads (the grid exchange,
``serve.loop``'s dispatcher) hands the caller's rules over itself.

:func:`constrain` is the identity: eager PyTorch has no sharding hint
for a compiler to honour, so placement is done by the consumers above,
which copy each shard onto its device.  The models call it at the
reference's constraint points with the same logical axes, so that the
dry run's collective counter (``launch.roofline.Collectives``, active
under :func:`counting`) reads each constrained tensor's spec there;
:func:`note_topk`, :func:`note_attention` and :func:`note_lookup` mark
the top-ks, attentions and catalog lookups it counts.  The LM, GNN and
recsys rule sets (:func:`lm_train_rules` and the six after it) are
plain dicts equal to the reference's; they feed the cells' specs and
the dry run's counts (``launch.steps``, ``launch.roofline``).  An LM
train cell's tensors are placed by its specs, and its step run over its
mesh, by ``sharding.placed``; the GNN and recsys rule sets place
nothing.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["axis_rules", "constrain", "counting", "current_rules",
           "data_mesh_for",
           "gnn_rules", "grid_axes_for", "lm_decode_rules",
           "lm_prefill_rules", "lm_rules_ep_moe", "lm_train_rules",
           "logical_to_spec", "mesh_axes_for", "note_attention",
           "note_lookup", "note_topk", "recsys_rules",
           "recsys_rules_rowsharded", "serve_rules", "spec_for"]

_state = threading.local()


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


@contextmanager
def axis_rules(rules: dict):
    """Activate logical -> mesh axis rules for the enclosed region (this
    thread only)."""
    prev = current_rules()
    _state.rules = dict(rules)
    try:
        yield
    finally:
        _state.rules = prev


def logical_to_spec(logical_axes: tuple, rules: dict | None = None) -> tuple:
    """The mesh axes each logical axis resolves to under ``rules`` (the
    active ones by default): one entry per axis, ``None`` for
    replicated, a name, or a tuple of names.  A mesh axis appears at
    most once; a later logical axis mapping onto a used one replicates."""
    rules = rules if rules is not None else (current_rules() or {})
    resolved, used = [], set()
    for name in logical_axes:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            resolved.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        free = tuple(a for a in axes if a not in used)
        used.update(free)
        resolved.append(free if len(free) > 1 else (free[0] if free else None))
    return tuple(resolved)


def spec_for(*logical_axes) -> tuple:
    return logical_to_spec(tuple(logical_axes))


def constrain(x, *logical_axes, ids=None):
    """The identity: eager PyTorch has no sharding constraint (module
    docstring).  While a counter is active (:func:`counting`) it reads
    ``x``'s spec under the active rules; ``ids``: ``x`` is a lookup table
    about to be read at these ids."""
    counter = getattr(_state, "counter", None)
    if counter is not None:
        counter.constrain(x, logical_axes, ids)
    return x


def note_topk(x, *logical_axes):
    """Mark a top-k over the last axis of ``x``, whose logical axes are
    ``logical_axes``, for the active counter (the identity otherwise)."""
    counter = getattr(_state, "counter", None)
    if counter is not None:
        counter.topk(x, logical_axes)
    return x


def note_attention(q, k, chunk):
    """Mark attention of queries ``q`` (B, S, heads, hd) over keys ``k``
    (B, S, kv_heads, hd) in query chunks of ``chunk`` rows (``None``:
    one chunk) for the active counter (a no-op otherwise)."""
    counter = getattr(_state, "counter", None)
    if counter is not None:
        counter.attention(q, k, chunk)


def note_lookup(table, ids):
    """Mark a read of ``table``'s rows (a catalog parameter) at ``ids``
    for the active counter; returns ``ids``."""
    counter = getattr(_state, "counter", None)
    if counter is not None:
        counter.lookup(table, ids)
    return ids


@contextmanager
def counting(counter):
    """Route this thread's :func:`constrain` and ``note_*`` calls to
    ``counter`` for the enclosed region."""
    prev = getattr(_state, "counter", None)
    _state.counter = counter
    try:
        yield counter
    finally:
        _state.counter = prev


def mesh_axes_for(logical: str, rules: dict | None = None):
    """``(mesh, mesh_axes, n_shards)`` of one logical axis under the
    active rules; ``(None, (), 1)`` when no mesh is carried, the axis
    is replicated, or it spans a single device position."""
    rules = rules if rules is not None else (current_rules() or {})
    mesh = rules.get("__mesh__")
    if mesh is None:
        return None, (), 1
    axes = rules.get(logical)
    if axes is None:
        return None, (), 1
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in getattr(mesh, "axis_names", ()))
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if not axes or n <= 1:
        return None, (), 1
    return mesh, axes, n


# The reference's baseline posture: training batches shard over every
# device, parameters FSDP over `data` on the embed axis and tensor-parallel
# over `model` on the heads / ffn / vocab / expert axes.

_LM_COMMON = {
    "fsdp": ("data",),
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "ffn": ("model",),
    "expert": None,            # TP-MoE baseline; the EP variant flips it
    "vocab": ("model",),
    "kv_len": None,
    "table_axis": None,
    "table_rows": None,
    "candidates": ("model",),
}


def lm_train_rules(multi_pod: bool) -> dict:
    """Single pod: the batch over (data, model).  Two pods: the global
    batch (256) is below 512 devices, so it goes over (pod, data) and
    the sequence over ``model``."""
    r = dict(_LM_COMMON)
    if multi_pod:
        r |= {"batch": ("pod", "data"), "seq": ("model",)}
    else:
        r |= {"batch": ("data", "model"), "seq": None}
    return r


def lm_prefill_rules(multi_pod: bool) -> dict:
    dp = ("pod", "data") if multi_pod else ("data",)
    return dict(_LM_COMMON) | {"batch": dp, "seq": None}


def lm_decode_rules(multi_pod: bool, *, batch: int = 0) -> dict:
    """8 KV heads do not divide the 16-way ``model`` axis, so the KV
    cache shards its length there; at batch 1 (``long_500k``) the
    length goes over every axis."""
    dp = ("pod", "data") if multi_pod else ("data",)
    r = dict(_LM_COMMON) | {"batch": dp, "seq": None,
                            "kv_heads": None, "kv_len": ("model",)}
    if batch == 1:
        r |= {"batch": None,
              "kv_len": ("data", "model") if not multi_pod
              else ("pod", "data", "model")}
    return r


def lm_rules_ep_moe(rules: dict) -> dict:
    """The EP-MoE variant: experts over ``model`` (all-to-all MoE)."""
    return rules | {"expert": ("model",), "ffn": None}


def gnn_rules(multi_pod: bool) -> dict:
    """Edges over every device; node features replicated."""
    dp = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {"edges": dp, "nodes": None, "feat": None, "batch": dp,
            "hidden": None}


def recsys_rules(multi_pod: bool) -> dict:
    """The batch over every device, tables table-wise over ``model``."""
    dp = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        "batch": dp,
        "table_axis": ("model",),
        "table_rows": None,
        "embed": None,
        "mlp_in": None,
        "mlp_out": ("model",),
        "heads": ("model",),
        "ffn": ("model",),
        "seq": None,
        "candidates": ("model",),
        "vocab": ("model",),
        "fsdp": ("data",),
        "expert": None,
        "kv_heads": ("model",),
        "kv_len": None,
    }


def recsys_rules_rowsharded(multi_pod: bool) -> dict:
    """The row-sharded variant: table rows over ``model``."""
    r = recsys_rules(multi_pod)
    r["table_axis"] = None
    r["table_rows"] = ("model",)
    return r


def serve_rules(mesh=None, placement=None) -> dict:
    """Retrieval-serving rules: queries replicated, the corpus doc axis
    ("candidates") over ``model`` on the flat host mesh
    (``launch.mesh.make_serve_mesh()``) or over ``candidates`` on the
    ``hosts x candidates`` grid (``make_serve_mesh(hosts=...)``), where
    each bucket spans the candidates devices of the host group its
    :class:`~repro_torch.sharding.PlacementPlan` names.  ``mesh`` rides
    under ``"__mesh__"`` and ``placement`` (grid only; the derived
    bytes-balanced plan when absent) under ``"__placement__"``."""
    grid = "hosts" in getattr(mesh, "axis_names", ())
    r = {"batch": None,
         "candidates": ("candidates",) if grid else ("model",),
         "embed": None, "seq": None}
    if mesh is not None:
        r["__mesh__"] = mesh
    if placement is not None:
        r["__placement__"] = placement
    return r


def data_mesh_for(sharded: bool | None, *, who: str):
    """The ``data``-axis mesh the sharded pruning consumers
    (``voronoi.global_keep_masks``, ``pruning_pipeline.
    pruning_order_bucketed``) shard over: ``None`` picks the active
    rules' ``"__mesh__"`` when its ``data`` axis is wider than 1;
    ``True`` requires one (the error names ``who``); ``False`` never
    shards."""
    if sharded is False:
        return None
    mesh = (current_rules() or {}).get("__mesh__")
    ok = (mesh is not None and "data" in getattr(mesh, "axis_names", ())
          and mesh.shape["data"] > 1)
    if sharded and not ok:
        raise ValueError(
            f"{who}(sharded=True) needs active sharding rules carrying "
            "a '__mesh__' with a data axis wider than 1 (see "
            "sharding.axis_rules)")
    return mesh if ok else None


def grid_axes_for(rules: dict | None = None):
    """``(mesh, n_groups, n_cand, placement)`` of the active rules'
    ``hosts x candidates`` grid with more than one host group;
    ``(None, 1, 1, None)`` otherwise (a flat mesh keeps the one-tier
    sharded merge, and a 1-group grid degenerates to it)."""
    rules = rules if rules is not None else (current_rules() or {})
    mesh = rules.get("__mesh__")
    names = getattr(mesh, "axis_names", ())
    if mesh is None or "hosts" not in names or "candidates" not in names:
        return None, 1, 1, None
    n_groups = mesh.shape["hosts"]
    if n_groups <= 1:
        return None, 1, 1, None
    return mesh, n_groups, mesh.shape["candidates"], rules.get("__placement__")
