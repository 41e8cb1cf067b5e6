"""Logical-axis sharding rules for serving and pruning, thread-local.

Counterpart of ``repro.sharding.specs``, its serving and pruning rules
only.  A launcher activates a rule set mapping logical axis names
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
which copy each shard onto its device.  The reference's LM, GNN and
recsys rule sets are not ported (ROADMAP § A item 7b).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["axis_rules", "constrain", "current_rules", "data_mesh_for",
           "grid_axes_for", "logical_to_spec", "mesh_axes_for",
           "serve_rules", "spec_for"]

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


def constrain(x, *logical_axes):
    """The identity: eager PyTorch has no sharding constraint (module
    docstring).  Kept so code ported from the reference reads alike."""
    return x


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
