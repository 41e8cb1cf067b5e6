"""Recsys models: the CTR family, BERT4Rec and the two-tower head.

Counterpart of ``repro.models.recsys`` for DLRM (RM-2), DCN-v2 and Wide
& Deep, their configs and ``*_init``/``*_forward`` functions, the
model-level ``embedding_bag``, ``user_tower``, ``score_candidates`` and
``retrieve_topk``, the all-to-all lookup over row-sharded tables
(``alltoall_lookup``, routed to by ``_table_lookup`` under the rules'
``"__lookup__": "a2a"``), and BERT4Rec (``Bert4RecConfig``,
``bert4rec_init``, ``bert4rec_forward``, ``bert4rec_user_vectors``,
``bert4rec_sampled_logits``, ``sampled_softmax_loss``).

Tables.  The reference draws each model's F tables as one (F·V, D)
matrix and views it as (F, V, D); here every model keeps the stacked
(F·V, D) table (``tables``; Wide & Deep's wide table as (F·V, 1)), so
the whole per-feature lookup is one EmbeddingBag launch: feature f's id
i reads row f·V + i.  Ids out of range follow ``jnp.take`` on (F, V, D)
per feature, before the offset: an id in [-V, 0) wraps within its own
feature and an id outside [-V, V) gives a NaN row, so a bad id of
feature f never reads a row of feature f + 1.

Backends (``core/backend.py``'s ``SERVING``): ``fused`` runs every
lookup and bag through the EmbeddingBag kernel (B8): the CTR lookup as
n_bags = B·F bags of one id, the user tower's feature mean and Wide &
Deep's wide sum as B bags of F ids.  ``reference`` gathers per feature
in plain torch and adds a bag's rows in the kernel's ascending order,
so on fp32 tables the two give the same bits.  The reference's
``_table_lookup`` is ``jnp.take`` under ``vmap``: B8 computes the same
function (0 + x = x in fp32).

Everything else is plain PyTorch in fp32 (TF32 off, ``core/backend``);
the MLPs' matmuls sum in another order than XLA's, so logits agree with
the reference to fp32 rounding, not bit for bit.

Training differentiates the ``reference`` path: neither package has a
backward kernel, and the kernel wrappers refuse an input that requires
grad.  The plain lookups gather with ``core.segment.take_rows``, whose
backward adds a row's repeats in a fixed order, so a resumed run is bit
for bit an uninterrupted one.

BERT4Rec is the port's bidirectional ``Transformer`` (fp32, tied
embeddings, vocab ``n_items + 2``); ``bert4rec_init`` returns one.  Its
full-sequence attention takes the flash-attention kernel (B7) on
``fused`` when there is no key mask, as the serving cells run it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import backend as backend_lib
from repro_torch.core.segment import take_rows
from repro_torch.kernels.embedding_bag.ops import INT32_MAX, embedding_bag_op
from repro_torch.kernels.embedding_bag.ref import (bag_reduce, gather_rows,
                                                   wrap_ids)
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dense_init
from repro_torch.sharding.specs import (constrain, current_rules, note_lookup,
                                        note_topk)

__all__ = [
    "A2APlan", "Bert4RecConfig", "DCN", "DCNConfig", "DLRM", "DLRMConfig",
    "WideDeep", "WideDeepConfig", "a2a_plan", "alltoall_dropped",
    "alltoall_lookup", "bert4rec_forward", "bert4rec_init",
    "bert4rec_sampled_logits", "bert4rec_user_vectors", "ctr_forward",
    "dcn_forward", "dcn_init", "dlrm_forward", "dlrm_init", "embedding_bag", "init_model",
    "retrieve_topk", "sampled_softmax_loss", "score_candidates",
    "user_tower", "widedeep_forward", "widedeep_init",
]


# ---------------------------------------------------------------------------
# Lookups
# ---------------------------------------------------------------------------

def embedding_bag(table, ids, bag_ids, n_bags: int, weights=None,
                  mode: str = "sum"):
    """EmbeddingBag(sum/mean) over variable bags: rows = table[ids]
    (``jnp.take``'s rule), times ``weights`` when given, summed per
    ``bag_ids``; ``mean`` divides by max(count, 1), so an empty bag is
    zero.  table (V, D); ids, bag_ids, weights (nnz,) -> (n_bags, D).
    Plain torch (``index_add_``): B8 takes fixed bags only.  ``bag_ids``
    must lie in [0, n_bags)."""
    rows = gather_rows(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    bag_ids = bag_ids.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device).index_add_(0, bag_ids, rows)
    if mode == "mean":
        cnt = torch.zeros((n_bags,), dtype=table.dtype,
                          device=table.device).index_add_(
            0, bag_ids, torch.ones_like(bag_ids, dtype=table.dtype))
        out = out / torch.clamp(cnt[:, None], min=1.0)
    return out


def stacked_ids(ids, table_rows: int):
    """(B, F) per-feature ids -> int32 ids into the stacked (F·V, D)
    table: id + f·V after ``jnp.take``'s rule per feature; an id outside
    [-V, V) becomes 2^31 - 1, past the stacked table (a NaN row)."""
    n_feat = ids.shape[1]
    if n_feat * table_rows >= INT32_MAX:
        raise ValueError(f"{n_feat} x {table_rows} rows: the stacked table "
                         f"needs fewer than 2^31 - 1 rows for int32 ids")
    safe, valid = wrap_ids(ids, table_rows)
    offset = torch.arange(n_feat, device=ids.device) * table_rows
    return torch.where(valid, safe + offset, INT32_MAX).to(torch.int32)


def _resolve(backend, tables):
    return backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                       device=tables.device)


def _feature_rows(tables, ids):
    """The plain per-feature gather: stacked (F·V, D) viewed as (F, V, D),
    ``tables[f][ids[:, f]]`` under ``jnp.take``'s rule -> (B, F, D),
    through ``take_rows`` (a backward in a fixed order)."""
    n_feat = ids.shape[1]
    V = tables.shape[0] // n_feat
    safe, valid = wrap_ids(ids, V)
    offset = torch.arange(n_feat, device=ids.device) * V
    rows = take_rows(tables, safe + offset)
    return torch.where(valid[..., None], rows, float("nan"))


def _rows_per_feature(tables, n_feat: int) -> int:
    if tables.shape[0] % n_feat:
        raise ValueError(f"{tables.shape[0]} table rows do not split into "
                         f"{n_feat} features")
    return tables.shape[0] // n_feat


def _gather_lookup(tables, ids, backend):
    """The per-feature gather: one B8 launch (B·F bags of one id) on
    ``fused``, ``_feature_rows`` on ``reference``."""
    B, n_feat = ids.shape
    V = _rows_per_feature(tables, n_feat)
    if _resolve(backend, tables) == backend_lib.FUSED:
        flat = stacked_ids(ids, V).reshape(-1, 1)
        return embedding_bag_op(tables, flat).view(B, n_feat, -1)
    return _feature_rows(tables, ids)


def _table_lookup(tables, ids, *, backend=None):
    """stacked tables (F·V, D) x ids (B, F) -> (B, F, D): the all-to-all
    exchange when the active rules carry ``"__lookup__": "a2a"`` (the
    reference's routing), else the per-feature gather."""
    if (current_rules() or {}).get("__lookup__") == "a2a":
        return alltoall_lookup(tables, ids, backend=backend)
    _constrain_table(tables, ids)
    return _gather_lookup(tables, ids, backend)


def _constrain_table(tables, ids):
    """The reference's constraint on the (F, V[, D]) tables it reads at
    ``ids`` (B, F), on a view of the stacked rows."""
    n_feat = ids.shape[1]
    view = tables.view(n_feat, -1, *tables.shape[1:])
    if tables.shape[1] == 1:        # the wide table: (F, V)
        constrain(view[..., 0], "table_axis", "table_rows", ids=ids)
    else:
        constrain(view, "table_axis", "table_rows", None, ids=ids)


# ---------------------------------------------------------------------------
# The all-to-all lookup over row-sharded tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class A2APlan:
    """The exchange's geometry on a mesh: the positions as a (G, S) grid
    of devices (G groups of S shards: the mesh axes outside the lookup
    axes, then the lookup axes, each row-major), each position's
    ``n_req`` requests (its b_local samples x F), each shard's ``vsh``
    rows of every feature, and the ``cap`` requests a bucket holds."""
    devices: Any            # numpy (G, S) array of torch.device
    n_req: int
    vsh: int
    cap: int

    @property
    def n_groups(self) -> int:
        return self.devices.shape[0]

    @property
    def n_shards(self) -> int:
        return self.devices.shape[1]


def a2a_plan(mesh, rules: dict, batch: int, n_feat: int, table_rows: int,
             capacity_factor: float = 2.0) -> A2APlan:
    """The reference's sizes: shards = the product of the lookup axes
    (``__lookup_axes__``, ``("model",)`` by default); the batch over
    every position; ``vsh = V // shards``; ``cap = max(1, ceil(cf ·
    n_req / shards))``.  A batch or a V that does not split evenly
    raises ``ValueError``, as the reference's ``shard_map`` does."""
    shard_axes = tuple(rules.get("__lookup_axes__", ("model",)))
    dp_axes = tuple(a for a in mesh.axis_names if a not in shard_axes)
    n_pos = int(mesh.devices.size)
    n_shards = math.prod(mesh.shape[a] for a in shard_axes)
    if batch % n_pos or table_rows % n_shards:
        raise ValueError(f"a batch of {batch} over {n_pos} mesh positions, "
                         f"{table_rows} rows over {n_shards} shards: the "
                         f"exchange needs both to split evenly")
    order = [mesh.axis_names.index(a) for a in dp_axes + shard_axes]
    grid = np.transpose(mesh.devices, order).reshape(-1, n_shards)
    n_req = batch // n_pos * n_feat
    return A2APlan(grid, n_req, table_rows // n_shards,
                   max(1, math.ceil(capacity_factor * n_req / n_shards)))


def _exchange_mesh():
    """The active rules' mesh where it has a ``model`` axis, else None
    (the exchange then is the per-feature gather)."""
    mesh = (current_rules() or {}).get("__mesh__")
    return mesh if "model" in getattr(mesh, "axis_names", ()) else None


def _route(flat, plan: A2APlan):
    """Each position's requests (P, n_req) int64 -> (owner, slot, keep):
    the owner shard of each request, its slot in that owner's bucket
    (its rank among the position's requests to the owner, in request
    order: the reference's stable sort by owner) and whether the slot
    is below ``cap``.  Static shapes: a sort and a search, no count."""
    P, n = flat.shape
    S = plan.n_shards
    owner = torch.div(flat, plan.vsh, rounding_mode="floor")
    sorted_owner, order = torch.sort(owner, dim=-1, stable=True)
    first = torch.searchsorted(sorted_owner, torch.arange(
        S, device=flat.device).expand(P, S).contiguous())
    rank = (torch.arange(n, device=flat.device).expand(P, n)
            - first.gather(1, sorted_owner))
    slot = torch.empty_like(rank).scatter_(1, order, rank)
    return owner, slot, slot < plan.cap


def _buckets(values, cell, keep, width: int):
    """(P, width) buckets holding ``values`` at ``cell`` for the kept
    requests and 0 elsewhere.  Every value is >= 0, so the dropped
    requests, scattered at cell 0 as 0 under ``amax``, change no slot
    (the reference's ``.set`` lets one overwrite slot 0)."""
    out = torch.zeros((values.shape[0], width), dtype=values.dtype,
                      device=values.device)
    return out.scatter_reduce_(1, cell, torch.where(keep, values, 0), "amax")


def _answer(tables, gid, backend):
    """The stacked table's rows at ``gid`` -> (*gid.shape, D): one B8
    launch (bags of one id) on ``fused``, else ``take_rows`` (its
    backward sums a row's requests in ``gid``'s order)."""
    if _resolve(backend, tables) == backend_lib.FUSED:
        rows = embedding_bag_op(tables, gid.reshape(-1, 1).to(torch.int32))
        return rows.view(tuple(gid.shape) + (tables.shape[1],))
    return take_rows(tables, gid)


def _on(device, tensor) -> bool:
    """Whether the mesh position ``device`` is where ``tensor`` lies (an
    index-less device is its type's current one)."""
    device = torch.device(device)
    return device.type == tensor.device.type and (
        device.index is None or device == tensor.device)


def _owner_rows(tables, req, feat, plan: A2APlan, V: int, backend):
    """Each owner's answers: ``req`` and ``feat`` (G, S_own, S_src, cap)
    local rows and features received -> rows (G, S_own, S_src, cap, D).
    Owners on the table's device answer together from the stacked
    table; an owner on another device gets its shard's rows there and
    answers on it, and its rows come back to the table's device."""
    lo = torch.arange(plan.n_shards, device=req.device)[:, None, None]
    gid = feat * V + lo * plan.vsh + req
    here = np.array([[_on(d, tables) for d in row] for row in plan.devices])
    if here.all():
        return _answer(tables, gid, backend)
    per_feat = tables.view(-1, V, tables.shape[1])
    rows = []
    for g, s in np.ndindex(*here.shape):
        if here[g, s]:
            rows.append(_answer(tables, gid[g, s], backend))
            continue
        dev = plan.devices[g, s]
        shard = per_feat[:, s * plan.vsh:(s + 1) * plan.vsh].to(dev)
        local = (feat[g, s] * plan.vsh + req[g, s]).to(dev)
        rows.append(_answer(shard.reshape(-1, shard.shape[2]), local,
                            backend).to(tables.device))
    return torch.stack(rows).view(gid.shape + (tables.shape[1],))


def alltoall_lookup(tables, ids, *, capacity_factor: float = 2.0,
                    backend=None):
    """The production-DLRM embedding exchange (the reference's
    ``alltoall_lookup``, the ``a2a_lookup`` / ``a2a_zero`` variants):
    stacked tables (F·V, D), shard s of feature f its rows f·V + s·vsh
    ... f·V + (s+1)·vsh, x ids (B, F), the batch over every position of
    the active rules' ``__mesh__`` -> (B, F, D).  Each position buckets
    its b_local·F requests by owner shard (:func:`_route`), the buckets
    of local rows and of feature ids go to their owners (recv[owner][src]
    = sent[src][owner]: the all-to-all, here a transpose of (src, owner,
    cap) buffers), each owner answers from its rows, the rows come back
    by the inverse transpose and each position reads its requests'
    slots.  A request past its bucket's ``cap`` is dropped: a zero row
    and no gradient.

    One controller drives every position: positions that share a device
    run as one batch of tensors with a leading positions axis (static
    shapes, so the step runs on ``meta``).  On ``reference`` the owners'
    rows are ``take_rows`` of the stacked table at their requests' rows
    laid out (group, owner, source, slot): a row's gradient adds its
    requests in global request order (source position in batch order,
    then request order), the order of the per-feature gather's, so where
    nothing is dropped and the owners share the table's device the
    gradient is bit-equal to it.  On ``fused`` (no grad) the owners'
    buckets are one B8 launch.  Ids must lie in [0, V): the reference's
    exchange has no wrap rule (``ValueError`` otherwise, where the
    values are known).  With no mesh, or no ``model`` axis, it is the
    per-feature gather."""
    B, n_feat = ids.shape
    V = _rows_per_feature(tables, n_feat)
    mesh = _exchange_mesh()
    if mesh is None:
        return _gather_lookup(tables, ids, backend)
    plan = a2a_plan(mesh, current_rules(), B, n_feat, V, capacity_factor)
    bad = ((ids < 0) | (ids >= V)).any()
    if ids.device.type != "meta" and bool(bad):
        raise ValueError(f"alltoall_lookup: an id outside [0, {V}); the "
                         f"exchange has no wrap rule")
    G, S, cap, D = plan.n_groups, plan.n_shards, plan.cap, tables.shape[1]
    flat = ids.long().reshape(G * S, plan.n_req)
    owner, slot, keep = _route(flat, plan)
    cell = torch.where(keep, owner * cap + slot, 0)
    feat = torch.arange(plan.n_req, device=ids.device) % n_feat
    req = _buckets(flat - owner * plan.vsh, cell, keep, S * cap)
    fbuf = _buckets(feat.expand_as(flat), cell, keep, S * cap)
    # the exchange: (G, S_src, S_own, cap) -> (G, S_own, S_src, cap)
    req_x = req.view(G, S, S, cap).transpose(1, 2)
    fbuf_x = fbuf.view(G, S, S, cap).transpose(1, 2)
    rows = _owner_rows(tables, req_x, fbuf_x, plan, V, backend)
    back = rows.transpose(1, 2).reshape(-1, D)
    start = torch.arange(G * S, device=ids.device)[:, None] * (S * cap)
    got = back.index_select(0, (start + cell).reshape(-1))
    return torch.where(keep.reshape(-1, 1), got, 0).view(B, n_feat, D)


def alltoall_dropped(ids, table_rows: int, *,
                     capacity_factor: float = 2.0) -> int:
    """How many of ``ids``' requests :func:`alltoall_lookup` drops under
    the active rules (0 with no mesh)."""
    mesh = _exchange_mesh()
    if mesh is None:
        return 0
    plan = a2a_plan(mesh, current_rules(), ids.shape[0], ids.shape[1],
                    table_rows, capacity_factor)
    flat = ids.long().reshape(-1, plan.n_req)
    return int((~_route(flat, plan)[2]).sum())


def _feature_bag(tables, ids, mode: str, *, backend=None):
    """Per sample, the sum or mean of its F feature rows -> (B, D): one
    B8 launch (B bags of F ids) on ``fused``; on ``reference`` the plain
    gather, added in the same ascending order."""
    if _resolve(backend, tables) == backend_lib.FUSED:
        g = stacked_ids(ids, tables.shape[0] // ids.shape[1])
        return embedding_bag_op(tables, g, mode=mode)
    return bag_reduce(_feature_rows(tables, ids), mode)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

class MLP(nn.ModuleList):
    """``nn.Linear`` layers with ReLU between them (and after the last
    with ``final_act``), the reference's ``_mlp_apply``."""

    def __init__(self, dims, dtype=torch.float32):
        super().__init__(nn.Linear(a, b, dtype=dtype)
                         for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, final_act: bool = False):
        for i, lin in enumerate(self):
            x = lin(x)
            if i < len(self) - 1 or final_act:
                x = F.relu(x)
        return x


def _empty(cls, cfg, device):
    """``cls(cfg)`` built without storage and placed on ``device``."""
    with torch.device("meta"):
        model = cls(cfg)
    return model.to_empty(device=device)


def _fill_tables_(table, generator, scale=0.02):
    """N(0, scale²) in place (the reference's ``embed_init``), so the
    full tables are drawn on the card without a second copy."""
    table.normal_(0.0, 1.0, generator=generator).mul_(scale)


def _fill_linear_(lin, generator, scale=None):
    """The reference's ``dense_init`` (N(0, 1/in) unless ``scale``),
    stored (out, in); zero bias."""
    lin.weight.copy_(dense_init(generator, lin.in_features, lin.out_features,
                                lin.weight.dtype, scale=scale).T)
    lin.bias.zero_()


# ---------------------------------------------------------------------------
# DLRM (RM-2) [arXiv:1906.00091]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    table_rows: int = 1_000_000
    bot_mlp: tuple = (13, 512, 256, 64)
    top_mlp_hidden: tuple = (512, 512, 256, 1)
    interaction: str = "dot"
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def param_count(self) -> int:
        n = self.n_sparse * self.table_rows * self.embed_dim
        dims = self.bot_mlp
        for i in range(len(dims) - 1):
            n += dims[i] * dims[i + 1] + dims[i + 1]
        n_f = self.n_sparse + 1
        inter = n_f * (n_f - 1) // 2 + self.embed_dim
        dims = (inter,) + self.top_mlp_hidden
        for i in range(len(dims) - 1):
            n += dims[i] * dims[i + 1] + dims[i + 1]
        return n


class DLRM(nn.Module):
    """Bottom MLP on the dense features, one table lookup per sparse
    feature, the dot interaction (upper triangle of the (F+1)² Gram
    matrix, then x0), top MLP -> (B,) logits."""

    def __init__(self, cfg: DLRMConfig):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.Parameter(torch.empty(
            cfg.n_sparse * cfg.table_rows, cfg.embed_dim,
            dtype=cfg.param_dtype))
        n_f = cfg.n_sparse + 1
        self.bot = MLP(cfg.bot_mlp, cfg.param_dtype)
        self.top = MLP((n_f * (n_f - 1) // 2 + cfg.embed_dim,)
                       + cfg.top_mlp_hidden, cfg.param_dtype)

    def interact(self, x0, emb):
        """x0 (B, D), emb (B, F, D) -> the top MLP's input: the upper
        triangle of the (F+1)² Gram matrix (row-major, as
        ``jnp.triu_indices``), then x0."""
        feats = torch.cat([x0[:, None, :], emb], dim=1)         # (B, F+1, D)
        if self.cfg.interaction != "dot":
            return feats.reshape(x0.shape[0], -1)
        z = torch.bmm(feats, feats.transpose(1, 2))
        n = feats.shape[1]
        iu = torch.triu_indices(n, n, 1, device=z.device)
        return torch.cat([z[:, iu[0], iu[1]], x0], dim=-1)

    def forward(self, dense, sparse_ids, *, backend=None):
        x0 = self.bot(dense.to(self.cfg.compute_dtype), final_act=True)
        emb = _table_lookup(self.tables, sparse_ids, backend=backend)
        emb = constrain(emb, "batch", None, None)
        return self.top(self.interact(x0, emb))[:, 0]


@torch.no_grad()
def dlrm_init(generator: torch.Generator, cfg: DLRMConfig,
              device=None) -> DLRM:
    """A DLRM drawn from ``generator`` on its device (tables N(0, 0.02²),
    MLPs N(0, 1/in), zero biases)."""
    model = _empty(DLRM, cfg, torch.device(device or generator.device))
    _fill_tables_(model.tables, generator)
    for lin in (*model.bot, *model.top):
        _fill_linear_(lin, generator)
    return model.eval()


def dlrm_forward(model: DLRM, dense, sparse_ids, *, backend=None):
    """dense (B, n_dense), sparse_ids (B, n_sparse) -> (B,) logits."""
    return model(dense, sparse_ids, backend=backend)


# ---------------------------------------------------------------------------
# DCN-v2 [arXiv:2008.13535]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    table_rows: int = 1_000_000
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def x0_dim(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim

    def param_count(self) -> int:
        n = self.n_sparse * self.table_rows * self.embed_dim
        d = self.x0_dim
        n += self.n_cross_layers * (d * d + d)
        dims = (d,) + self.mlp + (1,)
        for i in range(len(dims) - 1):
            n += dims[i] * dims[i + 1] + dims[i + 1]
        return n


class DCN(nn.Module):
    """x0 = [dense, embeddings]; full-rank cross layers
    x_{l+1} = x0 * (W x_l + b) + x_l; MLP -> (B,) logits."""

    def __init__(self, cfg: DCNConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.x0_dim
        self.tables = nn.Parameter(torch.empty(
            cfg.n_sparse * cfg.table_rows, cfg.embed_dim,
            dtype=cfg.param_dtype))
        self.cross = nn.ModuleList(nn.Linear(d, d, dtype=cfg.param_dtype)
                                   for _ in range(cfg.n_cross_layers))
        self.mlp = MLP((d,) + cfg.mlp + (1,), cfg.param_dtype)

    def forward(self, dense, sparse_ids, *, backend=None):
        emb = _table_lookup(self.tables, sparse_ids, backend=backend)
        B = dense.shape[0]
        x0 = torch.cat([dense.to(self.cfg.compute_dtype),
                        emb.reshape(B, -1)], dim=-1)
        x = x0
        for cl in self.cross:
            x = constrain(x0 * cl(x) + x, "batch", None)
        return self.mlp(x)[:, 0]


@torch.no_grad()
def dcn_init(generator: torch.Generator, cfg: DCNConfig, device=None) -> DCN:
    """A DCN-v2 drawn from ``generator`` (cross weights N(0, 0.01²))."""
    model = _empty(DCN, cfg, torch.device(device or generator.device))
    _fill_tables_(model.tables, generator)
    for cl in model.cross:
        _fill_linear_(cl, generator, scale=0.01)
    for lin in model.mlp:
        _fill_linear_(lin, generator)
    return model.eval()


def dcn_forward(model: DCN, dense, sparse_ids, *, backend=None):
    return model(dense, sparse_ids, backend=backend)


# ---------------------------------------------------------------------------
# Wide & Deep [arXiv:1606.07792]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    table_rows: int = 1_000_000
    mlp: tuple = (1024, 512, 256)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def param_count(self) -> int:
        n = self.n_sparse * self.table_rows * (self.embed_dim + 1)
        dims = (self.n_sparse * self.embed_dim,) + self.mlp + (1,)
        for i in range(len(dims) - 1):
            n += dims[i] * dims[i + 1] + dims[i + 1]
        return n


class WideDeep(nn.Module):
    """Deep: the concatenated embeddings through an MLP.  Wide: the sum
    of one scalar per sparse feature from the (F·V, 1) wide table (B8
    with D = 1).  Logit = deep + wide + bias."""

    def __init__(self, cfg: WideDeepConfig):
        super().__init__()
        self.cfg = cfg
        rows = cfg.n_sparse * cfg.table_rows
        self.tables = nn.Parameter(torch.empty(
            rows, cfg.embed_dim, dtype=cfg.param_dtype))
        self.wide = nn.Parameter(torch.empty(rows, 1, dtype=cfg.param_dtype))
        self.mlp = MLP((cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,),
                       cfg.param_dtype)
        self.bias = nn.Parameter(torch.empty((), dtype=cfg.param_dtype))

    def forward(self, sparse_ids, *, backend=None):
        emb = _table_lookup(self.tables, sparse_ids, backend=backend)
        deep = self.mlp(emb.reshape(sparse_ids.shape[0], -1))[:, 0]
        _constrain_table(self.wide, sparse_ids)
        wide = _feature_bag(self.wide, sparse_ids, "sum",
                            backend=backend)[:, 0]
        return deep + wide + self.bias


@torch.no_grad()
def widedeep_init(generator: torch.Generator, cfg: WideDeepConfig,
                  device=None) -> WideDeep:
    model = _empty(WideDeep, cfg, torch.device(device or generator.device))
    _fill_tables_(model.tables, generator)
    _fill_tables_(model.wide, generator)
    for lin in model.mlp:
        _fill_linear_(lin, generator)
    model.bias.zero_()
    return model.eval()


def widedeep_forward(model: WideDeep, sparse_ids, *, backend=None):
    return model(sparse_ids, backend=backend)


def ctr_forward(model: nn.Module, batch, *, backend=None):
    """The (B,) logits of a CTR batch (``dense``, ``sparse_ids``) through
    a DLRM, DCN-v2 or Wide & Deep (which reads no dense features)."""
    if isinstance(model, WideDeep):
        return model(batch["sparse_ids"], backend=backend)
    return model(batch["dense"], batch["sparse_ids"], backend=backend)


# ---------------------------------------------------------------------------
# BERT4Rec [arXiv:1904.06690] — bidirectional transformer over item seqs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    d_ff: int = 256
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    def lm_config(self) -> tfm.LMConfig:
        return tfm.LMConfig(
            name="bert4rec-core", n_layers=self.n_blocks,
            d_model=self.embed_dim, n_heads=self.n_heads,
            n_kv_heads=self.n_heads, d_ff=self.d_ff,
            vocab=self.n_items + 2,      # +mask +pad
            causal=False, tie_embeddings=True, rope_theta=1e4,
            param_dtype=self.param_dtype, compute_dtype=self.compute_dtype,
            remat=False)

    def param_count(self) -> int:
        return self.lm_config().param_count()


def bert4rec_init(generator: torch.Generator, cfg: Bert4RecConfig,
                  device=None) -> tfm.Transformer:
    """The reference's ``tfm.init_params`` of ``cfg.lm_config()``, drawn
    from ``generator`` on its device (or ``device``)."""
    return tfm.init_params(generator, cfg.lm_config(), device)


def bert4rec_forward(model: tfm.Transformer, cfg: Bert4RecConfig, item_ids,
                     attn_mask=None, *, backend=None):
    """Masked-item logits over the catalog: (B, S, n_items + 2)."""
    return model(item_ids, attn_mask, backend=backend)


def bert4rec_user_vectors(model: tfm.Transformer, cfg: Bert4RecConfig,
                          item_ids, attn_mask=None, *, backend=None):
    """(sequence-token embeddings (B, S, D), pooled user vectors (B, D)):
    the mean over the sequence, or over its ``attn_mask`` positions."""
    h = model.hidden_states(item_ids, attn_mask, backend=backend)
    if attn_mask is None:
        return h, h.mean(dim=1)
    w = attn_mask[..., None].to(h.dtype)
    return h, (h * w).sum(1) / torch.clamp(w.sum(1), min=1.0)


def bert4rec_sampled_logits(model: tfm.Transformer, cfg: Bert4RecConfig,
                            item_ids, mask_idx, labels, negatives, *,
                            backend=None):
    """The sampled-softmax training head (a full (B, S, 1M) logit tensor
    is not a real system's training path).  item_ids (B, S); mask_idx
    (B, M) masked positions; labels (B, M) gold item ids; negatives (N,)
    shared sampled ids.  Returns (pos_logit (B, M), neg_logits
    (B, M, N)).  The gathers are ``take_rows`` (a fixed-order
    backward)."""
    h = model.hidden_states(item_ids, backend=backend)          # (B, S, D)
    B, S, D = h.shape
    rows = torch.arange(B, device=h.device)[:, None] * S + mask_idx.long()
    hm = take_rows(h.reshape(B * S, D), rows)                   # (B, M, D)
    table = model.embed.weight.to(h.dtype)                      # (V, D)
    pos_emb = take_rows(table, note_lookup(table, labels).long())  # (B,M,D)
    neg_emb = take_rows(table, negatives.long())                # (N, D)
    pos_logit = (hm * pos_emb).sum(-1)                          # (B, M)
    neg_logits = hm @ neg_emb.T                                 # (B, M, N)
    return pos_logit, neg_logits


def sampled_softmax_loss(pos_logit, neg_logits):
    all_logits = torch.cat([pos_logit[..., None], neg_logits],
                           dim=-1).float()
    return (torch.logsumexp(all_logits, dim=-1) - pos_logit).mean()


_INIT = {DLRMConfig: dlrm_init, DCNConfig: dcn_init,
         WideDeepConfig: widedeep_init, Bert4RecConfig: bert4rec_init}


def init_model(generator: torch.Generator, cfg, device=None) -> nn.Module:
    """The model of ``cfg``'s family drawn from ``generator``."""
    if type(cfg) not in _INIT:
        raise TypeError(f"no recsys model for {type(cfg).__name__}")
    return _INIT[type(cfg)](generator, cfg, device)


# ---------------------------------------------------------------------------
# Two-tower retrieval head
# ---------------------------------------------------------------------------

def user_tower(model: nn.Module, dense, sparse_ids, *, backend=None):
    """User vector = mean of the sparse feature embeddings (one B8 launch
    on ``fused``: B bags of F ids, ``mode="mean"``), plus the bottom
    MLP's output when the model has a dense tower -> (B, D)."""
    _constrain_table(model.tables, sparse_ids)
    u = _feature_bag(model.tables, sparse_ids, "mean", backend=backend)
    if dense is not None and hasattr(model, "bot"):
        u = u + model.bot(dense.to(u.dtype), final_act=True)
    return u


def score_candidates(user_vec, item_table):
    """(B, D) x (n_cand, D) -> (B, n_cand) in one matmul."""
    item_table = constrain(item_table, "candidates", None)
    return constrain(user_vec @ item_table.T, "batch", "candidates")


def retrieve_topk(model: nn.Module, dense, sparse_ids, *, k: int = 100,
                  backend=None):
    """The retrieval_cand cell: the user tower against the item table
    (table 0's rows) -> (values (B, k), int32 ids (B, k)), descending,
    ties to the lowest id (``lax.top_k``'s rule)."""
    u = user_tower(model, dense, sparse_ids, backend=backend)
    items = model.tables[:model.cfg.table_rows]
    return topk_lowest_index(
        note_topk(score_candidates(u, items), "batch", "candidates"), k)
