"""Late-interaction retrieval serving: index -> (two-stage) exact search.

Counterpart of ``repro.serve.retrieval`` on a single device:

* first stage: mean-pooled single-vector scores pick ``n_first``
  candidates; second stage: exact MaxSim rerank of each query's own
  candidates (the ``colbert_maxsim`` rerank kernel on the ``fused``
  backend).  ``n_first >= n_docs`` (or ``end_to_end=True``) skips the
  first stage and sweeps the whole index exactly.
* :func:`topk_search` — the streaming exact top-k: every bucket's
  ``chunk_docs`` slab is scored (``colbert_maxsim_multi`` kernel on
  ``fused``, the 4-D einsum on ``reference``) and reduced to (n_q, k)
  (score, global doc id) candidates at once; sort-merges by the
  (-score, id) order combine them.  No (n_q, n_docs) matrix is built.

Knobs: ``block_docs`` (the docs a block of B3/B5 takes) and
``chunk_docs`` (the streaming slab) resolve per bucket through the
autotuner (``core.backend.tuned_serving_blocks`` /
``tuned_streaming_blocks``) where the caller passes ``None``; explicit
values win.  A streaming bucket's tuned block serves its full slabs; a
shorter last slab takes the launchers' rule at its own size, so the
heuristic gives every launch the grid it had before the tuner.  No
answer depends on either knob.  :class:`RetrievalServer`
resolves every key its closures ask for before its first serve
(``_warm_tuner``), so a measured race never runs inside a served batch.

Every selection and merge orders on (-score, id) with stable sorts —
descending score, ties to the lowest doc id, ``lax.top_k``'s contract —
because ``torch.topk`` promises no order among ties.  Sentinels are the
reference's: masked scores -1e30, pad ids -1 or >= ``pad_from``.

Compressed indexes: ``int8`` buckets dequantize to fp32 and go through
the dense scorers; ``residual`` buckets travel as
:class:`~repro_torch.serve.index.ResidualView` and, on ``fused``, reach
the residual kernels still compressed (the ``reference`` backend
decodes them eagerly — it is the materializing oracle).

Candidate routing (``topk_search(route=...)``, ``serve/routing.py``)
restricts the streaming sweep to the buckets a centroid pass selects.

Mutation serving (``topk_search(mutation=...)``, a :class:`MutationView`
of ``serve.mutation.DeltaLog``): the delta buckets of absorbed upserts
are extra leaves of the merge, scored by the same kernels, and every
leaf masks the docs it does not own (shadowed or tombstoned) to -inf
inside the slab scorer, so the result equals a repack of the mutated
corpus bit for bit.

Multi-device serving (``sharding.serve_rules(mesh)``, meshes of
``launch.mesh``): the flat host mesh shards every bucket over its
devices, the ``hosts x candidates`` grid pins buckets to host groups by
a ``sharding.PlacementPlan`` (replicas, failover through
``serve.health.FleetMonitor``, the ``on_group_loss`` policies of
:class:`RetrievalServer`); one process drives every device, and only
(n_q, k) candidate blocks travel between them (the section above
:func:`_dense_bucket`).  The concurrent front-end over
:class:`RetrievalServer` is ``serve/loop.py``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import threading
import time

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.tuning import _pow2_at_least
from repro_torch.core.scoring import NEG_INF
from repro_torch.kernels.colbert_maxsim.ops import (
    colbert_maxsim_multi_op, colbert_maxsim_rerank_op,
    colbert_maxsim_residual_multi_op, colbert_maxsim_residual_rerank_op)
from repro_torch.kernels.colbert_maxsim.ref import (
    colbert_maxsim_multi_ref, colbert_maxsim_rerank_ref)
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.serve import health as health_lib
from repro_torch.serve.index import PackedBucket, PackedIndex, ResidualView
from repro_torch.sharding import (PlacementPlan, axis_rules, bucket_weights,
                                  current_rules, grid_axes_for,
                                  mesh_axes_for)


class TopKResult(tuple):
    """``(top_idx, top_scores)`` that also carries ``coverage`` (the
    share of stored bucket bytes the answer consulted: below 1.0 only
    when grid serving lost every replica of some buckets) and the
    ``epoch_key`` snapshot ``RetrievalServer.query_batch`` answered
    under."""

    coverage: float
    epoch_key: tuple | None = None

    def __new__(cls, top_idx, top_scores, coverage: float = 1.0):
        self = tuple.__new__(cls, (top_idx, top_scores))
        self.coverage = float(coverage)
        return self

    @property
    def top_idx(self):
        return self[0]

    @property
    def top_scores(self):
        return self[1]


@dataclasses.dataclass
class TokenIndex:
    """The dense masked view: full (n_docs, m, dim) tensor + keep mask.
    ``storage()`` reports what compaction would save; ``pack()`` does
    it."""

    d_embs: torch.Tensor       # (n_docs, m, dim)
    d_masks: torch.Tensor      # (n_docs, m) original token validity
    keep: torch.Tensor         # (n_docs, m) pruning decision
    # Shard placements under a mesh (:func:`_shards`), as on PackedIndex.
    _shards: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    _views_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @classmethod
    def build(cls, d_embs, d_masks):
        return cls(d_embs=d_embs, d_masks=d_masks, keep=d_masks)

    def with_keep(self, keep):
        return TokenIndex(self.d_embs, self.d_masks, keep & self.d_masks)

    def pack(self, **kw) -> PackedIndex:
        return PackedIndex.pack(self.d_embs, self.d_masks, self.keep, **kw)

    def storage(self) -> dict:
        total = int(self.d_masks.sum())
        kept = int((self.keep & self.d_masks).sum())
        dim = self.d_embs.shape[-1]
        return {
            "tokens_total": total,
            "tokens_kept": kept,
            "remain_pct": 100.0 * kept / max(total, 1),
            "bytes_fp32": kept * dim * 4,
            "bytes_fp32_unpruned": total * dim * 4,
        }

    @property
    def active_mask(self):
        return self.keep & self.d_masks

    @property
    def device(self) -> torch.device:
        return self.d_embs.device

    def pooled(self):
        w = self.active_mask[..., None].to(self.d_embs.dtype)
        return (self.d_embs * w).sum(1) / w.sum(1).clamp_min(1.0)


def _n_docs(index) -> int:
    return (index.n_docs if isinstance(index, PackedIndex)
            else index.d_masks.shape[0])


def _maxsim_scores_reference(d_embs, active_mask, q_embs, q_masks):
    """Materializing 4-D path — the parity oracle, B3's plain version (one
    product a query, so a row's scores do not depend on its batchmates).
    A :class:`ResidualView` decodes eagerly here; bf16 docs widen to
    fp32."""
    if isinstance(d_embs, ResidualView):
        d_embs = d_embs.dense()
    return colbert_maxsim_multi_ref(q_embs, d_embs, active_mask, q_masks)


def _codec_of(index) -> str | None:
    """The tuner's codec tag of an index: ``"int8"`` or ``"residual{b}"``
    for a compressed pack, ``"bf16"`` for bf16 docs, None for fp32."""
    if isinstance(index, PackedIndex):
        if index.codec_tag() is not None:
            return index.codec_tag()
        embs = next((b.embs for b in index.buckets if b.embs is not None),
                    None)
    else:
        embs = index.d_embs
    return ("bf16" if embs is not None and embs.dtype == torch.bfloat16
            else None)


def _score_block(d_embs, active_mask, q_embs, q_masks, *, backend,
                 block_docs=None):
    """Score one doc array (dense, or a compressed :class:`ResidualView`)
    on the resolved backend -> (n_q, n_docs); on ``fused`` a block of
    the kernel takes ``block_docs`` docs (``None``: the launchers' rule
    at this array's shape)."""
    if backend == backend_lib.FUSED:
        if isinstance(d_embs, ResidualView):
            return colbert_maxsim_residual_multi_op(
                q_embs, d_embs.codes, d_embs.resq, d_embs.scale,
                d_embs.codebook, active_mask.contiguous(), q_masks,
                bits=d_embs.bits, block_docs=block_docs)
        return colbert_maxsim_multi_op(q_embs, d_embs.contiguous(),
                                       active_mask.contiguous(), q_masks,
                                       block_docs=block_docs)
    return _maxsim_scores_reference(d_embs, active_mask, q_embs, q_masks)


def _decodes_in_kernel(index, backend) -> bool:
    """A residual index on ``fused`` stays compressed up to the kernels,
    which decode per tile; everywhere else buckets are read dense."""
    return (isinstance(index, PackedIndex) and index.compression == "residual"
            and backend == backend_lib.FUSED)


def _bucket_array(index: PackedIndex, b, backend):
    """The doc array the scorers consume for bucket ``b``: compressed
    (a :class:`ResidualView`) where the kernel decodes, else the
    bucket's dense view (int8 and residual decoded to fp32)."""
    if _decodes_in_kernel(index, backend):
        return b.residual_view(index.dim)
    return b.dense_embs(index.dim)


def maxsim_scores(index, q_embs, q_masks=None, *,
                  backend: str | None = None,
                  block_docs: int | None = None):
    """(n_q, n_docs) exact MaxSim over the pruned index (either layout;
    packed buckets scatter back through their doc-id remap).
    ``block_docs`` pins the kernels' doc block; ``None`` takes the
    autotuner's, per bucket shape."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    codec = _codec_of(index)

    def score(embs, masks):
        bd = block_docs
        if backend == backend_lib.FUSED:
            bd = backend_lib.tuned_serving_blocks(
                q_embs.shape[0], *masks.shape, q_embs.shape[1],
                q_embs.shape[-1], block_docs, codec=codec,
                device=q_embs.device)
        return _score_block(embs, masks, q_embs, q_masks, backend=backend,
                            block_docs=bd)

    if not isinstance(index, PackedIndex):
        return score(index.d_embs, index.active_mask)
    out = torch.zeros((q_embs.shape[0], index.n_docs), dtype=torch.float32,
                      device=q_embs.device)
    for b in index.buckets:
        out[:, b.doc_ids.long()] = score(_bucket_array(index, b, backend),
                                         b.masks)
    return out


def _merge_topk(scores, ids, k: int):
    """Exact top-k of candidate (scores, ids) columns in the (-score, id)
    order: a stable sort by id, then a stable sort by descending score.
    Returns (ids, scores), each (n_q, k)."""
    o = torch.sort(ids, dim=1, stable=True).indices
    ids, scores = ids.gather(1, o), scores.gather(1, o)
    o = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return ids.gather(1, o), scores.gather(1, o)


def _merge_topk_unique(scores, ids, k: int):
    """:func:`_merge_topk` that also dedupes doc ids: one output slot per
    id, its best candidate.  The mutation merge's root, where a doc id
    arrives once per leaf holding a copy (the stale copies at -inf).

    The (id, -score) order (a stable sort by descending score, then a
    stable sort by id) puts each id's best candidate first; the rest
    become the (-inf, -1) sentinel, and the (-score, id) merge follows.
    Where finite ids are already unique the result is
    :func:`_merge_topk`'s."""
    o = torch.sort(scores, dim=1, descending=True, stable=True).indices
    ids, scores = ids.gather(1, o), scores.gather(1, o)
    o = torch.sort(ids, dim=1, stable=True).indices
    ids, scores = ids.gather(1, o), scores.gather(1, o)
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    return _merge_topk(torch.where(dup, -torch.inf, scores),
                       torch.where(dup, -1, ids), k)


def _stream_chunk_topk(n: int, chunk: int, k: int, score_slab,
                       doc_ids=None, pad_from: int | None = None):
    """Sweep the doc axis in ``chunk`` slabs, reduce each slab's scores
    (``score_slab(start, stop) -> (n_q, stop - start)``) to its local
    top-k (score, global id) columns at once, and concatenate.  Pad
    audits: ids below 0 (zero-doc pads) and at/above ``pad_from``
    (shard pads) score -inf, so a pad never displaces a real doc — a
    real empty-after-prune doc scores the finite l x -1e30 sentinel.
    Within a slab the lowest local index is the lowest doc id (ids
    ascend within every bucket), so a stable sort keeps the contract."""
    vals, ids = [], []
    for s0 in range(0, n, chunk):
        s = score_slab(s0, min(s0 + chunk, n))
        v, loc = topk_lowest_index(s, min(k, s.shape[1]))
        loc = loc.long()
        i = (s0 + loc if doc_ids is None
             else doc_ids[s0:s0 + chunk][loc]).to(torch.int32)
        is_pad = i < 0
        if pad_from is not None:
            is_pad = is_pad | (i >= pad_from)
        vals.append(torch.where(is_pad, -torch.inf, v))
        ids.append(i)
    return torch.cat(vals, dim=1), torch.cat(ids, dim=1)


def _stream_knobs(n_docs: int, m: int, q_embs, k: int, *, block_docs,
                  chunk_docs, codec, n_shards: int = 1, n_groups: int = 1,
                  replicas: int = 1) -> tuple:
    """The streaming sweep's knobs over one bucket of ``n_docs`` docs of
    capacity ``m`` (the bucket's global count; the tuner sizes the
    shard-local slice): ``(block_docs, chunk_docs, short_block)``.
    The tuned doc block is sized for a full slab; ``short_block``, the
    block of a shorter last slab, is the caller's pin or ``None`` (the
    launchers' rule at that slab's size).  Explicit values win."""
    bd, cd = backend_lib.tuned_streaming_blocks(
        q_embs.shape[0], n_docs, m, q_embs.shape[1], q_embs.shape[-1], k,
        n_shards=n_shards, n_groups=n_groups, replicas=replicas,
        block_docs=block_docs, chunk_docs=chunk_docs, codec=codec,
        device=q_embs.device)
    return bd, cd, block_docs


def _chunk_candidates(embs, masks, doc_ids, q_embs, q_masks, k: int, *,
                      backend, knobs, pad_from: int | None = None,
                      owner=None, leaf: int = 0):
    """One doc array's exact-MaxSim candidates through the streaming
    reduce loop, in ``knobs`` (:func:`_stream_knobs`): slabs of
    ``chunk_docs``, the last one shorter where the array does not divide.

    ``owner``/``leaf`` is the mutation stale mask (:class:`MutationView`):
    slab scores of docs this leaf does not own — a base copy shadowed by
    an upsert, a tombstoned doc — are forced to -inf BEFORE the slab's
    top-k reduction, so a stale copy never crowds a live doc out of its
    bucket's k candidate slots.  ``pad_from`` marks shard pad ids (see
    :func:`_stream_chunk_topk`).  The clip guards sentinel ids (< 0,
    forced to -inf by the pad audit regardless) against wraparound."""

    block_docs, chunk_docs, short_block = knobs
    full = min(chunk_docs, masks.shape[0])

    def slab(a, b):
        s = _score_block(embs[a:b], masks[a:b], q_embs, q_masks,
                         backend=backend,
                         block_docs=block_docs if b - a == full
                         else short_block)
        if owner is not None:
            ids = (torch.arange(a, b, device=s.device) if doc_ids is None
                   else doc_ids[a:b].long())
            own = owner[ids.clamp(0, owner.shape[0] - 1)]
            s = torch.where((own != leaf)[None, :], -torch.inf, s)
        return s

    return _stream_chunk_topk(masks.shape[0], chunk_docs, k, slab,
                              doc_ids=doc_ids, pad_from=pad_from)


def _index_views(index, backend):
    """Per-bucket (embs, masks, doc_ids) views; ``doc_ids=None`` means
    the axis is already in global doc order (dense layout).  A bucket
    with no documents has no view (the reference's one all-masked pad
    row would add only (-inf, -1) candidates)."""
    if not isinstance(index, PackedIndex):
        return [(index.d_embs, index.active_mask, None)]
    return [(_bucket_array(index, b, backend), b.masks, b.doc_ids)
            for b in index.buckets if b.n_docs]


def _real_docs(index) -> int:
    if isinstance(index, PackedIndex):
        return sum(b.n_docs for b in index.buckets)
    return index.d_masks.shape[0]


def _empty_topk(q_embs):
    n_q = q_embs.shape[0]
    return (torch.zeros((n_q, 0), dtype=torch.int32, device=q_embs.device),
            torch.zeros((n_q, 0), device=q_embs.device))


def _bucket_view(index, bucket_ids):
    """The slice of ``index`` holding exactly ``bucket_ids`` (ascending):
    a PackedIndex of those buckets (doc ids and ``n_docs`` stay
    corpus-global), the whole index for the dense layout's single
    bucket, or ``None`` for an empty selection."""
    if isinstance(index, PackedIndex):
        picked = [index.buckets[i] for i in bucket_ids]
        if not picked:
            return None
        return PackedIndex(n_docs=index.n_docs, m=index.m, dim=index.dim,
                           tokens_total=index.tokens_total,
                           compression=index.compression, buckets=picked,
                           epoch=index.epoch,
                           residual_bits=index.residual_bits)
    return index if bucket_ids else None


@dataclasses.dataclass(frozen=True)
class MutationView:
    """The serving view of a live delta log (``serve.mutation``): the
    extra leaves :func:`topk_search`'s merge scores beside the packed
    base index.

    ``deltas`` are small :class:`PackedIndex` es (one per absorbed upsert
    batch, scored by the unmodified ``colbert_maxsim`` kernels).
    ``owner`` maps every corpus-global doc id to the single *leaf*
    holding its current version — 0 for the base index, ``i + 1`` for
    delta ``i``, ``-1`` for a tombstoned or absent doc — as int32 on the
    scoring device.  ``n_live`` (live docs) replaces the real-doc count
    as the output-width clamp."""

    deltas: tuple
    owner: torch.Tensor           # (n_total,) int32; -1 = dead
    n_live: int


def _topk_local(index, q_embs, q_masks, k: int, *, backend, block_docs,
                chunk_docs, mutation=None, real_cap=None):
    """Every bucket's streaming candidates, root-merged; capped at the
    real documents of ``index`` (``real_cap`` where given; the live
    docs under ``mutation``) so no sentinel fills a column.  Under
    ``mutation`` the deltas are leaves 1.. beside ``index`` (leaf 0; an
    empty routed selection is ``None``), each masked by the owner map,
    and the root merge dedupes ids."""
    leaves = [] if index is None else [(index, 0)]
    owner = None
    if mutation is not None:
        leaves += [(d, i + 1) for i, d in enumerate(mutation.deltas)]
        owner = mutation.owner
    vals, ids = [], []
    for leaf_index, leaf in leaves:
        codec = _codec_of(leaf_index)
        for e, mk, di in _index_views(leaf_index, backend):
            knobs = _stream_knobs(mk.shape[0], mk.shape[1], q_embs, k,
                                  block_docs=block_docs,
                                  chunk_docs=chunk_docs, codec=codec)
            v, i = _chunk_candidates(e, mk, di, q_embs, q_masks, k,
                                     backend=backend, knobs=knobs,
                                     owner=owner, leaf=leaf)
            vals.append(v)
            ids.append(i)
    if not vals:
        return _empty_topk(q_embs)
    vals = torch.cat(vals, dim=1)
    ids = torch.cat(ids, dim=1)
    if real_cap is None:
        real_cap = (_real_docs(index) if mutation is None
                    else mutation.n_live)
    k = min(k, real_cap, vals.shape[1])
    if mutation is None:
        return _merge_topk(vals, ids, k)
    return _merge_topk_unique(vals, ids, k)


# ----------------------------------------------------------------------
# Sharded and grid serving (the reference's shard_map merge and grid
# tier, driven from one process).  Under ``sharding.serve_rules(mesh)``
# each capacity bucket's doc axis splits into equal shards
# (``PackedBucket.shard_view``), each placed on its device once per
# index epoch (:func:`_shards`); every shard reduces its docs to an
# (n_q, k) candidate block on its own device, and only those blocks are
# copied to the root device (the queries' device) for the root merge —
# the reference's k-wide all-gather.  A ``hosts x candidates`` grid adds
# one tier: each host group merges the buckets its PlacementPlan pins to
# it over its row of devices, and one (n_q, k) block per group crosses
# to the root.  Every merge orders on (-score, id) and every tier keeps
# a superset of the global top-k, so the answer equals the
# single-device one bit for bit: a doc's score does not depend on which
# docs share its shard or slab.
# ----------------------------------------------------------------------


def _dense_bucket(index: TokenIndex) -> PackedBucket:
    """The dense layout as one bucket (ids in corpus order), so it shards
    through :meth:`PackedBucket.shard_view` like a packed bucket."""
    n_docs, m = index.d_masks.shape
    return PackedBucket(cap=m, doc_ids=torch.arange(
        n_docs, dtype=torch.int32, device=index.device),
        masks=index.active_mask, embs=index.d_embs)


def _shards(index, b: int, devices: tuple) -> tuple:
    """Bucket ``b`` of ``index`` (the dense layout's one bucket for 0)
    cut into ``len(devices)`` equal shards, shard ``s`` as (embs, masks,
    doc_ids) on ``devices[s]``.  Placed once per (bucket, devices) and
    cached on the index, so once an epoch: warm-up, healthy serving and
    failover read one placement, and a bucket reaches a device once.  On
    the index's own device a shard views the bucket (pad rows aside)."""
    key = (b, devices)
    got = index._shards.get(key)
    if got is None:
        with index._views_lock:
            got = index._shards.get(key)
            if got is None:
                packed = isinstance(index, PackedIndex)
                bucket = index.buckets[b] if packed else _dense_bucket(index)
                dim = index.dim if packed else index.d_embs.shape[-1]
                got = index._shards[key] = tuple(
                    tuple(t.to(dev) for t in bucket.shard_view(
                        dim, len(devices), _n_docs(index), shard=s))
                    for s, dev in enumerate(devices))
    return got


def _bucket_ids(index, bucket_ids=None) -> tuple:
    """``bucket_ids`` (all by default), or the dense layout's one bucket
    whatever they are."""
    if not isinstance(index, PackedIndex):
        return (0,)
    return tuple(range(len(index.buckets)) if bucket_ids is None
                 else bucket_ids)


def _bucket_shape(index, b: int) -> tuple[int, int]:
    """(docs, capacity) of bucket ``b`` (the dense layout's for 0)."""
    if isinstance(index, PackedIndex):
        return index.buckets[b].n_docs, index.buckets[b].cap
    return tuple(index.d_masks.shape)


def _placed(index, devices, bucket_ids=None) -> list:
    """Shard ``s`` of every bucket of ``bucket_ids`` (all by default; the
    dense layout's one bucket whatever they are) on ``devices[s]``: one
    list of (embs, masks, doc_ids) views a device (:func:`_shards`)."""
    devices = tuple(devices)
    shards = [_shards(index, b, devices)
              for b in _bucket_ids(index, bucket_ids)]
    return [[sh[s] for sh in shards] for s in range(len(devices))]


def _topk_search_sharded(index, q_embs, q_masks, k: int, *, backend,
                         block_docs, chunk_docs, devices, bucket_ids=None,
                         root=None, n_groups: int = 1, replicas: int = 1):
    """The sharded merge over ``devices`` (of ``bucket_ids``, all by
    default): each shard's (n_q, k) block is computed on its device
    (sentinel-padded to k columns where the shard holds fewer
    candidates), all shards launched before any block is read; the
    blocks are copied to ``root`` (the queries' device by default) and
    merged there.  Returns (ids, scores), each (n_q, min(k, n_docs)).
    The flat mesh's streaming top-k (``--mesh host``) and one host
    group's tier of the grid (``n_groups`` and ``replicas`` key the
    tuner, per bucket over ``len(devices)`` shards)."""
    n_docs = _n_docs(index)
    placed = _placed(index, devices, bucket_ids)
    codec = _codec_of(index)
    knobs = [_stream_knobs(*_bucket_shape(index, b), q_embs, k,
                           block_docs=block_docs, chunk_docs=chunk_docs,
                           codec=codec, n_shards=len(devices),
                           n_groups=n_groups, replicas=replicas)
             for b in _bucket_ids(index, bucket_ids)]
    on = {}
    blocks = []
    for dev, views in zip(devices, placed):
        if dev not in on:
            on[dev] = (q_embs.to(dev),
                       None if q_masks is None else q_masks.to(dev))
        q, qm = on[dev]
        vals, ids = [], []
        for (e, mk, di), kn in zip(views, knobs):
            v, i = _chunk_candidates(e, mk, di, q, qm, k, backend=backend,
                                     knobs=kn, pad_from=n_docs)
            vals.append(v)
            ids.append(i)
        vals, ids = torch.cat(vals, dim=1), torch.cat(ids, dim=1)
        kl = min(k, vals.shape[1])
        i, v = _merge_topk(vals, ids, kl)
        if kl < k:          # k above the shard's docs: a square block
            i = torch.cat([i, i.new_full((i.shape[0], k - kl), n_docs)], 1)
            v = torch.cat([v, v.new_full((v.shape[0], k - kl), -torch.inf)],
                          1)
        blocks.append((i, v))
    root = q_embs.device if root is None else root
    return _merge_topk(torch.cat([v.to(root) for _, v in blocks], dim=1),
                       torch.cat([i.to(root) for i, _ in blocks], dim=1),
                       min(k, n_docs))


def _group_view(index, placement: PlacementPlan, group: int):
    """The slice of ``index`` host group ``group`` stores (every bucket
    with ``group`` in its replica chain), or ``None``."""
    return _bucket_view(index, placement.buckets_of(group))


def _resolve_placement(index, placement: PlacementPlan | None,
                       n_groups: int) -> PlacementPlan:
    """``placement`` checked against the grid and the index, or the
    bytes-balanced default for a whole index; a partial (group-loaded)
    view without an explicit placement raises."""
    n_buckets = (len(index.buckets) if isinstance(index, PackedIndex)
                 else 1)
    if placement is None:
        covered = _real_docs(index)
        if covered < _n_docs(index):
            raise ValueError(
                f"index is a partial (group-loaded) view covering "
                f"{covered} of {_n_docs(index)} documents; pass an "
                "explicit placement (e.g. PlacementPlan(n_groups, "
                "(group,) * n_buckets)) instead of relying on the derived "
                "default")
        return PlacementPlan.for_index(index, n_groups)
    if placement.n_groups != n_groups:
        raise ValueError(
            f"placement has {placement.n_groups} host groups, the active "
            f"grid mesh has {n_groups}")
    return placement.validate(n_buckets)


def topk_search_group(index, q_embs, *, group: int, k: int = 10,
                      q_masks=None, backend: str | None = None,
                      placement: PlacementPlan | None = None,
                      buckets: tuple | None = None,
                      block_docs: int | None = None,
                      chunk_docs: int | None = None):
    """One host group's tier of the grid merge tree: ``(ids, scores)``,
    each ``(n_q, min(k, n_docs))``, on the group's first device, from
    the buckets the placement pins to ``group``, merged over the group's
    row of the active grid; sentinel-padded (-inf scores, ids -1 or
    ``n_docs``) where the group holds fewer candidates, a group with no
    bucket included.  ``buckets`` narrows the group to some of its
    stored buckets (the failover hook); each must be in the group's
    replica chain.  Needs active grid rules
    (``sharding.serve_rules`` of ``launch.mesh.make_serve_mesh(hosts=...)``).
    The launches are asynchronous: the block has arrived nowhere until
    the caller copies it (the grid exchange)."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    mesh, n_groups, _, rules_placement = grid_axes_for()
    if mesh is None:
        raise ValueError(
            "topk_search_group needs active grid serving rules "
            "(sharding.serve_rules with a hosts x candidates mesh from "
            "launch.mesh.make_serve_mesh(hosts=...))")
    if not 0 <= group < n_groups:
        raise ValueError(f"group {group} outside [0, {n_groups})")
    placement = _resolve_placement(
        index, placement if placement is not None else rules_placement,
        n_groups)
    if buckets is None:
        bucket_ids = placement.buckets_of(group)
    else:
        for b in buckets:
            if group not in placement.replicas_of(b):
                raise ValueError(
                    f"bucket {b} is not stored on group {group} (replica "
                    f"chain {placement.replicas_of(b)}) — failover may "
                    "only target groups that hold a replica")
        bucket_ids = tuple(sorted(buckets))
    devices = mesh.devices_along(("candidates",), hosts=group)
    w = min(k, _n_docs(index))
    if not bucket_ids:
        n_q = q_embs.shape[0]
        return (torch.full((n_q, w), -1, dtype=torch.int32,
                           device=devices[0]),
                torch.full((n_q, w), -torch.inf, device=devices[0]))
    return _topk_search_sharded(index, q_embs, q_masks, k, backend=backend,
                                block_docs=block_docs, chunk_docs=chunk_docs,
                                devices=devices, bucket_ids=bucket_ids,
                                root=devices[0], n_groups=n_groups,
                                replicas=placement.replicas)


def _arrive(block, root):
    """A group's candidate block copied to the root device, returned
    once it is there (the host waits on the root's stream): what the
    exchange deadline times."""
    out = tuple(t.to(root) for t in block)
    if root.type == "cuda":
        torch.cuda.current_stream(root).synchronize()
    return out


def _serving_assignment(placement: PlacementPlan, buckets, live, tried):
    """Route each of ``buckets`` to the first live group of its replica
    chain not tried for it yet: (``{group: (buckets,)}`` in ascending
    group order, the buckets with every replica exhausted)."""
    per: dict = {}
    lost = []
    for b in buckets:
        g = next((g for g in placement.replicas_of(b)
                  if g in live and g not in tried[b]), None)
        if g is None:
            lost.append(b)
        else:
            per.setdefault(g, []).append(b)
    return {g: tuple(bs) for g, bs in sorted(per.items())}, lost


def _topk_search_grid(index, q_embs, q_masks, k: int, *, backend, mesh,
                      n_groups, placement, block_docs, chunk_docs,
                      monitor=None,
                      faults=None, selected=None, route_stats=None):
    """The grid merge tree: every host group reduces its buckets to an
    (n_q, w) block on its devices (:func:`topk_search_group`), the
    blocks are exchanged to the root device — the only cross-group
    traffic, k wide — and one root merge gives the top-k; bit-equal to
    the single-device answer.  Each bucket is served once, by the first
    live group of its replica chain (the first group without a
    monitor), which stores it placed already (:func:`_shards`).

    With a :class:`~repro_torch.serve.health.FleetMonitor` the exchange
    tolerates faults: a failed or deadline-overrunning fetch strikes
    the group (``max_strikes`` strikes demote it) and its buckets fail
    over, after a bounded backoff, to their next live replica.  Buckets
    with every replica down drop out and the :class:`TopKResult`
    reports ``coverage < 1``, exact over what it covers.  A fetch is
    done only when its block is on the root device (:func:`_arrive`),
    so the deadline times the group's compute and its copy.  A
    :class:`~repro_torch.serve.health.FaultPlan` injects kills and
    delays at the dispatch and exchange seams.  Without a monitor a
    fault propagates (``GroupFailure``).

    ``selected`` (the router's bucket shortlist) restricts the tree to
    those buckets; a group serving none is neither dispatched nor counted against coverage.
    ``route_stats`` receives the consulted groups."""
    placement = _resolve_placement(index, placement, n_groups)
    if faults is not None:
        faults.begin_round()
    root = q_embs.device
    n_docs = _n_docs(index)

    def dispatch(group, bucket_ids):
        if faults is not None:
            faults.check(group, "dispatch")
        return topk_search_group(
            index, q_embs, group=group, k=k, q_masks=q_masks,
            backend=backend, placement=placement, buckets=bucket_ids,
            block_docs=block_docs, chunk_docs=chunk_docs)

    def fetch(group, block):
        if faults is not None:
            faults.check(group, "exchange")
        return _arrive(block, root)

    def attempt(group, bucket_ids):
        """One group's dispatch and deadline-bounded fetch under the
        monitor, with up to ``monitor.retries`` retries; the block, or
        None after striking the group."""
        for r in range(monitor.retries + 1):
            if r:
                time.sleep(monitor.backoff(r - 1))
            try:
                block = dispatch(group, bucket_ids)
                t0 = time.perf_counter()
                if monitor.exchange_timeout is None:
                    got = fetch(group, block)
                else:
                    ex = concurrent.futures.ThreadPoolExecutor(1)
                    try:
                        got = ex.submit(fetch, group, block).result(
                            timeout=monitor.exchange_timeout)
                    finally:
                        # no wait: a straggler must not extend the
                        # deadline it just blew
                        ex.shutdown(wait=False)
                monitor.record_exchange(group, time.perf_counter() - t0)
                return got
            except (health_lib.GroupFailure,
                    concurrent.futures.TimeoutError):
                monitor.strike(group)
        return None

    weights = bucket_weights(index)
    all_buckets = (range(placement.n_buckets) if selected is None
                   else selected)
    tried = {b: set() for b in all_buckets}
    live = range(n_groups) if monitor is None else monitor.live()
    pending, lost = _serving_assignment(placement, all_buckets, live, tried)
    answered, blocks, consulted, failover = [], [], set(), 0
    while pending:
        for g, bs in pending.items():
            for b in bs:
                tried[b].add(g)
            consulted.add(g)
        if monitor is None:
            # no deadline: launch every group before fetching any block;
            # a fault raises
            launched = {g: dispatch(g, bs) for g, bs in pending.items()}
            results = {g: fetch(g, blk) for g, blk in launched.items()}
        elif len(pending) == 1:
            results = {g: attempt(g, bs) for g, bs in pending.items()}
        else:
            # one worker a pending group, so a straggler costs the
            # slowest group's time, not the sum; rules are thread-local,
            # so each worker runs under the caller's
            rules = current_rules() or {}

            def ruled_attempt(group, bucket_ids):
                with axis_rules(rules):
                    return attempt(group, bucket_ids)

            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=len(pending)) as pool:
                futs = {g: pool.submit(ruled_attempt, g, bs)
                        for g, bs in pending.items()}
                results = {g: f.result() for g, f in futs.items()}
        failed = []
        for g, bs in pending.items():
            if results[g] is None:
                failed.extend(bs)
            else:
                blocks.append(results[g])
                answered.extend(bs)
        if not failed:
            break
        pending, dead = _serving_assignment(placement, failed,
                                            monitor.live(), tried)
        lost.extend(dead)
        if pending:
            time.sleep(monitor.backoff(failover))
            failover += 1

    if selected is not None and route_stats is not None:
        route_stats.update(groups_consulted=len(consulted),
                           n_groups=n_groups)
    denom = sum(weights[b] for b in all_buckets)
    coverage = sum(weights[b] for b in answered) / max(denom, 1)
    live_docs = (sum(index.buckets[b].n_docs for b in answered)
                 if isinstance(index, PackedIndex)
                 else (n_docs if answered else 0))
    cap = min(k, live_docs)
    if not blocks or cap == 0:
        empty = _empty_topk(q_embs)
        return TopKResult(empty[0], empty[1], coverage)
    # each bucket was served by one group, so the ids are unique; the cap
    # at the answered docs keeps sentinels out of a degraded answer
    i, v = _merge_topk(torch.cat([v for _, v in blocks], dim=1),
                       torch.cat([i for i, _ in blocks], dim=1), cap)
    return TopKResult(i, v, coverage)


def _topk_search_routed(index, q_embs, q_masks, k: int, *, backend,
                        block_docs, chunk_docs, route, routing, n_probe,
                        route_threshold, route_stats, mutation=None,
                        gmesh=None, n_groups=1, placement=None, devices=None,
                        monitor=None, faults=None):
    """The candidate-routing tier in front of the merge (see
    :func:`topk_search`).  The centroid pass runs on the device in one
    sweep; the (n_q, n_buckets) scores and bounds come to the host,
    where the shortlist is chosen before any bucket is scored — under a
    grid before group dispatch (``gmesh``), so a group owning no
    selected bucket is not consulted; on a flat mesh (``devices``) the
    selected buckets shard over it.  Under ``mutation`` every delta leaf
    joins the routed base, scored exhaustively (the table knows nothing
    of fresh upserts)."""
    from repro_torch.serve import routing as routing_lib

    routing_lib.check_route(route, routing, index, n_probe)
    probe = 1 if n_probe is None else int(n_probe)
    s, u = routing_lib.centroid_scores(routing, q_embs, q_masks,
                                       backend=backend)
    s_host, u_host = s.cpu().numpy(), u.cpu().numpy()

    delta_real = (0 if mutation is None
                  else sum(_real_docs(d) for d in mutation.deltas))

    def run(bucket_ids, stats=None):
        bucket_ids = tuple(bucket_ids)
        if gmesh is not None:
            return _topk_search_grid(
                index, q_embs, q_masks, k, backend=backend, mesh=gmesh,
                n_groups=n_groups, placement=placement,
                block_docs=block_docs, chunk_docs=chunk_docs,
                monitor=monitor, faults=faults, selected=bucket_ids,
                route_stats=stats)
        view = _bucket_view(index, bucket_ids)
        if view is None and mutation is None:
            return _empty_topk(q_embs)
        if devices is not None:
            i, v = _topk_search_sharded(
                index, q_embs, q_masks, k, backend=backend,
                block_docs=block_docs, chunk_docs=chunk_docs,
                devices=devices, bucket_ids=bucket_ids)
            # the sharded root caps at the corpus; the selection may
            # hold fewer docs, whose surplus columns are sentinels
            cap = min(k, _real_docs(view))
            return i[:, :cap], v[:, :cap]
        real_cap = None
        if mutation is not None:
            base_real = 0 if view is None else _real_docs(view)
            real_cap = min(base_real + delta_real, mutation.n_live)
        return _topk_local(view, q_embs, q_masks, k, backend=backend,
                           block_docs=block_docs, chunk_docs=chunk_docs,
                           mutation=mutation, real_cap=real_cap)

    if route == "nprobe":
        selected, _ = routing_lib.select_nprobe(s_host, probe,
                                                route_threshold)
    else:               # bounded: seed search -> admissible-bound filter
        seeds, _ = routing_lib.select_nprobe(s_host, probe)
        sv = run(seeds)[1].cpu().numpy()
        # each query's k-th seed score is a valid bar only when the
        # seeds held k candidates; -inf (keep everything) otherwise
        tau = (sv[:, k - 1] if sv.shape[1] >= k
               else np.full((sv.shape[0],), -np.inf, np.float32))
        selected = routing_lib.select_bounded(u_host, tau, seeds)
    out = run(selected, route_stats)
    if route_stats is not None:
        nb = routing.n_buckets
        route_stats.update(route=route, n_buckets=nb,
                           buckets_scored=len(selected),
                           fraction=len(selected) / max(nb, 1))
    return out


def topk_search(index, q_embs, *, k: int = 10, q_masks=None,
                backend: str | None = None, block_docs: int | None = None,
                chunk_docs: int | None = None,
                route: str = "exhaustive", routing=None,
                n_probe: int | None = None,
                route_threshold: float | None = None,
                route_stats: dict | None = None,
                mutation: MutationView | None = None,
                placement: PlacementPlan | None = None, monitor=None,
                faults=None):
    """Streaming exact top-k MaxSim: ``(top_idx, top_scores)``, each
    (n_q, min(k, n_docs)), equal to the (-score, id)-ordered top-k of
    :func:`maxsim_scores` without ever holding an (n_q, n_docs) score
    matrix.  ``block_docs`` (the kernels' doc block) and ``chunk_docs``
    (the slab a merge step scores) default to the autotuner's, per
    bucket (``backend.tuned_streaming_blocks``).

    ``route`` is the candidate-routing tier (``serve/routing.py``):
    ``"exhaustive"`` (default) sweeps every bucket; ``"nprobe"`` and
    ``"bounded"`` score ``routing`` (a ``RoutingIndex`` built for THIS
    index epoch) against the queries first and sweep only the
    shortlisted buckets.  ``"nprobe"`` keeps each query's ``n_probe``
    (default 1) best centroid-MaxSim buckets, optionally trimmed by the
    ``route_threshold`` score gap; ``"bounded"`` scores the ``n_probe``
    seed buckets, then keeps every bucket whose upper bound still
    reaches some query's k-th seed score — the same ids and scores as
    the exhaustive sweep.  ``route_stats`` (a dict) receives the
    buckets scored against the total.

    ``mutation`` (a :class:`MutationView` of ``serve.mutation``) scores
    the live delta buckets as extra leaves and masks shadowed and
    tombstoned doc ids to -inf before each slab's reduction — equal, bit
    for bit, to re-packing the mutated corpus from scratch.  Output
    columns are capped at the live docs; none live gives (n_q, 0).
    Under a routed mode the deltas are scored in full.

    Under ``sharding.serve_rules(mesh)`` the sweep runs over the mesh:
    on the flat host mesh every bucket shards over the ``model`` axis
    (:func:`_topk_search_sharded`); on a ``hosts x candidates`` grid
    each host group serves the buckets its placement pins to it and one
    (n_q, k) block a group is exchanged (:func:`_topk_search_grid`).
    Both give the single-device answer bit for bit.  ``placement``
    overrides the rules' plan (the rebalance hook); ``monitor`` (a
    ``serve.health.FleetMonitor``) makes the grid exchange
    fault-tolerant, and the result a :class:`TopKResult` whose
    ``coverage`` is the share of stored bucket bytes answered;
    ``faults`` (a ``serve.health.FaultPlan``) injects failures.  These
    three are grid-only.  Mutation serving is single-device and raises
    under a mesh."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    if mutation is not None and mutation.n_live == 0:
        return _empty_topk(q_embs)
    if _n_docs(index) == 0 and mutation is None:
        return _empty_topk(q_embs)
    gmesh, n_groups, _, rules_placement = grid_axes_for()
    mesh, axes, n_shards = mesh_axes_for("candidates")
    devices = None if mesh is None else mesh.devices_along(axes)
    if mutation is not None and (gmesh is not None or devices is not None):
        raise ValueError(
            "mutation serving (delta buckets + tombstones) is "
            "single-device: compact the delta log "
            "(serve.mutation.Compactor) before serving under a "
            "candidates mesh or grid placement")
    placement = placement if placement is not None else rules_placement
    if route != "exhaustive":
        return _topk_search_routed(
            index, q_embs, q_masks, k, backend=backend,
            block_docs=block_docs, chunk_docs=chunk_docs, route=route,
            routing=routing,
            n_probe=n_probe, route_threshold=route_threshold,
            route_stats=route_stats, mutation=mutation, gmesh=gmesh,
            n_groups=n_groups, placement=placement,
            devices=None if gmesh is not None else devices,
            monitor=monitor, faults=faults)
    if gmesh is not None:
        return _topk_search_grid(
            index, q_embs, q_masks, k, backend=backend, mesh=gmesh,
            n_groups=n_groups, placement=placement, block_docs=block_docs,
            chunk_docs=chunk_docs, monitor=monitor, faults=faults)
    if devices is not None:
        return _topk_search_sharded(
            index, q_embs, q_masks, k, backend=backend,
            block_docs=block_docs, chunk_docs=chunk_docs, devices=devices)
    return _topk_local(index, q_embs, q_masks, k, backend=backend,
                       block_docs=block_docs, chunk_docs=chunk_docs,
                       mutation=mutation)


# Query rows a first-stage product takes at once.  Every block has this
# many rows (zero-padded), so the BLAS picks one kernel whatever the
# batch size, and a query's pooled scores are the same bits alone or
# among batchmates: the serving loop's contract (a demuxed answer equals
# that query served alone).  An unblocked (64 x 128) x (128 x 128) fp32
# product gives every row other bits than the query alone on the H100's
# cuBLAS and on the CPU's MKL (chip_smoke's [loop] logs the count).
FIRST_STAGE_ROWS = 64


def _pooled_query_blocks(q_embs):
    """The mean-pooled queries in zero-padded blocks of
    ``FIRST_STAGE_ROWS`` rows (a list of (rows, dim) tensors)."""
    n_q, rows = q_embs.shape[0], FIRST_STAGE_ROWS
    blocks = []
    for r in range(0, n_q, rows):
        block = q_embs.new_zeros((rows,) + q_embs.shape[1:])
        block[:min(rows, n_q - r)] = q_embs[r:r + rows]
        blocks.append(block.mean(1))
    return blocks


def _first_stage_scores(q_blocks, pooled, n_q: int):
    """(n_q, n_docs) pooled single-vector scores of ``n_q`` queries held
    in :func:`_pooled_query_blocks`' blocks: one product a block, so
    each row's bits do not depend on its batchmates."""
    return torch.cat([qb @ pooled.T for qb in q_blocks])[:n_q]


def _streaming_first_stage(index, q_embs, n_first: int):
    """Chunked first stage: pooled single-vector scores stream through
    the same sort-merge, so no (n_q, n_docs) matrix is held.  Candidate
    ids come back in (-score, id) order."""
    pooled = index.pooled()                           # (n_docs, dim)
    q_blocks = _pooled_query_blocks(q_embs)
    chunk = max(64, _pow2_at_least(2 * n_first))
    vals, ids = _stream_chunk_topk(
        pooled.shape[0], chunk, n_first,
        lambda a, b: _first_stage_scores(q_blocks, pooled[a:b],
                                         q_embs.shape[0]))
    cand, _ = _merge_topk(vals, ids, n_first)
    return cand


def _gather_view(index):
    if isinstance(index, PackedIndex):
        return index.padded()
    return index.d_embs, index.active_mask


def _rerank_candidates(index, q_embs, q_masks, cand, *, backend):
    """Exact MaxSim of each query against its own candidates; the gather
    is the index lookup, only the scoring differs per backend (one
    rerank-kernel launch for all queries on ``fused``).  A residual
    index on ``fused`` gathers COMPRESSED rows and each row's bucket
    number; the residual rerank kernel decodes per tile against the
    codebook table, and the fp32 ``padded()`` scratch is never built."""
    c = cand.long()
    if _decodes_in_kernel(index, backend):
        codes, resq, bucket_of, g_masks, cbs, scales = (
            index.padded_residual())
        return colbert_maxsim_residual_rerank_op(
            q_embs, codes[c], resq[c], scales[c], cbs, bucket_of[c],
            g_masks[c], q_masks, bits=index.residual_bits)
    g_embs, g_masks = _gather_view(index)
    d_sub = g_embs[c]                                 # (n_q, n_first, m, dim)
    m_sub = g_masks[c]
    if backend == backend_lib.FUSED:
        return colbert_maxsim_rerank_op(q_embs, d_sub, m_sub, q_masks)
    return colbert_maxsim_rerank_ref(q_embs, d_sub, m_sub, q_masks)


def search(index, q_embs, *, k: int = 10, n_first: int = 64,
           end_to_end: bool = False, q_masks=None,
           backend: str | None = None, block_docs: int | None = None,
           chunk_docs: int | None = None,
           return_full: bool = True, route: str = "exhaustive",
           routing=None, n_probe: int | None = None,
           route_threshold: float | None = None,
           route_stats: dict | None = None,
           mutation: MutationView | None = None,
           placement: PlacementPlan | None = None, monitor=None,
           faults=None):
    """Two-stage (or e2e) retrieval.  ``return_full=True`` returns
    (top_idx, top_scores, full) with the densified (n_q, n_docs) score
    matrix (the metrics contract: non-candidates score -1e30);
    ``return_full=False`` (the serving default) returns (top_idx,
    top_scores) and streams — e2e through :func:`topk_search`, two-stage
    through the chunked first stage.  Results are identical.  A routed
    ``route``, a ``mutation`` view and the mesh arguments
    (``placement``, ``monitor``, ``faults``; see :func:`topk_search`)
    apply to the streaming e2e route only.
    Under a mesh the two-stage route runs on the index's device, as the
    reference's does in effect: its pooled first stage carries a
    sharding hint only (``sharding.constrain``, the identity here), and
    the rerank gathers its candidates on the root."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    n_docs = _n_docs(index)
    if mutation is not None and not (end_to_end or n_first >= n_docs):
        raise ValueError(
            "mutation serving routes through the streaming e2e path "
            "only (the two-stage pooled first stage would consult "
            "stale base vectors); pass end_to_end=True or "
            "n_first >= n_docs")
    if mutation is not None and return_full:
        raise ValueError("mutation serving is streaming-only; "
                         "return_full=False required")
    if route != "exhaustive":
        if return_full:
            raise ValueError("routed serving is streaming-only; "
                             "return_full=False required")
        if not (end_to_end or n_first >= n_docs):
            raise ValueError(
                "candidate routing applies to the streaming e2e route "
                "only (the two-stage pooled first stage is its own "
                "shortlist); pass end_to_end=True")
    if end_to_end or n_first >= n_docs:
        if not return_full:
            return topk_search(index, q_embs, k=k, q_masks=q_masks,
                               backend=backend, block_docs=block_docs,
                               chunk_docs=chunk_docs,
                               route=route, routing=routing,
                               n_probe=n_probe,
                               route_threshold=route_threshold,
                               route_stats=route_stats, mutation=mutation,
                               placement=placement, monitor=monitor,
                               faults=faults)
        scores = maxsim_scores(index, q_embs, q_masks, backend=backend,
                               block_docs=block_docs)
        top_scores, top_idx = topk_lowest_index(scores, k)
        return top_idx, top_scores, scores
    if not return_full:
        cand = _streaming_first_stage(index, q_embs, n_first)
    else:
        first = _first_stage_scores(_pooled_query_blocks(q_embs),
                                    index.pooled(), q_embs.shape[0])
        _, cand = topk_lowest_index(first, n_first)
    rerank = _rerank_candidates(index, q_embs, q_masks, cand,
                                backend=backend)
    top_scores, local = topk_lowest_index(rerank, min(k, n_first))
    top_idx = cand.gather(1, local.long())
    if not return_full:
        return top_idx, top_scores
    full = torch.full((q_embs.shape[0], n_docs), NEG_INF,
                      dtype=rerank.dtype, device=rerank.device)
    full.scatter_(1, cand.long(), rerank)
    return top_idx, top_scores, full


class RetrievalServer:
    """Batched request serving over a pruned index (either layout).

    ``backend`` is resolved once at construction from the index's
    device.  Serving runs ``search(..., return_full=False)``.  One
    closure is kept per (n_q, l) batch shape and server state in a small
    lock-guarded LRU (``max_cached_closures``); a cache miss parks
    concurrent same-shape callers on the builder's future.  Queries run
    inside a read gate that :meth:`swap_index` and :meth:`apply_mutation`
    close: they drain in-flight queries, bump the mutation generation
    and drop every closure, so each answer is attributable to one
    ``epoch_key`` snapshot ``(generation, mutation_gen, index.epoch)``.
    A server with a live :class:`MutationView` serves the streaming e2e
    sweep.

    ``route``/``routing``/``n_probe``/``route_threshold`` serve through
    the candidate-routing tier (see :func:`topk_search`); a routed
    server always takes the streaming e2e sweep.  The table is checked
    against the index here, and :meth:`swap_index` needs the new
    epoch's table.

    Meshes: a closure serves under the sharding rules active when it
    was built (``sharding.serve_rules(mesh)``), and the mesh, its axes,
    the grid's placement and the rebalance override join its key, so a
    closure built without a mesh never answers inside one, nor one
    built on one device a grid.  Building a closure places the index's
    shards on their devices (once per epoch; ``_shards``).  On a grid,
    ``monitor`` (a ``serve.health.FleetMonitor``) and ``faults`` (a
    ``serve.health.FaultPlan``) make the exchange fault-tolerant, and
    ``on_group_loss`` picks what happens when every replica of some
    buckets is gone: ``"degrade"`` answers from the rest with
    ``coverage < 1``; ``"rebalance"`` re-places the lost groups'
    buckets over the survivors (``PlacementPlan.rebalance``; this one
    process holds the whole index) and answers the same query again at
    full coverage; ``"fail"`` raises ``serve.health.DegradedCoverage``.

    ``block_docs`` and ``chunk_docs`` pin the streaming sweep's knobs;
    ``None`` takes the autotuner's, every key resolved when a batch
    shape's closure is built (``_warm_tuner``), before it serves.
    """

    def __init__(self, index, *, k: int = 10, n_first: int = 64,
                 backend: str | None = None, block_docs: int | None = None,
                 chunk_docs: int | None = None,
                 max_cached_closures: int = 32, route: str = "exhaustive",
                 routing=None, n_probe: int | None = None,
                 route_threshold: float | None = None, monitor=None,
                 on_group_loss: str = "degrade", faults=None):
        if on_group_loss not in ("degrade", "rebalance", "fail"):
            raise ValueError(
                f"on_group_loss={on_group_loss!r} not in "
                "('degrade', 'rebalance', 'fail')")
        from repro_torch.serve import routing as routing_lib
        routing_lib.check_route(route, routing, index, n_probe)
        self.monitor = monitor
        self.on_group_loss = on_group_loss
        self.faults = faults
        self._placement = None          # the rebalance override (grid)
        self._rebalanced_for = frozenset()
        self.route = route
        self.routing = routing
        self.n_probe = n_probe
        self.route_threshold = route_threshold
        self.index = index
        self.k = k
        self.n_first = n_first
        self.backend = backend_lib.resolve_backend(
            backend, allow=backend_lib.SERVING, device=index.device)
        self._block_docs = block_docs
        self._chunk_docs = chunk_docs
        self._max_cached = max(1, int(max_cached_closures))
        self._search = collections.OrderedDict()
        self._mutation = None
        self._generation = 0
        self._mutation_gen = 0
        self._lock = threading.RLock()
        self._gate = threading.Condition(self._lock)
        self._inflight = 0
        self._writers_waiting = 0

    @staticmethod
    def _run(index, q, **kw):
        return search(index, q, return_full=False, **kw)

    @property
    def epoch_key(self) -> tuple:
        """``(generation, mutation_gen, index.epoch)``: the components
        the closure LRU keys on."""
        return (self._generation, self._mutation_gen,
                getattr(self.index, "epoch", 0))

    @contextlib.contextmanager
    def _read_gate(self):
        with self._gate:
            while self._writers_waiting:
                self._gate.wait()
            self._inflight += 1
        try:
            yield
        finally:
            with self._gate:
                self._inflight -= 1
                if self._inflight == 0:
                    self._gate.notify_all()

    @contextlib.contextmanager
    def _write_gate(self):
        with self._gate:
            self._writers_waiting += 1
            try:
                while self._inflight:
                    self._gate.wait()
                yield
            finally:
                self._writers_waiting -= 1
                self._gate.notify_all()

    def swap_index(self, index, *, mutation=None, routing=None):
        """Serve a new index epoch (the compaction swap), with the live
        ``mutation`` view over it (None: none): drains in-flight
        queries, bumps the generation and drops every cached closure.
        A routed server needs the new epoch's ``routing`` table (the old
        one is stale by definition)."""
        if self.route != "exhaustive":
            from repro_torch.serve import routing as routing_lib
            routing_lib.check_route(self.route, routing, index, self.n_probe)
        with self._write_gate():
            self.index = index
            if routing is not None:
                self.routing = routing
            self._mutation = mutation
            self._generation += 1
            self._mutation_gen += 1
            self._search.clear()

    def apply_mutation(self, mutation):
        """Serve the given live delta-log view (upserts + tombstones;
        None: none) beside the current base index.  Like
        :meth:`swap_index`, the update drains in-flight queries first,
        bumps the mutation generation and drops every closure — no
        answer mixes two delta-log states."""
        with self._write_gate():
            self._mutation = mutation
            self._mutation_gen += 1
            self._search.clear()

    def _warm_index(self):
        """Build the packed index's derived views (pooled vectors, the
        cap_max-wide gather view, compressed for a residual index on
        ``fused``) once, before two-stage serving; under a mesh, place
        the shards the e2e sweep scores on their devices."""
        two_stage = (self.route == "exhaustive" and self._mutation is None
                     and self.n_first < _n_docs(self.index))
        if isinstance(self.index, PackedIndex) and two_stage:
            self.index.pooled()
            if _decodes_in_kernel(self.index, self.backend):
                self.index.padded_residual()
            else:
                self.index.padded()
        if two_stage:
            return
        gmesh, n_groups, _, placement = grid_axes_for()
        mesh, axes, _ = mesh_axes_for("candidates")
        if gmesh is not None and self.route == "exhaustive":
            placement = _resolve_placement(
                self.index, self._placement or placement, n_groups)
            for g in range(n_groups):
                if placement.buckets_of(g):
                    _placed(self.index,
                            gmesh.devices_along(("candidates",), hosts=g),
                            placement.buckets_of(g))
        elif gmesh is None and mesh is not None:
            _placed(self.index, mesh.devices_along(axes))

    def _warm_tuner(self, q_embs):
        """Resolve every tuner key the closure for this batch shape will
        ask for, so a measured race never runs inside a served batch:
        on the streaming e2e route (any backend: the slab is
        backend-agnostic) each bucket's streaming key — under a grid per
        host group's shard count, on a flat mesh per its shard count,
        else with the live deltas' — and on a routed ``fused`` server
        the centroid pass's key.  The two-stage route consults none."""
        index = self.index
        if (self.route == "exhaustive" and self._mutation is None
                and self.n_first < _n_docs(index)):
            return
        kw = dict(block_docs=self._block_docs, chunk_docs=self._chunk_docs,
                  codec=_codec_of(index))
        gmesh, n_groups, _, placement = grid_axes_for()
        mesh, axes, _ = mesh_axes_for("candidates")
        if gmesh is not None:
            placement = _resolve_placement(index, self._placement or placement,
                                           n_groups)
            n_cand = len(gmesh.devices_along(("candidates",), hosts=0))
            for b in range(placement.n_buckets):
                _stream_knobs(*_bucket_shape(index, b), q_embs, self.k,
                              n_shards=n_cand, n_groups=n_groups,
                              replicas=placement.replicas, **kw)
        elif mesh is not None:
            n_shards = len(mesh.devices_along(axes))
            for b in _bucket_ids(index):
                _stream_knobs(*_bucket_shape(index, b), q_embs, self.k,
                              n_shards=n_shards, **kw)
        else:
            deltas = () if self._mutation is None else self._mutation.deltas
            for leaf in (index, *deltas):
                kw["codec"] = _codec_of(leaf)
                for _, mk, _ in _index_views(leaf, self.backend):
                    _stream_knobs(mk.shape[0], mk.shape[1], q_embs, self.k,
                                  **kw)
        if self.route != "exhaustive" and self.backend == backend_lib.FUSED:
            r = self.routing
            backend_lib.tuned_routing_blocks(
                q_embs.shape[0], r.n_buckets, r.n_centroids,
                q_embs.shape[1], r.dim, device=q_embs.device)

    def _closure_for(self, q_embs):
        mesh, axes, _ = mesh_axes_for("candidates")
        gmesh, n_groups, _, placement = grid_axes_for()
        key = (tuple(q_embs.shape[:2]) + self.epoch_key
               + (mesh, axes, gmesh, n_groups, placement, self._placement))
        with self._lock:
            entry = self._search.get(key)
            if entry is not None:
                self._search.move_to_end(key)
                building = False
            else:
                entry = concurrent.futures.Future()
                self._search[key] = entry
                while len(self._search) > self._max_cached:
                    self._search.popitem(last=False)
                building = True
        if not building:
            return entry.result()
        try:
            self._warm_tuner(q_embs)
            fn = self._build_closure()
        except BaseException as e:
            entry.set_exception(e)
            with self._lock:
                if self._search.get(key) is entry:
                    del self._search[key]
            raise
        entry.set_result(fn)
        return fn

    def _build_closure(self):
        self._warm_index()
        e2e = self.route != "exhaustive" or self._mutation is not None
        run = functools.partial(
            self._run, self.index, k=self.k, n_first=self.n_first,
            backend=self.backend, block_docs=self._block_docs,
            chunk_docs=self._chunk_docs,
            end_to_end=e2e, route=self.route, routing=self.routing,
            n_probe=self.n_probe, route_threshold=self.route_threshold,
            mutation=self._mutation, placement=self._placement,
            monitor=self.monitor, faults=self.faults)
        rules = current_rules() or {}

        def closure(q):
            with axis_rules(rules):
                return run(q)
        return closure

    def _maybe_rebalance(self) -> bool:
        """The ``rebalance`` policy: re-place the buckets stranded on the
        monitor's demoted groups over the survivors
        (``PlacementPlan.rebalance``; surviving assignments stay put).
        Idempotent per demoted set; run under the state lock from inside
        a query's read section, so concurrent degraded queries agree on
        one new placement."""
        if self.monitor is None or self.on_group_loss != "rebalance":
            return False
        with self._lock:
            demoted = self.monitor.demoted
            if not demoted or demoted == self._rebalanced_for:
                return False
            gmesh, n_groups, _, placement = grid_axes_for()
            if gmesh is None:
                return False
            base = _resolve_placement(
                self.index, self._placement or placement, n_groups)
            self._placement = base.rebalance(
                demoted, weights=bucket_weights(self.index))
            self._rebalanced_for = demoted
            return True

    def query_batch(self, q_embs):
        """Serve one query batch — a tensor on the index's device, or
        host rows (numpy or a CPU tensor), moved there in one copy: a
        :class:`TopKResult` of host (numpy) arrays, brought back in one
        copy and stamped with the ``epoch_key`` it was answered under.
        Its ``coverage`` is below 1 where grid serving lost every
        replica of some buckets (``on_group_loss``: ``"rebalance"``
        re-answers this query at full coverage, ``"fail"`` raises
        ``serve.health.DegradedCoverage``)."""
        q_embs = torch.as_tensor(q_embs).to(self.index.device)
        with self._read_gate():
            epoch_key = self.epoch_key
            out = self._closure_for(q_embs)(q_embs)
            coverage = getattr(out, "coverage", 1.0)
            if coverage < 1.0 and self._maybe_rebalance():
                # this query, from the rebalanced plan (a new closure key)
                out = self._closure_for(q_embs)(q_embs)
                coverage = getattr(out, "coverage", 1.0)
            if coverage < 1.0 and self.on_group_loss == "fail":
                raise health_lib.DegradedCoverage(
                    f"top-k covers {coverage:.4f} of stored bucket bytes "
                    f"(demoted groups: {sorted(self.monitor.demoted)}); "
                    "on_group_loss='fail' refuses degraded results")
            idx, scores = out
            # one device-to-host copy: the fp32 scores travel as their
            # int32 bit patterns beside the int32 ids
            both = torch.stack([idx.to(torch.int32),
                                scores.view(torch.int32)]).cpu().numpy()
            res = TopKResult(both[0], both[1].view(np.float32), coverage)
            res.epoch_key = epoch_key
            return res
