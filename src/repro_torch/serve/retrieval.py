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

Not ported yet: sharded and grid serving and health monitoring (the
reference's imports of ``health`` and ``sharding``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import threading

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.backend import _pow2_at_least
from repro_torch.core.scoring import NEG_INF
from repro_torch.kernels.colbert_maxsim.ops import (
    colbert_maxsim_multi_op, colbert_maxsim_rerank_op,
    colbert_maxsim_residual_multi_op, colbert_maxsim_residual_rerank_op)
from repro_torch.kernels.colbert_maxsim.ref import colbert_maxsim_rerank_ref
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.serve.index import PackedIndex, ResidualView


class TopKResult(tuple):
    """``(top_idx, top_scores)`` that also carries ``coverage`` (always
    1.0 on a single device) and the ``epoch_key`` snapshot
    ``RetrievalServer.query_batch`` answered under."""

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
    """Materializing 4-D einsum path — the parity oracle.  A
    :class:`ResidualView` decodes eagerly here; bf16 docs widen to the
    queries' fp32."""
    if isinstance(d_embs, ResidualView):
        d_embs = d_embs.dense()
    s = torch.einsum("qld,nmd->qnlm", q_embs, d_embs.to(q_embs.dtype))
    s = torch.where(active_mask[None, :, None, :], s, NEG_INF)
    best = s.amax(-1)
    if q_masks is not None:
        best = torch.where(q_masks[:, None, :], best, 0.0)
    return best.sum(-1)


def _score_block(d_embs, active_mask, q_embs, q_masks, *, backend):
    """Score one doc array (dense, or a compressed :class:`ResidualView`)
    on the resolved backend -> (n_q, n_docs)."""
    if backend == backend_lib.FUSED:
        if isinstance(d_embs, ResidualView):
            return colbert_maxsim_residual_multi_op(
                q_embs, d_embs.codes, d_embs.resq, d_embs.scale,
                d_embs.codebook, active_mask.contiguous(), q_masks,
                bits=d_embs.bits)
        return colbert_maxsim_multi_op(q_embs, d_embs.contiguous(),
                                       active_mask.contiguous(), q_masks)
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
                  backend: str | None = None):
    """(n_q, n_docs) exact MaxSim over the pruned index (either layout;
    packed buckets scatter back through their doc-id remap)."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    if not isinstance(index, PackedIndex):
        return _score_block(index.d_embs, index.active_mask, q_embs,
                            q_masks, backend=backend)
    out = torch.zeros((q_embs.shape[0], index.n_docs), dtype=torch.float32,
                      device=q_embs.device)
    for b in index.buckets:
        out[:, b.doc_ids.long()] = _score_block(
            _bucket_array(index, b, backend), b.masks, q_embs, q_masks,
            backend=backend)
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


def _chunk_candidates(embs, masks, doc_ids, q_embs, q_masks, k: int, *,
                      backend, chunk_docs, owner=None, leaf: int = 0):
    """One doc array's exact-MaxSim candidates through the streaming
    reduce loop.

    ``owner``/``leaf`` is the mutation stale mask (:class:`MutationView`):
    slab scores of docs this leaf does not own — a base copy shadowed by
    an upsert, a tombstoned doc — are forced to -inf BEFORE the slab's
    top-k reduction, so a stale copy never crowds a live doc out of its
    bucket's k candidate slots.  The clip guards sentinel ids (< 0,
    forced to -inf by the pad audit regardless) against wraparound."""

    def slab(a, b):
        s = _score_block(embs[a:b], masks[a:b], q_embs, q_masks,
                         backend=backend)
        if owner is not None:
            ids = (torch.arange(a, b, device=s.device) if doc_ids is None
                   else doc_ids[a:b].long())
            own = owner[ids.clamp(0, owner.shape[0] - 1)]
            s = torch.where((own != leaf)[None, :], -torch.inf, s)
        return s

    return _stream_chunk_topk(masks.shape[0], chunk_docs, k, slab,
                              doc_ids=doc_ids)


def _index_views(index, backend):
    """Per-bucket (embs, masks, doc_ids) views; ``doc_ids=None`` means
    the axis is already in global doc order (dense layout)."""
    if not isinstance(index, PackedIndex):
        return [(index.d_embs, index.active_mask, None)]
    return [(_bucket_array(index, b, backend), b.masks, b.doc_ids)
            for b in index.buckets]


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


def _topk_local(index, q_embs, q_masks, k: int, *, backend, chunk_docs,
                mutation=None, real_cap=None):
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
        for e, mk, di in _index_views(leaf_index, backend):
            v, i = _chunk_candidates(e, mk, di, q_embs, q_masks, k,
                                     backend=backend, chunk_docs=chunk_docs,
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


def _topk_search_routed(index, q_embs, q_masks, k: int, *, backend,
                        chunk_docs, route, routing, n_probe,
                        route_threshold, route_stats, mutation=None):
    """The candidate-routing tier in front of the merge (see
    :func:`topk_search`).  The centroid pass runs on the device in one
    sweep; the (n_q, n_buckets) scores and bounds come to the host,
    where the shortlist is chosen before any bucket is scored.  Under
    ``mutation`` every delta leaf joins the routed base, scored
    exhaustively (the table knows nothing of fresh upserts)."""
    from repro_torch.serve import routing as routing_lib

    routing_lib.check_route(route, routing, index, n_probe)
    probe = 1 if n_probe is None else int(n_probe)
    s, u = routing_lib.centroid_scores(routing, q_embs, q_masks,
                                       backend=backend)
    s_host, u_host = s.cpu().numpy(), u.cpu().numpy()

    delta_real = (0 if mutation is None
                  else sum(_real_docs(d) for d in mutation.deltas))

    def run(bucket_ids):
        view = _bucket_view(index, tuple(bucket_ids))
        if view is None and mutation is None:
            return _empty_topk(q_embs)
        real_cap = None
        if mutation is not None:
            base_real = 0 if view is None else _real_docs(view)
            real_cap = min(base_real + delta_real, mutation.n_live)
        return _topk_local(view, q_embs, q_masks, k, backend=backend,
                           chunk_docs=chunk_docs, mutation=mutation,
                           real_cap=real_cap)

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
    out = run(selected)
    if route_stats is not None:
        nb = routing.n_buckets
        route_stats.update(route=route, n_buckets=nb,
                           buckets_scored=len(selected),
                           fraction=len(selected) / max(nb, 1))
    return out


def topk_search(index, q_embs, *, k: int = 10, q_masks=None,
                backend: str | None = None, chunk_docs: int | None = None,
                route: str = "exhaustive", routing=None,
                n_probe: int | None = None,
                route_threshold: float | None = None,
                route_stats: dict | None = None,
                mutation: MutationView | None = None):
    """Streaming exact top-k MaxSim: ``(top_idx, top_scores)``, each
    (n_q, min(k, n_docs)), equal to the (-score, id)-ordered top-k of
    :func:`maxsim_scores` without ever holding an (n_q, n_docs) score
    matrix.  ``chunk_docs`` defaults to ``backend.STREAM_CHUNK_DOCS``.

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
    Under a routed mode the deltas are scored in full."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    chunk_docs = chunk_docs or backend_lib.STREAM_CHUNK_DOCS
    if mutation is not None and mutation.n_live == 0:
        return _empty_topk(q_embs)
    if _n_docs(index) == 0 and mutation is None:
        return _empty_topk(q_embs)
    if route != "exhaustive":
        return _topk_search_routed(
            index, q_embs, q_masks, k, backend=backend,
            chunk_docs=chunk_docs, route=route, routing=routing,
            n_probe=n_probe, route_threshold=route_threshold,
            route_stats=route_stats, mutation=mutation)
    return _topk_local(index, q_embs, q_masks, k, backend=backend,
                       chunk_docs=chunk_docs, mutation=mutation)


def _streaming_first_stage(index, q_embs, n_first: int):
    """Chunked first stage: pooled single-vector scores stream through
    the same sort-merge, so no (n_q, n_docs) matrix is held.  Candidate
    ids come back in (-score, id) order."""
    pooled = index.pooled()                           # (n_docs, dim)
    q_pool = q_embs.mean(1)
    chunk = max(64, _pow2_at_least(2 * n_first))
    vals, ids = _stream_chunk_topk(
        pooled.shape[0], chunk, n_first,
        lambda a, b: q_pool @ pooled[a:b].T)
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
           backend: str | None = None, chunk_docs: int | None = None,
           return_full: bool = True, route: str = "exhaustive",
           routing=None, n_probe: int | None = None,
           route_threshold: float | None = None,
           route_stats: dict | None = None,
           mutation: MutationView | None = None):
    """Two-stage (or e2e) retrieval.  ``return_full=True`` returns
    (top_idx, top_scores, full) with the densified (n_q, n_docs) score
    matrix (the metrics contract: non-candidates score -1e30);
    ``return_full=False`` (the serving default) returns (top_idx,
    top_scores) and streams — e2e through :func:`topk_search`, two-stage
    through the chunked first stage.  Results are identical.  A routed
    ``route`` and a ``mutation`` view (see :func:`topk_search`) apply
    to the streaming e2e route only."""
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
                               backend=backend, chunk_docs=chunk_docs,
                               route=route, routing=routing,
                               n_probe=n_probe,
                               route_threshold=route_threshold,
                               route_stats=route_stats, mutation=mutation)
        scores = maxsim_scores(index, q_embs, q_masks, backend=backend)
        top_scores, top_idx = topk_lowest_index(scores, k)
        return top_idx, top_scores, scores
    if not return_full:
        cand = _streaming_first_stage(index, q_embs, n_first)
    else:
        first = q_embs.mean(1) @ index.pooled().T     # (n_q, n_docs)
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
    """

    def __init__(self, index, *, k: int = 10, n_first: int = 64,
                 backend: str | None = None, chunk_docs: int | None = None,
                 max_cached_closures: int = 32, route: str = "exhaustive",
                 routing=None, n_probe: int | None = None,
                 route_threshold: float | None = None):
        from repro_torch.serve import routing as routing_lib
        routing_lib.check_route(route, routing, index, n_probe)
        self.route = route
        self.routing = routing
        self.n_probe = n_probe
        self.route_threshold = route_threshold
        self.index = index
        self.k = k
        self.n_first = n_first
        self.backend = backend_lib.resolve_backend(
            backend, allow=backend_lib.SERVING, device=index.device)
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
        ``fused``) once, before two-stage serving."""
        if (isinstance(self.index, PackedIndex) and self.route == "exhaustive"
                and self._mutation is None
                and self.n_first < self.index.n_docs):
            self.index.pooled()
            if _decodes_in_kernel(self.index, self.backend):
                self.index.padded_residual()
            else:
                self.index.padded()

    def _closure_for(self, q_embs):
        key = tuple(q_embs.shape[:2]) + self.epoch_key
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
        return functools.partial(
            self._run, self.index, k=self.k, n_first=self.n_first,
            backend=self.backend, chunk_docs=self._chunk_docs,
            end_to_end=e2e, route=self.route, routing=self.routing,
            n_probe=self.n_probe, route_threshold=self.route_threshold,
            mutation=self._mutation)

    def query_batch(self, q_embs):
        """Serve one query batch: a :class:`TopKResult` of host (numpy)
        arrays, stamped with the ``epoch_key`` it was answered under."""
        with self._read_gate():
            epoch_key = self.epoch_key
            idx, scores = self._closure_for(q_embs)(q_embs)
            res = TopKResult(idx.cpu().numpy(), scores.cpu().numpy())
            res.epoch_key = epoch_key
            return res
