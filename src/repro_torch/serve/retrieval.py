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

Not ported yet: sharded and grid serving, placement, health monitoring,
candidate routing, mutation serving (the reference's imports of
``health``, ``sharding`` and ``placement``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import threading

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.backend import _pow2_at_least
from repro_torch.core.scoring import NEG_INF
from repro_torch.kernels.colbert_maxsim.ops import (colbert_maxsim_multi_op,
                                                    colbert_maxsim_rerank_op)
from repro_torch.kernels.colbert_maxsim.ref import colbert_maxsim_rerank_ref
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.serve.index import PackedIndex


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
    """Materializing 4-D einsum path — the parity oracle."""
    s = torch.einsum("qld,nmd->qnlm", q_embs, d_embs)
    s = torch.where(active_mask[None, :, None, :], s, NEG_INF)
    best = s.amax(-1)
    if q_masks is not None:
        best = torch.where(q_masks[:, None, :], best, 0.0)
    return best.sum(-1)


def _score_block(d_embs, active_mask, q_embs, q_masks, *, backend):
    """Score one doc array on the resolved backend -> (n_q, n_docs)."""
    if backend == backend_lib.FUSED:
        return colbert_maxsim_multi_op(q_embs, d_embs.contiguous(),
                                       active_mask.contiguous(), q_masks)
    return _maxsim_scores_reference(d_embs, active_mask, q_embs, q_masks)


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
        out[:, b.doc_ids.long()] = _score_block(b.embs, b.masks, q_embs,
                                                q_masks, backend=backend)
    return out


def _merge_topk(scores, ids, k: int):
    """Exact top-k of candidate (scores, ids) columns in the (-score, id)
    order: a stable sort by id, then a stable sort by descending score.
    Returns (ids, scores), each (n_q, k)."""
    o = torch.sort(ids, dim=1, stable=True).indices
    ids, scores = ids.gather(1, o), scores.gather(1, o)
    o = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]
    return ids.gather(1, o), scores.gather(1, o)


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
                      backend, chunk_docs):
    """One doc array's exact-MaxSim candidates through the streaming
    reduce loop."""

    def slab(a, b):
        return _score_block(embs[a:b], masks[a:b], q_embs, q_masks,
                            backend=backend)

    return _stream_chunk_topk(masks.shape[0], chunk_docs, k, slab,
                              doc_ids=doc_ids)


def _index_views(index):
    """Per-bucket (embs, masks, doc_ids) views; ``doc_ids=None`` means
    the axis is already in global doc order (dense layout)."""
    if not isinstance(index, PackedIndex):
        return [(index.d_embs, index.active_mask, None)]
    return [(b.embs, b.masks, b.doc_ids) for b in index.buckets]


def _real_docs(index) -> int:
    if isinstance(index, PackedIndex):
        return sum(b.n_docs for b in index.buckets)
    return index.d_masks.shape[0]


def topk_search(index, q_embs, *, k: int = 10, q_masks=None,
                backend: str | None = None, chunk_docs: int | None = None):
    """Streaming exact top-k MaxSim: ``(top_idx, top_scores)``, each
    (n_q, min(k, n_docs)), equal to the (-score, id)-ordered top-k of
    :func:`maxsim_scores` without ever holding an (n_q, n_docs) score
    matrix.  ``chunk_docs`` defaults to ``backend.STREAM_CHUNK_DOCS``."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    chunk_docs = chunk_docs or backend_lib.STREAM_CHUNK_DOCS
    n_q = q_embs.shape[0]
    if _n_docs(index) == 0:
        return (torch.zeros((n_q, 0), dtype=torch.int32,
                            device=q_embs.device),
                torch.zeros((n_q, 0), device=q_embs.device))
    vals, ids = [], []
    for e, mk, di in _index_views(index):
        v, i = _chunk_candidates(e, mk, di, q_embs, q_masks, k,
                                 backend=backend, chunk_docs=chunk_docs)
        vals.append(v)
        ids.append(i)
    vals = torch.cat(vals, dim=1)
    ids = torch.cat(ids, dim=1)
    return _merge_topk(vals, ids, min(k, _real_docs(index), vals.shape[1]))


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
    rerank-kernel launch for all queries on ``fused``)."""
    g_embs, g_masks = _gather_view(index)
    c = cand.long()
    d_sub = g_embs[c]                                 # (n_q, n_first, m, dim)
    m_sub = g_masks[c]
    if backend == backend_lib.FUSED:
        return colbert_maxsim_rerank_op(q_embs, d_sub, m_sub, q_masks)
    return colbert_maxsim_rerank_ref(q_embs, d_sub, m_sub, q_masks)


def search(index, q_embs, *, k: int = 10, n_first: int = 64,
           end_to_end: bool = False, q_masks=None,
           backend: str | None = None, chunk_docs: int | None = None,
           return_full: bool = True):
    """Two-stage (or e2e) retrieval.  ``return_full=True`` returns
    (top_idx, top_scores, full) with the densified (n_q, n_docs) score
    matrix (the metrics contract: non-candidates score -1e30);
    ``return_full=False`` (the serving default) returns (top_idx,
    top_scores) and streams — e2e through :func:`topk_search`, two-stage
    through the chunked first stage.  Results are identical."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    n_docs = _n_docs(index)
    if end_to_end or n_first >= n_docs:
        if not return_full:
            return topk_search(index, q_embs, k=k, q_masks=q_masks,
                               backend=backend, chunk_docs=chunk_docs)
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
    inside a read gate that :meth:`swap_index` closes: a swap drains
    in-flight queries, bumps the generation and drops every closure, so
    each answer is attributable to one ``epoch_key`` snapshot
    ``(generation, mutation_gen, index.epoch)``.
    """

    def __init__(self, index, *, k: int = 10, n_first: int = 64,
                 backend: str | None = None, chunk_docs: int | None = None,
                 max_cached_closures: int = 32):
        self.index = index
        self.k = k
        self.n_first = n_first
        self.backend = backend_lib.resolve_backend(
            backend, allow=backend_lib.SERVING, device=index.device)
        self._chunk_docs = chunk_docs
        self._max_cached = max(1, int(max_cached_closures))
        self._search = collections.OrderedDict()
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

    def swap_index(self, index):
        """Serve a new index epoch: drains in-flight queries, bumps the
        generation and drops every cached closure."""
        with self._write_gate():
            self.index = index
            self._generation += 1
            self._mutation_gen += 1
            self._search.clear()

    def _warm_index(self):
        """Build the packed index's derived views (pooled vectors, the
        cap_max-wide gather view) once, before serving."""
        if (isinstance(self.index, PackedIndex)
                and self.n_first < self.index.n_docs):
            self.index.pooled()
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
        return functools.partial(
            self._run, self.index, k=self.k, n_first=self.n_first,
            backend=self.backend, chunk_docs=self._chunk_docs)

    def query_batch(self, q_embs):
        """Serve one query batch: a :class:`TopKResult` of host (numpy)
        arrays, stamped with the ``epoch_key`` it was answered under."""
        with self._read_gate():
            epoch_key = self.epoch_key
            idx, scores = self._closure_for(q_embs)(q_embs)
            res = TopKResult(idx.cpu().numpy(), scores.cpu().numpy())
            res.epoch_key = epoch_key
            return res
