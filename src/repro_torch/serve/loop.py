"""Concurrent micro-batched serving loop.

Counterpart of ``repro.serve.loop``.  ``RetrievalServer.query_batch``
answers one batch at a time; real traffic arrives as a stream of small,
independent requests.  :class:`ServeLoop` sits in front of the server
and turns that stream into the batch shapes the stack is built for:

* **Submission queue + micro-batching.**  Clients ``submit()`` single
  queries (or small batches) of host rows and get a future.  A
  dispatcher thread collects arrivals until the flush deadline
  (``flush_ms``, from the oldest arrival) or the batch cap
  (``max_batch`` rows) is hit, groups them by exact per-query token
  shape ``(l, dim)``, and pads each group's query count up to the next
  power of two by repeating its first row — the ``n_q`` bucketing the
  server's closure LRU keys on, so steady traffic reuses a small,
  bounded set of closures whatever the request counts.  Per-query
  MaxSim is row-independent (each query's scores, merges and top-k read
  only its own row), so padding never perturbs a real row and the
  demuxed answer is bit-identical to serving that query alone.
* **Host traffic.**  Each group's rows are stacked on the host and
  moved to the index's device in one copy; the server returns host
  arrays in one copy per group; nothing synchronizes per query.
* **Per-query demux.**  The merged answer is sliced back per request,
  in row order; every answer carries the batch's ``coverage`` and
  ``epoch_key`` (the ``(generation, mutation_gen, index.epoch)``
  snapshot it was computed under).
* **Per-epoch result cache.**  Answers at full coverage are cached
  under ``(epoch_key, sha1(query bytes))``: an epoch swap or a delta-log
  update changes the key, so stale entries stop matching and age out of
  the bounded LRU.  Degraded answers (coverage < 1) are never cached.
* **Mutations serialized against in-flight flushes.**  ``swap_index`` /
  ``apply_mutation`` pass through to the server, whose write gate drains
  in-flight queries first, so every flush is answered by exactly one
  epoch.

PyTorch keeps grad mode, ``inference_mode`` and the current CUDA device
per thread, and the port's sharding rules are thread-local as the
reference's are, so the dispatcher sets all three itself: it serves
under ``torch.inference_mode()`` with the index's CUDA device current
(the kernels launch on that thread's current stream of the device) and
under the axis rules of the thread that built the loop (captured at
construction, as the reference does): a loop built under
``sharding.serve_rules(grid)`` serves on that grid.  The kernels'
library is loaded at construction, before the first flush.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.tuning import _pow2_at_least
from repro_torch.serve.retrieval import TopKResult
from repro_torch.sharding import axis_rules, current_rules

__all__ = ["ServeLoop", "LoopStats"]

_SHUTDOWN = object()


class _Request:
    """One submitted query batch awaiting its demuxed answers."""

    __slots__ = ("q", "n", "future", "t_submit", "cached")

    def __init__(self, q: np.ndarray, clock) -> None:
        self.q = q
        self.n = q.shape[0]
        self.future: Future = Future()
        self.t_submit = clock()
        self.cached: list = [None] * self.n   # per-row cache hits


class LoopStats:
    """Counters + latency reservoir the loop maintains under its own
    lock; ``snapshot()`` returns a plain dict (p50/p99 in seconds)."""

    def __init__(self, window: int = 4096) -> None:
        self._lock = threading.Lock()
        self._lat: list = []
        self._window = int(window)
        self.flushes = 0
        self.queries = 0
        self.batches = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.padded_rows = 0
        self.shapes: dict = {}

    def record_flush(self, n_batches: int, padded: int) -> None:
        with self._lock:
            self.flushes += 1
            self.batches += n_batches
            self.padded_rows += padded

    def record_shape(self, shape: tuple) -> None:
        with self._lock:
            self.shapes[shape] = self.shapes.get(shape, 0) + 1

    def record_query(self, latency_s: float, *, hit: bool) -> None:
        with self._lock:
            self.queries += 1
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
            self._lat.append(latency_s)
            if len(self._lat) > self._window:
                del self._lat[:len(self._lat) - self._window]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)

            def pct(p):
                if not lat:
                    return float("nan")
                return lat[min(len(lat) - 1, int(p * (len(lat) - 1)))]

            return {
                "flushes": self.flushes,
                "queries": self.queries,
                "batches": self.batches,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "padded_rows": self.padded_rows,
                "batch_shapes": dict(self.shapes),
                "p50_latency_s": pct(0.50),
                "p99_latency_s": pct(0.99),
            }


def _qhash(row: np.ndarray) -> bytes:
    """Content hash of one query's embedding block (shape + dtype +
    bytes): two bit-identical queries share an answer, two queries
    differing in any mantissa bit do not."""
    h = hashlib.sha1()
    h.update(str((row.shape, row.dtype.str)).encode())
    h.update(np.ascontiguousarray(row).tobytes())
    return h.digest()


def _host_rows(q) -> np.ndarray:
    """``q`` as a host numpy array: numpy and CPU tensors pass, a tensor
    on a device is refused (the loop hashes and stacks host rows)."""
    if isinstance(q, torch.Tensor):
        if q.device.type != "cpu":
            raise ValueError(f"submit takes host rows (numpy or CPU "
                             f"tensors), got a tensor on {q.device}")
        return q.detach().numpy()
    return np.asarray(q)


class ServeLoop:
    """The concurrent micro-batched front-end of a
    :class:`~repro_torch.serve.retrieval.RetrievalServer`.

    ``submit(q)`` (one ``(l, dim)`` query or an ``(n, l, dim)`` batch of
    host rows) enqueues and returns a
    :class:`concurrent.futures.Future` whose result is a list of
    per-query :class:`TopKResult`\\ s (host arrays, each carrying
    ``coverage`` and ``epoch_key``).  ``query()`` is the blocking
    single-query convenience.  The dispatcher thread flushes when
    ``max_batch`` queries are waiting or ``flush_ms`` elapsed since the
    oldest arrival, whichever is first.

    ``result_cache_size`` bounds the per-epoch result cache (0 disables
    it).  ``swap_index``/``apply_mutation`` are the mutation
    pass-throughs — safe to call while clients are submitting; the
    server's write gate serializes them against in-flight flushes.

    Use as a context manager or call :meth:`close` — pending requests
    are flushed, not dropped.
    """

    def __init__(self, server, *, flush_ms: float = 2.0,
                 max_batch: int = 32, result_cache_size: int = 4096,
                 clock=time.monotonic) -> None:
        if flush_ms < 0:
            raise ValueError(f"flush_ms={flush_ms} < 0")
        if max_batch < 1:
            raise ValueError(f"max_batch={max_batch} < 1")
        self.server = server
        self.flush_ms = float(flush_ms)
        self.max_batch = int(max_batch)
        self._clock = clock
        self.stats = LoopStats()
        self._queue: queue.Queue = queue.Queue()
        self._cache_size = max(0, int(result_cache_size))
        self._cache: OrderedDict = OrderedDict()
        self._cache_lock = threading.Lock()
        self._closed = False
        self._close_lock = threading.Lock()
        # The device every flush serves on; the dispatcher makes it
        # current in its own thread.  Build and load the kernels here, so
        # no flush waits on nvcc behind the build lock.
        self._device = server.index.device
        # The constructing thread's sharding rules (a mesh and placement
        # under serve_rules): the dispatcher serves under them.
        self._rules = current_rules() or {}
        if (self._device.type == "cuda"
                and server.backend == backend_lib.FUSED):
            from repro_torch.kernels import build
            build.library("colbert_maxsim")
        self._thread = threading.Thread(
            target=self._run, name="serve-loop-dispatch", daemon=True)
        self._thread.start()

    # -- client API ------------------------------------------------------

    def submit(self, q) -> Future:
        """Enqueue one query (``(l, dim)``) or batch (``(n, l, dim)``) of
        host rows; returns a future resolving to ``[TopKResult, ...]``
        (one per row, in submission order)."""
        q = _host_rows(q)
        if q.ndim == 2:
            q = q[None]
        if q.ndim != 3:
            raise ValueError(
                f"submit wants (l, dim) or (n, l, dim); got {q.shape}")
        if self._closed:
            raise RuntimeError("ServeLoop is closed")
        req = _Request(q, self._clock)
        self._queue.put(req)
        return req.future

    def query(self, q) -> TopKResult:
        """Blocking single-query serve: ``TopKResult`` for one
        ``(l, dim)`` query."""
        q = _host_rows(q)
        if q.ndim != 2:
            raise ValueError(f"query wants one (l, dim) query; "
                             f"got {q.shape}")
        return self.submit(q).result()[0]

    def query_many(self, q) -> list:
        """Blocking batch submit: ``[TopKResult, ...]`` per row of an
        ``(n, l, dim)`` batch."""
        return self.submit(q).result()

    # -- mutation pass-throughs -----------------------------------------

    def swap_index(self, index, *, mutation=None, routing=None) -> None:
        """Epoch swap, serialized against in-flight flushes by the
        server's write gate: the swap drains running query batches and
        blocks new ones, so no flush ever straddles two epochs."""
        self.server.swap_index(index, mutation=mutation, routing=routing)

    def apply_mutation(self, mutation) -> None:
        """Delta-log update, same serialization as :meth:`swap_index`."""
        self.server.apply_mutation(mutation)

    # -- lifecycle -------------------------------------------------------

    def close(self, *, timeout: float | None = 30.0) -> None:
        """Stop accepting work, flush what is queued, join the
        dispatcher."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._queue.put(_SHUTDOWN)
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "ServeLoop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher ------------------------------------------------------

    def _run(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        with torch.inference_mode(), axis_rules(self._rules):
            self._run_inner()

    def _run_inner(self) -> None:
        while True:
            req = self._queue.get()
            if req is _SHUTDOWN:
                return
            pending = [req]
            rows = req.n
            deadline = self._clock() + self.flush_ms / 1000.0
            stop = False
            while rows < self.max_batch:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                pending.append(nxt)
                rows += nxt.n
            self._flush(pending)
            if stop:
                return

    def _flush(self, pending: list) -> None:
        """Answer every pending request: resolve cache hits, group the
        misses by (l, dim), run one padded pow2 ``query_batch`` per
        group, demux, cache, resolve futures."""
        # (l, dim) -> list of (request, row index in request)
        groups: dict = {}
        epoch_key = self.server.epoch_key
        for req in pending:
            for i in range(req.n):
                hit = self._cache_get(epoch_key, req.q[i])
                if hit is not None:
                    req.cached[i] = hit
                else:
                    groups.setdefault(req.q.shape[1:], []).append((req, i))
        try:
            merged = {}
            for shape, slots in sorted(groups.items(),
                                       key=lambda kv: kv[0]):
                merged[shape] = self._run_group(shape, slots)
        except BaseException as e:
            for req in pending:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        self.stats.record_flush(len(groups),
                                sum(p for _, p in merged.values()))
        # Demux: per-request answer lists in row order.
        sliced: dict = {}
        for shape, slots in groups.items():
            out, _ = merged[shape]
            for j, (req, i) in enumerate(slots):
                res = TopKResult(out.top_idx[j], out.top_scores[j],
                                 out.coverage)
                res.epoch_key = out.epoch_key
                if out.coverage >= 1.0:
                    self._cache_put(out.epoch_key, req.q[i], res)
                sliced.setdefault(id(req), {})[i] = res
        now = self._clock()
        for req in pending:
            answers = []
            per = sliced.get(id(req), {})
            for i in range(req.n):
                res = req.cached[i] if req.cached[i] is not None \
                    else per[i]
                answers.append(res)
                self.stats.record_query(now - req.t_submit,
                                        hit=req.cached[i] is not None)
            req.future.set_result(answers)

    def _run_group(self, shape: tuple, slots: list):
        """One (l, dim) group's merged serve: stack the miss rows, pad
        the query axis to the next power of two (repeating the first
        row — real data, so the kernels see nothing unusual), move the
        batch to the index's device in one copy, run the server once,
        return (batch TopKResult over the REAL rows, padded-row
        count)."""
        q = np.stack([req.q[i] for req, i in slots])
        n_real = q.shape[0]
        n_pad = _pow2_at_least(n_real)
        if n_pad > n_real:
            q = np.concatenate(
                [q, np.broadcast_to(q[:1], (n_pad - n_real,) + shape)])
        self.stats.record_shape((n_pad,) + shape)
        out = self.server.query_batch(torch.from_numpy(q).to(self._device))
        res = TopKResult(out.top_idx[:n_real], out.top_scores[:n_real],
                         out.coverage)
        res.epoch_key = out.epoch_key
        return res, n_pad - n_real

    # -- result cache ----------------------------------------------------

    def _cache_get(self, epoch_key, row: np.ndarray):
        if not self._cache_size:
            return None
        key = (epoch_key, _qhash(row))
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._cache.move_to_end(key)
            return hit

    def _cache_put(self, epoch_key, row: np.ndarray, res) -> None:
        if not self._cache_size:
            return
        key = (epoch_key, _qhash(row))
        with self._cache_lock:
            self._cache[key] = res
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)

    def cache_len(self) -> int:
        with self._cache_lock:
            return len(self._cache)
