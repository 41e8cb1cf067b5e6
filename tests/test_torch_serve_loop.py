"""The port's concurrent micro-batched serving loop
(``repro_torch.serve.loop``) on the CPU.

Three things are held:

* against the reference (``repro.serve.loop``) on the same numpy-made
  packed fixture: the port's loop answers as the reference's does, ids
  equal and scores within 1e-5;
* the port's own bitwise contracts: every demuxed answer equals serving
  that query ALONE (a one-row serial oracle), through the pow2 padding
  (5 -> 8, 3 -> 4, ...) — the contract the reference's
  ``test_batch_submit_demuxes_in_row_order`` states against a 5-row
  oracle; cache replay and its invalidation by ``swap_index`` and
  ``apply_mutation``; the LRU bound; ``LoopStats``; a flush error that
  rejects its futures while the loop survives; submit after close, bad
  shapes, constructor validation; the dispatcher's thread state;
* the stress law: client threads on mixed shapes against a closure LRU
  of 2, while a writer swaps epochs and applies a real delta-log view —
  every answer bit-equal to the one-row oracle of the corpus state its
  ``epoch_key`` names.

Also here: ``PackedIndex``'s lazy views are built once when two readers
ask for them at once.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.loop import ServeLoop as JServeLoop
from repro.serve.retrieval import RetrievalServer as JServer
from repro.serve.retrieval import TokenIndex as JTokenIndex
from repro_torch.serve import index_io
from repro_torch.serve import mutation as mutation_lib
from repro_torch.serve.loop import LoopStats, ServeLoop, _qhash
from repro_torch.serve.retrieval import RetrievalServer, TokenIndex

E2E = 0x7FFFFFFF      # n_first: the e2e exact sweep whatever is swapped in
JOIN_S = 120


def _arrays(seed, n_docs=16, m=8, dim=4):
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((n_docs, m, dim)) * 0.5).astype(np.float32)
    n_real = rng.integers(1, m + 1, n_docs)
    masks = np.arange(m)[None, :] < n_real[:, None]
    keep = rng.random((n_docs, m)) < 0.7
    return d, masks, keep


def _packed(seed, **kw):
    d, masks, keep = _arrays(seed, **kw)
    return TokenIndex.build(torch.from_numpy(d), torch.from_numpy(masks)
                            ).with_keep(torch.from_numpy(keep)).pack()


def _j_packed(seed, **kw):
    d, masks, keep = _arrays(seed, **kw)
    return JTokenIndex.build(jnp.asarray(d), jnp.asarray(masks)
                             ).with_keep(jnp.asarray(keep)).pack()


def _queries(seed, n_q, l, dim=4):
    rng = np.random.default_rng(1000 + seed)
    return rng.standard_normal((n_q, l, dim)).astype(np.float32)


def _server(packed, **kw):
    kw.setdefault("k", 3)
    kw.setdefault("n_first", E2E)
    return RetrievalServer(packed, **kw)


def _alone(server, q):
    """The one-row serial oracle: each query served by itself."""
    return [server.query_batch(q[i:i + 1]) for i in range(q.shape[0])]


def _assert_same(res, oracle):
    """One demuxed answer against a one-row oracle's only row — bitwise."""
    np.testing.assert_array_equal(res.top_idx, oracle.top_idx[0])
    np.testing.assert_array_equal(res.top_scores, oracle.top_scores[0])


class TestAgainstReference:
    """The port's loop against the reference's, fed the same arrays."""

    @pytest.mark.parametrize("n_rows,max_batch", [(1, 8), (5, 8), (3, 3),
                                                  (9, 4)])
    def test_batch_answers_match(self, n_rows, max_batch):
        q = _queries(1, n_rows, 4)
        with ServeLoop(_server(_packed(2)), flush_ms=1.0,
                       max_batch=max_batch) as sl:
            got = sl.query_many(q)
        with JServeLoop(JServer(_j_packed(2), k=3, n_first=E2E),
                        flush_ms=1.0, max_batch=max_batch) as jl:
            want = jl.query_many(q)
        assert len(got) == len(want) == n_rows
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.top_idx, np.asarray(w.top_idx))
            np.testing.assert_allclose(g.top_scores,
                                       np.asarray(w.top_scores), atol=1e-5,
                                       rtol=0)
            assert g.epoch_key == tuple(w.epoch_key) == (0, 0, 0)
            assert g.coverage == w.coverage == 1.0

    def test_mixed_shapes_and_stats_match(self):
        q3, q4 = _queries(7, 2, 3), _queries(8, 3, 4)
        snaps, answers = [], []
        for loop, srv in ((ServeLoop, _server(_packed(6))),
                          (JServeLoop, JServer(_j_packed(6), k=3,
                                               n_first=E2E))):
            with loop(srv, flush_ms=250.0, max_batch=5) as sl:
                f3, f4 = sl.submit(q3), sl.submit(q4)
                answers.append(f3.result() + f4.result())
            snap = sl.stats.snapshot()
            snaps.append({k: snap[k] for k in (
                "flushes", "queries", "batches", "padded_rows",
                "cache_hits", "batch_shapes")})
        assert snaps[0] == snaps[1]
        assert snaps[0]["batch_shapes"] == {(2, 3, 4): 1, (4, 4, 4): 1}
        for g, w in zip(*answers):
            np.testing.assert_array_equal(g.top_idx, np.asarray(w.top_idx))
            np.testing.assert_allclose(g.top_scores,
                                       np.asarray(w.top_scores), atol=1e-5,
                                       rtol=0)

    def test_qhash_matches_reference(self):
        from repro.serve.loop import _qhash as j_qhash
        for q in (_queries(3, 1, 4)[0], np.zeros((2, 3), np.float64)):
            assert _qhash(q) == j_qhash(q)


class TestMicroBatching:
    def test_single_query_roundtrip(self):
        server = _server(_packed(0))
        q = _queries(1, 1, 4)
        oracle = server.query_batch(q)
        with ServeLoop(server, flush_ms=1.0) as sl:
            res = sl.query(q[0])
        _assert_same(res, oracle)
        assert res.epoch_key == (0, 0, 0)
        assert res.coverage == 1.0
        assert res.top_idx.shape == (3,)

    @pytest.mark.parametrize("n_rows", [1, 2, 3, 5, 7, 8])
    def test_padding_never_perturbs_real_rows(self, n_rows):
        """5 -> 8, 3 -> 4, 7 -> 8: each real row equals that query served
        alone, bit for bit (the pad rows repeat the first real row)."""
        server = _server(_packed(2))
        q = _queries(3, n_rows, 4)
        oracle = _alone(server, q)
        with ServeLoop(server, flush_ms=50.0, max_batch=8,
                       result_cache_size=0) as sl:
            answers = sl.query_many(q)
        assert len(answers) == n_rows
        for res, one in zip(answers, oracle):
            _assert_same(res, one)
        pad = 1 << (n_rows - 1).bit_length()
        snap = sl.stats.snapshot()
        assert snap["padded_rows"] == pad - n_rows
        assert snap["batch_shapes"] == {(pad, 4, 4): 1}

    @pytest.mark.parametrize("n_first", [E2E, 8])
    def test_padding_at_full_width(self, n_first):
        """Width 128, 32 query tokens (the full config's), 5 -> 8 rows, on
        the e2e sweep and the two-stage route."""
        server = RetrievalServer(_packed(4, n_docs=40, m=24, dim=128), k=10,
                                 n_first=n_first)
        q = _queries(5, 5, 32, dim=128)
        oracle = _alone(server, q)
        with ServeLoop(server, flush_ms=50.0, max_batch=8) as sl:
            for res, one in zip(sl.query_many(q), oracle):
                _assert_same(res, one)

    def test_mixed_shapes_grouped_per_flush(self):
        server = _server(_packed(6))
        q3, q4 = _queries(7, 2, 3), _queries(8, 2, 4)
        o3, o4 = _alone(server, q3), _alone(server, q4)
        with ServeLoop(server, flush_ms=250.0, max_batch=4) as sl:
            f3, f4 = sl.submit(q3), sl.submit(q4)
            a3, a4 = f3.result(), f4.result()
        for i in range(2):
            _assert_same(a3[i], o3[i])
            _assert_same(a4[i], o4[i])
        shapes = sl.stats.snapshot()["batch_shapes"]
        assert (2, 3, 4) in shapes and (2, 4, 4) in shapes

    def test_max_batch_flushes_before_deadline(self):
        server = _server(_packed(9))
        q = _queries(10, 2, 4)
        with ServeLoop(server, flush_ms=60_000.0, max_batch=2) as sl:
            t0 = time.monotonic()
            answers = sl.query_many(q)
            dt = time.monotonic() - t0
        assert len(answers) == 2
        assert dt < 30.0                        # did not wait the minute

    def test_close_flushes_pending(self):
        server = _server(_packed(11))
        q = _queries(12, 3, 4)
        sl = ServeLoop(server, flush_ms=60_000.0, max_batch=100)
        futures = [sl.submit(q[i]) for i in range(3)]
        sl.close(timeout=JOIN_S)
        assert not sl._thread.is_alive()
        for f, one in zip(futures, _alone(server, q)):
            assert f.done()
            _assert_same(f.result()[0], one)

    def test_submit_after_close_raises(self):
        sl = ServeLoop(_server(_packed(11)), flush_ms=1.0)
        sl.close()
        with pytest.raises(RuntimeError, match="closed"):
            sl.submit(_queries(12, 1, 4))
        sl.close()                              # idempotent

    def test_bad_shapes_rejected(self):
        with ServeLoop(_server(_packed(13)), flush_ms=1.0) as sl:
            with pytest.raises(ValueError):
                sl.submit(np.zeros((4,), np.float32))
            with pytest.raises(ValueError):
                sl.query(np.zeros((2, 3, 4), np.float32))
            # rows on a device are refused: the loop hashes host rows
            with pytest.raises(ValueError, match="host rows"):
                sl.submit(torch.zeros((1, 3, 4), device="meta"))

    def test_cpu_tensor_rows_accepted(self):
        server = _server(_packed(14))
        q = _queries(15, 2, 4)
        with ServeLoop(server, flush_ms=1.0) as sl:
            got = sl.query_many(torch.from_numpy(q))
        for res, one in zip(got, _alone(server, q)):
            _assert_same(res, one)

    def test_ctor_validation(self):
        server = _server(_packed(14))
        with pytest.raises(ValueError):
            ServeLoop(server, flush_ms=-1.0)
        with pytest.raises(ValueError):
            ServeLoop(server, max_batch=0)

    def test_flush_error_rejects_futures_but_loop_survives(self):
        server = _server(_packed(15))
        good = _queries(16, 1, 4)
        with ServeLoop(server, flush_ms=1.0) as sl:
            bad = sl.submit(np.zeros((1, 3, 9), np.float32))  # wrong dim
            with pytest.raises(Exception):
                bad.result(timeout=JOIN_S)
            res = sl.query(good[0])             # dispatcher still alive
        _assert_same(res, server.query_batch(good))

    def test_dispatcher_thread_state(self):
        """The dispatcher serves under inference mode, whatever the
        constructing thread's grad mode."""
        server = _server(_packed(17))
        seen = []
        real = server.query_batch

        def recording(q):
            seen.append((threading.current_thread().name,
                         torch.is_inference_mode_enabled(),
                         torch.is_grad_enabled(), q.device.type))
            return real(q)

        server.query_batch = recording
        with torch.enable_grad(), ServeLoop(server, flush_ms=1.0) as sl:
            sl.query(_queries(18, 1, 4)[0])
        assert seen == [("serve-loop-dispatch", True, False, "cpu")]


class TestBatchInvariance:
    """The scoring the loop batches: a query's scores are the same bits
    alone or among batchmates, for the plain MaxSim versions (one product
    a query) and the first stage (fixed 64-row blocks)."""

    @pytest.mark.parametrize("seed", range(4))
    def test_rows_equal_the_query_alone(self, seed):
        from repro_torch.kernels.colbert_maxsim.ref import (
            colbert_maxsim_multi_ref, colbert_maxsim_rerank_ref)
        from repro_torch.serve.retrieval import (_first_stage_scores,
                                                 _pooled_query_blocks)
        rng = np.random.default_rng(50 + seed)
        for _ in range(25):
            n_q, l = int(rng.integers(2, 9)), int(rng.integers(1, 9))
            dim = int(rng.choice([4, 8, 16, 128]))
            n, m = int(rng.integers(1, 20)), int(rng.choice([8, 16, 24]))
            q = torch.from_numpy(rng.standard_normal(
                (n_q, l, dim)).astype(np.float32))
            d = torch.from_numpy(rng.standard_normal(
                (n, m, dim)).astype(np.float32))
            dq = torch.from_numpy(rng.standard_normal(
                (n_q, n, m, dim)).astype(np.float32))
            mk = torch.from_numpy(rng.random((n, m)) < 0.8)
            mq = torch.from_numpy(rng.random((n_q, n, m)) < 0.8)
            multi = colbert_maxsim_multi_ref(q, d, mk)
            rerank = colbert_maxsim_rerank_ref(q, dq, mq)
            first = _first_stage_scores(_pooled_query_blocks(q), d[:, 0],
                                        n_q)
            for i in range(n_q):
                one = q[i:i + 1].clone()
                assert torch.equal(multi[i],
                                   colbert_maxsim_multi_ref(one, d, mk)[0])
                assert torch.equal(rerank[i], colbert_maxsim_rerank_ref(
                    one, dq[i:i + 1].clone(), mq[i:i + 1])[0])
                assert torch.equal(first[i], _first_stage_scores(
                    _pooled_query_blocks(one), d[:, 0], 1)[0])


class TestResultCache:
    def test_hit_is_bitwise_replay(self):
        server = _server(_packed(20))
        q = _queries(21, 1, 4)
        with ServeLoop(server, flush_ms=1.0) as sl:
            first = sl.query(q[0])
            second = sl.query(q[0])
        snap = sl.stats.snapshot()
        assert snap["cache_hits"] == 1 and snap["cache_misses"] == 1
        assert second is first                  # the cached answer itself
        _assert_same(second, server.query_batch(q))
        assert second.epoch_key == first.epoch_key

    def test_swap_invalidates_by_key(self):
        packed = _packed(22)
        server = _server(packed)
        q = _queries(23, 1, 4)
        with ServeLoop(server, flush_ms=1.0) as sl:
            a = sl.query(q[0])
            sl.swap_index(packed)       # same corpus, new generation
            b = sl.query(q[0])
        snap = sl.stats.snapshot()
        assert snap["cache_hits"] == 0 and snap["cache_misses"] == 2
        assert b.epoch_key[0] == a.epoch_key[0] + 1
        np.testing.assert_array_equal(a.top_idx, b.top_idx)
        np.testing.assert_array_equal(a.top_scores, b.top_scores)
        assert sl.cache_len() == 2      # both epochs' entries coexist

    def test_apply_mutation_invalidates_by_key(self):
        server = _server(_packed(24))
        q = _queries(25, 1, 4)
        with ServeLoop(server, flush_ms=1.0) as sl:
            a = sl.query(q[0])
            sl.apply_mutation(None)     # mutation_gen bump, same corpus
            b = sl.query(q[0])
        assert sl.stats.snapshot()["cache_hits"] == 0
        assert b.epoch_key[1] == a.epoch_key[1] + 1

    def test_cache_disabled(self):
        server = _server(_packed(26))
        q = _queries(27, 1, 4)
        with ServeLoop(server, flush_ms=1.0, result_cache_size=0) as sl:
            sl.query(q[0])
            sl.query(q[0])
        snap = sl.stats.snapshot()
        assert snap["cache_hits"] == 0 and snap["cache_misses"] == 2
        assert sl.cache_len() == 0

    def test_cache_lru_bounded(self):
        server = _server(_packed(28))
        q = _queries(29, 3, 4)
        with ServeLoop(server, flush_ms=1.0, result_cache_size=2) as sl:
            for i in range(3):
                sl.query(q[i])
            sl.query(q[0])              # evicted: a miss again
        assert sl.cache_len() == 2
        assert sl.stats.snapshot()["cache_hits"] == 0

    def test_degraded_answers_never_cached(self):
        server = _server(_packed(30))
        real = server.query_batch

        def degraded(q):
            out = real(q)
            out.coverage = 0.5
            return out

        server.query_batch = degraded
        q = _queries(31, 1, 4)
        with ServeLoop(server, flush_ms=1.0) as sl:
            a = sl.query(q[0])
            sl.query(q[0])
        assert a.coverage == 0.5
        assert sl.cache_len() == 0
        assert sl.stats.snapshot()["cache_hits"] == 0


class TestLoopStats:
    def test_percentiles(self):
        st = LoopStats()
        for ms in range(1, 101):
            st.record_query(ms / 1000.0, hit=False)
        snap = st.snapshot()
        assert snap["queries"] == 100
        assert abs(snap["p50_latency_s"] - 0.050) < 0.002
        assert abs(snap["p99_latency_s"] - 0.099) < 0.002

    def test_empty_is_nan(self):
        snap = LoopStats().snapshot()
        assert np.isnan(snap["p50_latency_s"])
        assert np.isnan(snap["p99_latency_s"])

    def test_window_keeps_the_newest(self):
        st = LoopStats(window=10)
        for ms in range(1, 101):
            st.record_query(ms / 1000.0, hit=ms % 2 == 0)
        snap = st.snapshot()
        assert snap["queries"] == 100 and snap["cache_hits"] == 50
        assert snap["p50_latency_s"] == pytest.approx(0.095)


@pytest.fixture
def fast_switch():
    """Threads switch every 10 us, so races show within the test."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _delta_view(tmp_path, base, seed):
    """A live delta-log view over ``base``: 4 fresh docs (2 new ids, 2
    shadowing base docs) and 2 tombstones, through the durable path."""
    path = str(tmp_path / f"art{seed}")
    index_io.save_index(path, base)
    d, masks, _ = _arrays(seed, n_docs=4)
    n = base.n_docs
    mutation_lib.append_upsert(path, torch.from_numpy(d),
                               torch.from_numpy(masks), [n, n + 1, 0, 3])
    mutation_lib.append_delete(path, [5, n + 1])
    log = mutation_lib.load_state(path, device="cpu")
    return log.base, log.view()


class TestConcurrentStress:
    def test_no_stale_closure_after_swap(self):
        a, b = _packed(30), _packed(31, n_docs=20)
        server = _server(a)
        q = _queries(32, 1, 4)
        ob = _server(b).query_batch(q)
        with ServeLoop(server, flush_ms=1.0) as sl:
            sl.query(q[0])              # builds a gen-0 closure
            sl.swap_index(b)
            res = sl.query(q[0])        # MUST be answered by b
        assert res.epoch_key[0] == 1
        _assert_same(res, ob)

    def test_threads_vs_mutating_writer_bitwise(self, tmp_path, fast_switch):
        """4 client threads x mixed (l) shapes against a closure LRU of 2
        (eviction churn), while a writer thread swaps epochs and applies
        a real delta-log view.  Every answer must be bitwise the one-row
        oracle of the corpus state its epoch_key names."""
        idx_a, idx_b = _packed(33), _packed(34, n_docs=20)
        base_b, view_b = _delta_view(tmp_path, idx_b, 35)
        server = _server(idx_a, max_cached_closures=2)
        pools = {l: _queries(35 + l, 4, l) for l in (3, 4)}
        # (generation, mutation_gen) -> the (index, view) it serves
        states = {(0, 0): (idx_a, None), (1, 1): (base_b, None),
                  (1, 2): (base_b, view_b), (2, 3): (idx_a, None)}
        results, errors = [], []
        progress = threading.Condition()
        stop, swapped, mutated = (threading.Event() for _ in range(3))

        def client(seed):
            rng = np.random.default_rng(seed)
            try:
                for step in range(12):
                    # steps 4 and 8 wait for the writer's swap and view, so
                    # each state answers some queries; the writer acts
                    # while the other clients are mid-flight
                    if step in (4, 8):
                        (swapped if step == 4 else mutated).wait(JOIN_S)
                    l = (3, 4)[(seed + step) % 2]
                    qi = int(rng.integers(4))
                    res = sl.query(pools[l][qi])
                    with progress:
                        results.append((res.epoch_key, l, qi, res))
                        progress.notify_all()
            except Exception as e:      # surfaced after join
                errors.append(e)
            finally:
                stop.set()              # first finisher ends the writer
                with progress:
                    progress.notify_all()

        def answered(n):
            with progress:
                progress.wait_for(lambda: len(results) >= n
                                  or stop.is_set(), timeout=JOIN_S)

        def writer():
            answered(8)
            sl.swap_index(base_b)               # (1, 1)
            swapped.set()
            answered(24)        # > 16 pre-swap answers: some under (1, 1)
            sl.apply_mutation(view_b)           # (1, 2)
            mutated.set()
            stop.wait(timeout=JOIN_S)
            sl.swap_index(idx_a)                # (2, 3)

        with ServeLoop(server, flush_ms=1.0, max_batch=4) as sl:
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(4)]
            wt = threading.Thread(target=writer)
            for t in threads + [wt]:
                t.start()
            for t in threads + [wt]:
                t.join(timeout=JOIN_S)
        assert not errors, errors[0]
        assert not any(t.is_alive() for t in threads + [wt])
        assert len(results) == 4 * 12
        assert len(server._search) <= 2        # the LRU held its bound
        keys = {ek[:2] for ek, _, _, _ in results}
        # each of the first three states answered some queries
        assert {(0, 0), (1, 1), (1, 2)} <= keys <= set(states)
        oracles = {}
        for key in keys:
            index, view = states[key]
            srv = _server(index)
            srv.apply_mutation(view)
            oracles[key] = {(l, qi): srv.query_batch(pools[l][qi:qi + 1])
                            for l in (3, 4) for qi in range(4)}
        for ek, l, qi, res in results:
            _assert_same(res, oracles[ek[:2]][(l, qi)])


class TestLazyViews:
    """Two readers on different batch shapes ask a fresh index for its
    derived views at once: each view is built once, and both get the
    same object."""

    @pytest.mark.parametrize("view,codec", [("pooled", {}),
                                            ("padded", {}),
                                            ("padded_residual",
                                             {"compression": "residual",
                                              "residual_bits": 4})])
    def test_built_once_under_concurrent_readers(self, view, codec,
                                                 monkeypatch, fast_switch):
        d, masks, keep = _arrays(40, n_docs=24, m=16, dim=8)
        index = TokenIndex.build(torch.from_numpy(d), torch.from_numpy(
            masks)).with_keep(torch.from_numpy(keep)).pack(**codec)
        builder = {"pooled": "_build_pooled", "padded": "_build_padded",
                   "padded_residual": "_build_padded_residual"}[view]
        real = getattr(type(index), builder)
        calls = []

        def slow(self):
            calls.append(1)
            time.sleep(0.05)            # widen the check-then-set window
            return real(self)

        monkeypatch.setattr(type(index), builder, slow)
        barrier = threading.Barrier(2)
        got = [None, None]

        def reader(i):
            barrier.wait(timeout=JOIN_S)
            got[i] = getattr(index, view)()

        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert len(calls) == 1
        assert got[0] is got[1] is not None


class TestGrid:
    """The loop in front of a server on a 2 x 2 grid of CPU positions:
    the dispatcher serves under the rules of the thread that built the
    loop, and every streamed answer equals its query served alone on
    that grid (and on one device)."""

    def _grid_rules(self, packed, replicas=1):
        from repro_torch.launch.mesh import make_serve_mesh
        from repro_torch.sharding import PlacementPlan, serve_rules
        grid = make_serve_mesh(2, [torch.device("cpu")] * 4)
        return serve_rules(grid, placement=PlacementPlan.for_index(
            packed, 2, replicas=replicas))

    def test_dispatcher_carries_the_constructing_threads_rules(self):
        from repro_torch.sharding import axis_rules, current_rules
        packed = _packed(40, n_docs=24, m=16, dim=8)
        server = _server(packed, k=5)
        rules = self._grid_rules(packed)
        seen = []
        real = server.query_batch

        def recording(q):
            seen.append(current_rules())
            return real(q)

        server.query_batch = recording
        with axis_rules(rules):
            sl = ServeLoop(server, flush_ms=1.0)
        with sl:
            sl.query(_queries(41, 1, 4, dim=8)[0])
        assert seen == [rules]

    @pytest.mark.parametrize("replicas", [1, 2])
    def test_answers_equal_each_query_alone_on_the_grid(self, replicas):
        from repro_torch.serve import health
        from repro_torch.sharding import axis_rules
        packed = _packed(42, n_docs=24, m=16, dim=8)
        q = _queries(43, 8, 4, dim=8)
        rules = self._grid_rules(packed, replicas)
        mon = health.FleetMonitor(2)
        server = _server(packed, k=5, monitor=mon)
        alone_one_device = _alone(_server(packed, k=5), q)
        results = [None] * len(q)
        errors = []

        def client(lo, hi):
            try:
                for i in range(lo, hi):
                    results[i] = sl.query(q[i])
            except Exception as e:      # re-raised below
                errors.append(e)

        with axis_rules(rules):
            alone = _alone(server, q)
            with ServeLoop(server, flush_ms=2.0, max_batch=4) as sl:
                threads = [threading.Thread(target=client,
                                            args=(2 * c, 2 * c + 2))
                           for c in range(4)]
                for t in threads:
                    t.start()
                sl.swap_index(packed)     # mid-run: only epoch_key moves
                for t in threads:
                    t.join(JOIN_S)
        assert not errors, errors[0]
        gens = set()
        for i, r in enumerate(results):
            assert r.coverage == 1.0
            gens.add(r.epoch_key[0])
            _assert_same(r, alone[i])
            _assert_same(r, alone_one_device[i])
        assert gens and gens <= {0, 1}
        assert mon.demoted == frozenset()
