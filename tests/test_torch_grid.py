"""The grid merge tier of the PyTorch port on a 2 x 2 ``hosts x
candidates`` grid of CPU positions: the checks of
``tests/_grid_cases.py`` (top-k parity under each placement and replica
count, sharded pruning, the placed artifact, fault tolerance against the
restricted oracle, the failing-over server, routed grid serving).

Each answer is held bit for bit to the port's single-device path and
within 1e-5 (ids equal) to the JAX package's single-device oracle on the
same inputs.  In place of the reference's HLO check, the streaming path
is shown to allocate no tensor led by (n_q, n_docs), while the
materializing oracle does.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import pruning_pipeline as j_pipe
from repro.serve import retrieval as j_ret
from repro_torch.core import pruning_pipeline, voronoi
from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
from repro_torch.serve import health, index_io
from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex,
                                         TopKResult, _bucket_view,
                                         _merge_topk, search, topk_search,
                                         topk_search_group)
from repro_torch.serve.routing import RoutingIndex
from repro_torch.sharding import PlacementPlan, axis_rules, serve_rules
from repro_torch.sharding.placement import bucket_weights
from test_torch_sharded_serving import (CODECS, _assert_close_to_jax,
                                        _corpus, _index, _to_jax, _unit)

HOSTS = 2
CPU = torch.device("cpu")


def _grid():
    return make_serve_mesh(HOSTS, [CPU] * 4)


def _tagged_grid():
    """A 2 x 2 grid whose rows are distinct device keys (``cpu`` and
    ``cpu:0``, one memory), so the shard cache records which group's row
    a bucket was placed on."""
    return make_serve_mesh(HOSTS, [CPU, CPU, torch.device("cpu", 0),
                                   torch.device("cpu", 0)])


def _row(grid, group):
    return tuple(grid.devices_along(("candidates",), hosts=group))


def _placements(n_buckets):
    """The reference's sweep (bytes-balanced default, everything on one
    group, round-robin), each with one and two replicas."""
    out = []
    for r in (1, 2):
        out += [(f"default/r{r}",
                 None if r == 1 else ("for_index", r)),
                (f"pinned_g0/r{r}",
                 PlacementPlan.pinned(n_buckets, HOSTS, 0, replicas=r)),
                (f"pinned_g1/r{r}",
                 PlacementPlan.pinned(n_buckets, HOSTS, 1, replicas=r)),
                (f"round_robin/r{r}",
                 PlacementPlan.round_robin(n_buckets, HOSTS, replicas=r))]
    return out


def _plan(index, plc):
    if isinstance(plc, tuple):
        return PlacementPlan.for_index(index, HOSTS, replicas=plc[1])
    return plc


def _n_buckets(index):
    return len(getattr(index, "buckets", [None]))


def _monitor(**kw):
    return health.FleetMonitor(HOSTS, retries=0, max_strikes=1,
                               backoff_base=0.001, **kw)


def _np(res):
    return np.asarray(res[0]), np.asarray(res[1])


class TestTopKParity:
    @pytest.mark.parametrize("codec", CODECS)
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_every_placement_and_replica_count(self, codec, backend):
        e, mask, keep, q, qm = _corpus(0)
        index = _index(codec, e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        one = topk_search(index, tq, k=7, q_masks=tqm, backend=backend,
                          chunk_docs=4)
        want = j_ret.topk_search(_to_jax(index), jnp.asarray(q), k=7,
                                 q_masks=jnp.asarray(qm))
        for name, plc in _placements(_n_buckets(index)):
            with axis_rules(serve_rules(_grid(),
                                        placement=_plan(index, plc))):
                got = topk_search(index, tq, k=7, q_masks=tqm,
                                  backend=backend, chunk_docs=4)
            assert torch.equal(got[0], one[0]), name
            assert torch.equal(got[1], one[1]), name
            assert got.coverage == 1.0
            _assert_close_to_jax(got, want)

    @pytest.mark.parametrize("codec", CODECS)
    def test_search_two_stage_and_e2e(self, codec):
        e, mask, keep, q, qm = _corpus(1, n_docs=30)
        index = _index(codec, e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        plc = PlacementPlan.for_index(index, HOSTS, replicas=2)
        for kw in (dict(n_first=8), dict(end_to_end=True)):
            one = search(index, tq, k=5, q_masks=tqm, return_full=False,
                         backend="fused", **kw)
            with axis_rules(serve_rules(_grid(), placement=plc)):
                got = search(index, tq, k=5, q_masks=tqm, return_full=False,
                             backend="fused", **kw)
            assert torch.equal(got[0], one[0]) and torch.equal(got[1],
                                                                one[1])

    @pytest.mark.parametrize("codec", CODECS)
    def test_k_above_docs_in_group_and_corpus(self, codec):
        e, mask, keep, q, qm = _corpus(3, n_docs=3, m=12, empty=(1,))
        index = _index(codec, e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        for k in (2, 3, 5):
            one = topk_search(index, tq, k=k, q_masks=tqm)
            for name, plc in _placements(_n_buckets(index)):
                with axis_rules(serve_rules(_grid(),
                                            placement=_plan(index, plc))):
                    got = topk_search(index, tq, k=k, q_masks=tqm)
                assert got[0].shape == (q.shape[0], min(k, 3)), name
                assert got[0].min() >= 0 and got[0].max() < 3, name
                assert torch.equal(got[0], one[0]), name
                assert torch.equal(got[1], one[1]), name

    def test_group_tier_pads_a_group_without_buckets(self):
        e, mask, keep, q, _ = _corpus(2)
        packed = _index("fp32", e, mask, keep)
        plc = PlacementPlan.pinned(len(packed.buckets), HOSTS, 0)
        with axis_rules(serve_rules(_grid(), placement=plc)):
            i, v = topk_search_group(packed, torch.tensor(q), group=1, k=4)
        assert (i == -1).all() and torch.isinf(v).all()
        with axis_rules(serve_rules(_grid(), placement=plc)):
            with pytest.raises(ValueError, match="not stored on group"):
                topk_search_group(packed, torch.tensor(q), group=1, k=4,
                                  buckets=(0,))


class _Allocations(TorchDispatchMode):
    """Shapes of the tensors each op allocates (outputs whose storage
    is none of the inputs')."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        held = {t.untyped_storage().data_ptr()
                for t in torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() not in held):
                self.shapes.append(tuple(t.shape))
        return out


class TestStreamingAllocations:
    @pytest.mark.parametrize("layout", ["dense", "fp32"])
    def test_no_n_q_by_n_docs_tensor(self, layout):
        """k = 3 keeps every candidate width a multiple of 3, so no
        (7, 64) tensor appears by chance."""
        n_q, n_docs = 7, 64
        rng = np.random.default_rng(0)
        e = _unit(rng, n_docs, 16, 8)
        index = _index(layout, e, np.ones((n_docs, 16), bool),
                       np.ones((n_docs, 16), bool))
        q = torch.tensor(_unit(rng, n_q, 6, 8))

        def led(shapes):
            return [s for s in shapes if s[:2] == (n_q, n_docs)]

        with _Allocations() as mat:
            search(index, q, k=3, end_to_end=True, return_full=True)
        assert led(mat.shapes), "the oracle no longer builds the matrix"
        for rules in (serve_rules(_grid()),
                      serve_rules(make_serve_mesh(devices=[CPU] * 4)), {}):
            with axis_rules(rules), _Allocations() as got:
                topk_search(index, q, k=3, chunk_docs=16)
                for g in range(HOSTS) if "hosts" in str(rules) else ():
                    topk_search_group(index, q, group=g, k=3, chunk_docs=16)
            assert got.shapes and not led(got.shapes), led(got.shapes)


class TestPruneParity:
    def test_prune_corpus_and_merge_on_a_data_mesh(self):
        rng = np.random.default_rng(0)
        n_docs, m, dim = 13, 24, 8
        d = (rng.normal(size=(n_docs, m, dim)) * 0.5).astype(np.float32)
        mask = np.arange(m)[None] < rng.integers(1, m + 1, n_docs)[:, None]
        s = _unit(rng, 400, dim)
        args = [torch.tensor(x) for x in (d, mask, s)]
        data = {"__mesh__": make_host_mesh([CPU] * 4)}
        for frac in (0.3, 0.7):
            ref = pruning_pipeline.prune_corpus(*args, frac)
            with axis_rules(data):
                auto = pruning_pipeline.prune_corpus(*args, frac)
                forced = pruning_pipeline.prune_corpus(*args, frac,
                                                       sharded=True)
            for got in (auto, forced):
                for a, b in zip(ref, got):
                    assert torch.equal(a, b)
            wk, wr, _ = j_pipe.prune_corpus(jnp.asarray(d),
                                            jnp.asarray(mask),
                                            jnp.asarray(s), frac,
                                            backend="reference")
            np.testing.assert_array_equal(auto[0].numpy(), np.asarray(wk))
            np.testing.assert_array_equal(auto[1].numpy(), np.asarray(wr))
        for kw in (dict(shortlist=True), dict(granularity=6)):
            ref = pruning_pipeline.pruning_order_bucketed(*args, **kw)
            with axis_rules(data):
                got = pruning_pipeline.pruning_order_bucketed(*args, **kw)
            for a, b in zip(ref, got):
                assert torch.equal(a, b)
        ranks, errs, _ = voronoi.pruning_order_batch(*args)
        for frac in (0.1, 0.5, 0.9):
            ref = voronoi.global_keep_masks(ranks, errs, args[1], frac)
            with axis_rules(data):
                got = voronoi.global_keep_masks(ranks, errs, args[1], frac,
                                                sharded=True)
            assert torch.equal(ref, got)


class TestArtifact:
    def test_placed_artifact_whole_and_by_group(self):
        e, mask, keep, q, qm = _corpus(5, n_docs=26, m=16, empty=(7,))
        packed = _index("fp32", e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        ref_i, ref_s = topk_search(packed, tq, k=5, q_masks=tqm)
        want = j_ret.topk_search(_to_jax(packed), jnp.asarray(q), k=5,
                                 q_masks=jnp.asarray(qm))
        plc = PlacementPlan.for_index(packed, HOSTS)
        with tempfile.TemporaryDirectory() as td:
            index_io.save_index(td, packed, placement=plc)
            assert index_io.load_placement(td) == plc
            whole = index_io.load_index(td, device="cpu")
            with axis_rules(serve_rules(_grid(), placement=plc)):
                got = topk_search(whole, tq, k=5, q_masks=tqm)
            assert torch.equal(got[0], ref_i) and torch.equal(got[1], ref_s)
            _assert_close_to_jax(got, want)
            vals, ids = [], []
            for g in range(HOSTS):
                sub = index_io.load_index(td, group=g, device="cpu")
                assert len(sub.buckets) == len(plc.buckets_of(g))
                assert sub.n_docs == packed.n_docs
                if len(sub.buckets) < len(packed.buckets):
                    with axis_rules(serve_rules(_grid())):
                        with pytest.raises(ValueError, match="partial"):
                            topk_search(sub, tq, k=5, q_masks=tqm)
                sub_plan = PlacementPlan(n_groups=HOSTS,
                                         groups=(g,) * len(sub.buckets))
                with axis_rules(serve_rules(_grid())):
                    gi, gv = topk_search_group(sub, tq, group=g, k=5,
                                               q_masks=tqm,
                                               placement=sub_plan)
                ids.append(gi)
                vals.append(gv)
            mi, mv = _merge_topk(torch.cat(vals, 1), torch.cat(ids, 1), 5)
            assert torch.equal(mi, ref_i) and torch.equal(mv, ref_s)
        # the server keeps one closure per mesh context, answers alike
        srv = RetrievalServer(packed, k=5, n_first=packed.n_docs)
        a = srv.query_batch(tq)
        with axis_rules(serve_rules(_grid(), placement=plc)):
            b = srv.query_batch(tq)
        assert len(srv._search) == 2
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _restricted_oracle(packed, surviving, q, qm, k):
    """The port's single-device answer over ``surviving`` buckets only
    (doc ids stay corpus-global)."""
    sub = _bucket_view(packed, tuple(surviving))
    if sub is None:
        return (np.zeros((q.shape[0], 0), np.int32),
                np.zeros((q.shape[0], 0), np.float32))
    return _np(topk_search(sub, q, k=k, q_masks=qm))


class TestFaultTolerance:
    def setup_method(self):
        e, mask, keep, q, qm = _corpus(7, n_docs=29, m=18, empty=(3, 11))
        self.packed = _index("fp32", e, mask, keep)
        self.q, self.qm = torch.tensor(q), torch.tensor(qm)
        self.jq, self.jqm = jnp.asarray(q), jnp.asarray(qm)
        self.ref = _np(topk_search(self.packed, self.q, k=6,
                                   q_masks=self.qm))

    def _serve(self, plc, k=6, **kw):
        with axis_rules(serve_rules(_grid(), placement=plc)):
            return topk_search(self.packed, self.q, k=k, q_masks=self.qm,
                               **kw)

    def test_replicated_unmonitored_dedupes(self):
        """Replicas 2 without a monitor answer bit-equal, each bucket
        scored once, on the first group of its chain (so no replica is
        scored twice and the merge has no duplicate to drop)."""
        plc = PlacementPlan.for_index(self.packed, HOSTS, replicas=2)
        got = _np(self._serve(plc))
        np.testing.assert_array_equal(got[0], self.ref[0])
        np.testing.assert_array_equal(got[1], self.ref[1])
        grid = _tagged_grid()
        self.packed._shards.clear()
        with axis_rules(serve_rules(grid, placement=plc)):
            got = _np(topk_search(self.packed, self.q, k=6, q_masks=self.qm))
        np.testing.assert_array_equal(got[0], self.ref[0])
        np.testing.assert_array_equal(got[1], self.ref[1])
        assert set(self.packed._shards) == {
            (b, _row(grid, plc.replicas_of(b)[0]))
            for b in range(plc.n_buckets)}

    @pytest.mark.parametrize("fault", ["dispatch", "mid-exchange",
                                       "deadline"])
    @pytest.mark.parametrize("lost", [0, 1])
    def test_replicas_two_fail_over_bit_equal(self, fault, lost):
        plc = PlacementPlan.for_index(self.packed, HOSTS, replicas=2)
        make = {"dispatch": lambda g: health.kill_group(g),
                "mid-exchange": lambda g: health.kill_group(g, when="after"),
                "deadline": lambda g: health.delay_group(g, 1.0)}[fault]
        # a deadline a loaded CPU meets with room: only the delay blows it
        mon = _monitor(exchange_timeout=0.25 if fault == "deadline"
                       else None)
        faults = health.FaultPlan([make(lost)])
        res = self._serve(plc, monitor=mon, faults=faults)
        assert res.coverage == 1.0
        np.testing.assert_array_equal(_np(res)[0], self.ref[0])
        np.testing.assert_array_equal(_np(res)[1], self.ref[1])
        assert mon.demoted == frozenset({lost})
        res2 = self._serve(plc, monitor=mon, faults=faults)
        assert res2.coverage == 1.0
        np.testing.assert_array_equal(_np(res2)[0], self.ref[0])

    @pytest.mark.parametrize("lost", [0, 1])
    def test_replicas_one_degrades_to_the_restricted_oracle(self, lost):
        plc = PlacementPlan.for_index(self.packed, HOSTS)
        n_buckets = len(self.packed.buckets)
        surviving = [b for b in range(n_buckets) if plc.group_of(b) != lost]
        assert surviving and len(surviving) < n_buckets
        weights = bucket_weights(self.packed)
        for k in (6, 10 * self.packed.n_docs):
            mon = _monitor()
            res = self._serve(plc, k=k, monitor=mon,
                              faults=health.FaultPlan(
                                  [health.kill_group(lost)]))
            want = sum(weights[b] for b in surviving) / sum(weights)
            assert abs(res.coverage - want) < 1e-12 and res.coverage < 1
            oi, ov = _restricted_oracle(self.packed, surviving, self.q,
                                        self.qm, k)
            np.testing.assert_array_equal(_np(res)[0], oi)
            np.testing.assert_array_equal(_np(res)[1], ov)
            assert np.isfinite(ov).all()
            assert oi.min() >= 0 and oi.max() < self.packed.n_docs
            jsub = j_ret._bucket_view(_to_jax(self.packed), tuple(surviving))
            _assert_close_to_jax(res, j_ret.topk_search(
                jsub, self.jq, k=k, q_masks=self.jqm))

    def test_every_replica_lost_and_no_monitor(self):
        plc = PlacementPlan.for_index(self.packed, HOSTS)
        mon = _monitor()
        res = self._serve(plc, monitor=mon, faults=health.FaultPlan(
            [health.kill_group(g) for g in range(HOSTS)]))
        assert res.coverage == 0.0 and res[0].shape == (self.q.shape[0], 0)
        assert mon.demoted == frozenset(range(HOSTS))
        with pytest.raises(health.GroupFailure):
            self._serve(plc, faults=health.FaultPlan(
                [health.kill_group(0)]))

    def test_deadline_waits_for_arrival(self, monkeypatch):
        """A fetch returns only once its block is on the root device, so
        a group whose copy lands late overruns the deadline."""
        import time
        from repro_torch.serve import retrieval
        slow = retrieval._arrive

        def late(block, root):
            time.sleep(1.0)
            return slow(block, root)

        monkeypatch.setattr(retrieval, "_arrive", late)
        plc = PlacementPlan.for_index(self.packed, HOSTS, replicas=2)
        mon = _monitor(exchange_timeout=0.25)
        res = self._serve(plc, monitor=mon)
        assert res.coverage == 0.0 and mon.demoted == frozenset({0, 1})


class TestFailoverServer:
    def setup_method(self):
        e, mask, keep, q, _ = _corpus(9, n_docs=23, m=16, empty=(2,))
        self.packed = _index("fp32", e, mask, keep)
        self.q = torch.tensor(q)
        self.ref = _np(topk_search(self.packed, self.q, k=5))
        self.plc1 = PlacementPlan.for_index(self.packed, HOSTS)
        self.plc2 = PlacementPlan.for_index(self.packed, HOSTS, replicas=2)

    def _server(self, **kw):
        return RetrievalServer(self.packed, k=5, n_first=self.packed.n_docs,
                               **kw)

    @pytest.mark.parametrize("lost", [0, 1])
    def test_group_dies_between_warmup_and_query(self, lost):
        mon = _monitor()
        srv = self._server(monitor=mon)
        with axis_rules(serve_rules(_grid(), placement=self.plc2)):
            warm = srv.query_batch(self.q)
            assert warm.coverage == 1.0
            mon.demote(lost)
            res = srv.query_batch(self.q)
        assert res.coverage == 1.0
        np.testing.assert_array_equal(res[0], self.ref[0])
        np.testing.assert_array_equal(res[1], self.ref[1])

    def test_warmup_places_what_serving_and_failover_read(self):
        """Warm-up places each bucket once on every group storing it; the
        first query and a failover after a group's loss read those
        placements and place nothing more."""
        mon = _monitor()
        srv = self._server(monitor=mon)
        grid = _tagged_grid()
        with axis_rules(serve_rules(grid, placement=self.plc2)):
            srv._closure_for(self.q)
            warm = dict(self.packed._shards)
            assert set(warm) == {(b, _row(grid, g)) for g in range(HOSTS)
                                 for b in self.plc2.buckets_of(g)}
            healthy = srv.query_batch(self.q)
            mon.demote(0)
            failover = srv.query_batch(self.q)
        assert set(self.packed._shards) == set(warm)
        assert all(self.packed._shards[key] is v for key, v in warm.items())
        for res in (healthy, failover):
            assert res.coverage == 1.0
            np.testing.assert_array_equal(res[0], self.ref[0])
            np.testing.assert_array_equal(res[1], self.ref[1])

    def test_injected_fault_at_round_one(self):
        mon = _monitor()
        faults = health.FaultPlan([health.kill_group(0, from_round=1)])
        srv = self._server(monitor=mon, faults=faults)
        with axis_rules(serve_rules(_grid(), placement=self.plc2)):
            warm = srv.query_batch(self.q)
            assert warm.coverage == 1.0 and not mon.demoted
            res = srv.query_batch(self.q)
        assert res.coverage == 1.0 and mon.demoted == frozenset({0})
        np.testing.assert_array_equal(res[0], self.ref[0])
        np.testing.assert_array_equal(res[1], self.ref[1])

    def test_degrade(self):
        srv = self._server(monitor=_monitor(), faults=health.FaultPlan(
            [health.kill_group(1)]))
        with axis_rules(serve_rules(_grid(), placement=self.plc1)):
            res = srv.query_batch(self.q)
        assert isinstance(res, TopKResult) and res.coverage < 1.0
        surviving = [b for b in range(len(self.packed.buckets))
                     if self.plc1.group_of(b) != 1]
        oi, ov = _restricted_oracle(self.packed, surviving, self.q, None, 5)
        np.testing.assert_array_equal(res[0], oi)
        np.testing.assert_array_equal(res[1], ov)

    def test_rebalance(self):
        srv = self._server(monitor=_monitor(), on_group_loss="rebalance",
                           faults=health.FaultPlan([health.kill_group(1)]))
        with axis_rules(serve_rules(_grid(), placement=self.plc1)):
            res = srv.query_batch(self.q)
            assert res.coverage == 1.0
            np.testing.assert_array_equal(res[0], self.ref[0])
            np.testing.assert_array_equal(res[1], self.ref[1])
            assert all(1 not in srv._placement.replicas_of(b)
                       for b in range(len(self.packed.buckets)))
            res2 = srv.query_batch(self.q)
        assert res2.coverage == 1.0
        np.testing.assert_array_equal(res2[0], self.ref[0])

    def test_fail(self):
        srv = self._server(monitor=_monitor(), on_group_loss="fail",
                           faults=health.FaultPlan([health.kill_group(1)]))
        with axis_rules(serve_rules(_grid(), placement=self.plc1)):
            with pytest.raises(health.DegradedCoverage):
                srv.query_batch(self.q)

    def test_policy_validated(self):
        with pytest.raises(ValueError, match="on_group_loss"):
            self._server(on_group_loss="retry")


class TestRoutedGrid:
    def setup_method(self):
        rng = np.random.default_rng(12)
        n_docs, m, dim, n_clusters = 64, 32, 8, 4
        centers = rng.normal(size=(n_clusters, dim))
        centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
        lab = np.repeat(np.arange(n_clusters), n_docs // n_clusters)
        emb = centers[lab][:, None, :] + 0.08 * rng.normal(
            size=(n_docs, m, dim))
        emb = (emb / np.linalg.norm(emb, axis=-1, keepdims=True)).astype(
            np.float32)
        kept = np.maximum(((lab + 1) * m) // n_clusters, 1)
        keep = np.arange(m)[None, :] < kept[:, None]
        self.packed = TokenIndex.build(
            torch.tensor(emb), torch.ones(n_docs, m, dtype=torch.bool)
        ).with_keep(torch.tensor(keep)).pack()
        assert len(self.packed.buckets) >= 3
        self.routing = RoutingIndex.build(self.packed, n_centroids=4)
        q = centers[1][None, None, :] + 0.05 * np.random.default_rng(
            13).normal(size=(6, 5, dim))
        self.q = torch.tensor((q / np.linalg.norm(
            q, axis=-1, keepdims=True)).astype(np.float32))
        self.ref = topk_search(self.packed, self.q, k=5)

    def test_bounded_bit_equal_under_every_placement(self):
        for name, plc in _placements(len(self.packed.buckets)):
            st = {}
            with axis_rules(serve_rules(_grid(), placement=_plan(
                    self.packed, plc))):
                got = topk_search(self.packed, self.q, k=5, route="bounded",
                                  routing=self.routing, route_stats=st)
            assert torch.equal(got[0], self.ref[0]), name
            assert torch.equal(got[1], self.ref[1]), name
            assert 0 < st["groups_consulted"] <= st["n_groups"] == HOSTS

    def test_nprobe_consults_a_subset_and_unconsulted_groups_are_immune(
            self):
        plc = PlacementPlan.round_robin(len(self.packed.buckets), HOSTS)
        st = {}
        with axis_rules(serve_rules(_grid(), placement=plc)):
            ri, _ = topk_search(self.packed, self.q, k=5, route="nprobe",
                                routing=self.routing, n_probe=1,
                                route_stats=st)
        assert st["buckets_scored"] < st["n_buckets"]
        assert st["groups_consulted"] < st["n_groups"]
        immune = 0
        for g in range(HOSTS):
            mon = _monitor()
            with axis_rules(serve_rules(_grid(), placement=plc)):
                res = topk_search(self.packed, self.q, k=5, route="nprobe",
                                  routing=self.routing, n_probe=1,
                                  monitor=mon, faults=health.FaultPlan(
                                      [health.kill_group(g)]))
            if not mon.demoted:
                immune += 1
                assert torch.equal(res[0], ri) and res.coverage == 1.0
        assert immune == HOSTS - st["groups_consulted"]
