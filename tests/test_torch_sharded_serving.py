"""Sharded serving and sharded pruning of the PyTorch port on meshes of
repeated CPU positions (``launch.mesh`` with ``devices=[cpu] * n``).

Every sharded result is held bit for bit to the port's single-device
path (a doc's score does not depend on which docs share its shard or
slab, and every merge orders on (-score, id)), and the single-device
inputs go through the JAX package's single-device ``topk_search``,
``global_keep_masks`` and ``prune_corpus`` too: scores within 1e-5, ids
and keep masks equal (the fixtures' gaps exceed that).  The reference's
own sharded paths are not the oracle here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning_pipeline as j_pipe
from repro.core import voronoi as j_vor
from repro.serve import index as j_index
from repro.serve import retrieval as j_ret
from repro_torch.core import pruning_pipeline, voronoi
from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
from repro_torch.serve import retrieval
from repro_torch.serve.index import PackedBucket
from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex,
                                         search, topk_search)
from repro_torch.serve.routing import RoutingIndex
from repro_torch.sharding import axis_rules, serve_rules

ATOL = 1e-5
CPU = torch.device("cpu")
CODECS = ["dense", "fp32", "bf16", "int8", "residual"]


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed, n_docs=37, m=20, dim=8, n_q=6, l=5, empty=(0, 17)):
    """Unit docs with ragged masks, a bernoulli keep and ``empty`` docs
    pruned to nothing; queries with ragged masks (numpy)."""
    rng = np.random.default_rng(seed)
    e = _unit(rng, n_docs, m, dim)
    mask = np.arange(m)[None] < rng.integers(1, m + 1, n_docs)[:, None]
    keep = rng.random((n_docs, m)) < 0.6
    keep[list(empty)] = False
    q = _unit(rng, n_q, l, dim)
    qm = np.arange(l)[None] < rng.integers(1, l + 1, n_q)[:, None]
    return e, mask, keep, q, qm


def _index(codec, e, mask, keep):
    t = TokenIndex.build(torch.tensor(e), torch.tensor(mask)).with_keep(
        torch.tensor(keep))
    if codec == "dense":
        return t
    if codec == "bf16":
        return TokenIndex(t.d_embs.bfloat16(), t.d_masks, t.keep).pack()
    kw = {"fp32": {}, "int8": {"compression": "int8"},
          "residual": {"compression": "residual", "residual_bits": 4}}
    return t.pack(**kw[codec])


def _to_jax(index):
    """The same index in the JAX package: its arrays as they are (bf16
    docs widened to fp32, which is exact)."""
    if isinstance(index, TokenIndex):
        return j_ret.TokenIndex(jnp.asarray(index.d_embs.float().numpy()),
                                jnp.asarray(index.d_masks.numpy()),
                                jnp.asarray(index.keep.numpy()))
    def arr(t):
        return None if t is None else jnp.asarray(
            t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())
    buckets = [j_index.PackedBucket(
        cap=b.cap, doc_ids=arr(b.doc_ids), masks=arr(b.masks),
        embs=arr(b.embs), q8=arr(b.q8), scales=arr(b.scales),
        codes=arr(b.codes), resq=arr(b.resq), rscale=arr(b.rscale),
        codebook=arr(b.codebook)) for b in index.buckets]
    return j_index.PackedIndex(
        n_docs=index.n_docs, m=index.m, dim=index.dim,
        tokens_total=index.tokens_total, compression=index.compression,
        buckets=buckets, residual_bits=index.residual_bits)


def _assert_close_to_jax(got, want):
    gi, gs = (np.asarray(x) for x in got[:2])
    wi, ws = (np.asarray(x) for x in want[:2])
    np.testing.assert_array_equal(gi, wi)
    real = ws > -1e29
    np.testing.assert_allclose(gs[real], ws[real], atol=ATOL)
    np.testing.assert_allclose(gs[~real], ws[~real], rtol=1e-6)


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _flat(n):
    return serve_rules(make_serve_mesh(devices=[CPU] * n))


class TestShardedTopK:
    @pytest.mark.parametrize("codec", CODECS)
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_equals_single_device_and_jax(self, codec, backend, n_shards):
        e, mask, keep, q, qm = _corpus(0)
        index = _index(codec, e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        one = topk_search(index, tq, k=7, q_masks=tqm, backend=backend,
                          chunk_docs=4)
        with axis_rules(_flat(n_shards)):
            got = topk_search(index, tq, k=7, q_masks=tqm, backend=backend,
                              chunk_docs=4)
        _equal(got, one)
        want = j_ret.topk_search(_to_jax(index), jnp.asarray(q), k=7,
                                 q_masks=jnp.asarray(qm),
                                 backend="reference")
        _assert_close_to_jax(got, want)

    @pytest.mark.parametrize("codec", CODECS)
    @pytest.mark.parametrize("k", [2, 3, 5])
    def test_k_above_docs_in_shard_and_corpus(self, codec, k):
        """3 docs (one pruned empty) over 4 shards: shard pads and empty
        shards never displace or leak; output width min(k, 3)."""
        e, mask, keep, q, qm = _corpus(3, n_docs=3, m=12, empty=(1,))
        index = _index(codec, e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        one = topk_search(index, tq, k=k, q_masks=tqm)
        with axis_rules(_flat(4)):
            got = topk_search(index, tq, k=k, q_masks=tqm)
        _equal(got, one)
        assert got[0].shape == (q.shape[0], min(k, 3))
        assert got[0].min() >= 0 and got[0].max() < 3
        want = j_ret.topk_search(_to_jax(index), jnp.asarray(q), k=k,
                                 q_masks=jnp.asarray(qm))
        _assert_close_to_jax(got, want)

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_empty_bucket_never_displaces_real_empty_doc(self, backend):
        """A zero-doc bucket's shard pads (id -1) score -inf below a real
        empty-after-prune doc's finite sentinel."""
        e, mask, keep, q, _ = _corpus(4, n_docs=6, m=16, empty=(0,))
        packed = _index("fp32", e, mask, keep)
        packed.buckets.insert(0, PackedBucket(
            cap=8, doc_ids=torch.zeros(0, dtype=torch.int32),
            masks=torch.zeros(0, 8, dtype=torch.bool),
            embs=torch.zeros(0, 8, 8)))
        tq = torch.tensor(q)
        for k in (6, 10):
            with axis_rules(_flat(4)):
                got = topk_search(packed, tq, k=k, backend=backend)
            assert got[0].shape == (q.shape[0], 6)
            assert got[0].min() >= 0
            _equal(got, topk_search(packed, tq, k=k, backend=backend))
        full = j_ret.maxsim_scores(_to_jax(_index("fp32", e, mask, keep)),
                                   jnp.asarray(q), backend="reference")
        ws, wi = j_ret.jax.lax.top_k(full, 6)
        _assert_close_to_jax(got, (wi, ws))

    def test_two_stage_and_full_under_a_mesh(self):
        e, mask, keep, q, qm = _corpus(5, n_docs=40)
        index = _index("fp32", e, mask, keep)
        tq, tqm = torch.tensor(q), torch.tensor(qm)
        for kw in (dict(n_first=8, return_full=False),
                   dict(n_first=8, return_full=True),
                   dict(end_to_end=True, return_full=False)):
            one = search(index, tq, k=5, q_masks=tqm, **kw)
            with axis_rules(_flat(4)):
                got = search(index, tq, k=5, q_masks=tqm, **kw)
            for a, b in zip(got, one):
                assert torch.equal(a, b), kw

    def test_bounded_route_under_a_mesh(self):
        e, mask, keep, q, _ = _corpus(6, n_docs=48, m=24)
        index = _index("fp32", e, mask, keep)
        table = RoutingIndex.build(index, n_centroids=2)
        tq = torch.tensor(q)
        one = topk_search(index, tq, k=5)
        with axis_rules(_flat(4)):
            got = topk_search(index, tq, k=5, route="bounded",
                              routing=table)
        _equal(got, one)

    def test_mutation_under_a_mesh_raises(self):
        e, mask, keep, q, _ = _corpus(7)
        index = _index("fp32", e, mask, keep)
        view = retrieval.MutationView(
            deltas=(), owner=torch.zeros(index.n_docs, dtype=torch.int32),
            n_live=index.n_docs)
        with axis_rules(_flat(2)):
            with pytest.raises(ValueError, match="single-device"):
                topk_search(index, torch.tensor(q), k=3, mutation=view)

    def test_shards_placed_once_per_epoch(self):
        e, mask, keep, q, _ = _corpus(8)
        index = _index("fp32", e, mask, keep)
        tq = torch.tensor(q)
        with axis_rules(_flat(4)):
            topk_search(index, tq, k=3)
            placed = dict(index._shards)
            topk_search(index, tq, k=5)
        assert set(placed) == {(b, (CPU,) * 4)
                               for b in range(len(index.buckets))}
        assert all(index._shards[key] is v for key, v in placed.items())
        assert len(index._shards) == len(placed)
        # on the index's own device a shard without pads views the bucket
        b = index.buckets[0]
        e0 = placed[0, (CPU,) * 4][0][0]
        assert e0.untyped_storage().data_ptr() == \
            b.embs.untyped_storage().data_ptr()


class TestServerUnderAMesh:
    @pytest.mark.parametrize("n_first", [8, 1000])
    def test_round_trip_and_closure_keys(self, n_first):
        e, mask, keep, q, _ = _corpus(9, n_docs=30)
        packed = _index("fp32", e, mask, keep)
        srv = RetrievalServer(packed, k=5, n_first=n_first)
        a = srv.query_batch(torch.tensor(q))
        with axis_rules(_flat(4)):
            b = srv.query_batch(torch.tensor(q))
        grid = make_serve_mesh(2, [CPU] * 4)
        with axis_rules(serve_rules(grid)):
            c = srv.query_batch(q)
        assert len(srv._search) == 3      # one closure per mesh
        for r in (b, c):
            np.testing.assert_array_equal(a[0], r[0])
            np.testing.assert_array_equal(a[1], r[1])
            assert r.coverage == 1.0
        want = j_ret.RetrievalServer(_to_jax(packed), k=5,
                                     n_first=n_first).query_batch(
            jnp.asarray(q))
        _assert_close_to_jax(b, want)

    def test_closure_keeps_the_rules_it_was_built_under(self):
        """A closure built under a mesh serves on it whatever the
        calling thread's rules are."""
        e, mask, keep, q, _ = _corpus(10)
        packed = _index("fp32", e, mask, keep)
        srv = RetrievalServer(packed, k=5, n_first=packed.n_docs)
        tq = torch.tensor(q)
        with axis_rules(_flat(4)):
            fn = srv._closure_for(tq)
        packed._shards.clear()
        fn(tq)
        assert (0, (CPU,) * 4) in packed._shards


def _prune_case(seed=0, n_docs=13, m=24, dim=8, n_samples=400):
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(n_docs, m, dim)) * 0.5).astype(np.float32)
    mask = np.arange(m)[None] < rng.integers(1, m + 1, n_docs)[:, None]
    return d, mask, _unit(rng, n_samples, dim)


def _data_rules(n=4):
    return {"__mesh__": make_host_mesh([CPU] * n)}


class TestShardedPruning:
    @pytest.mark.parametrize("frac", [0.1, 0.3, 0.5, 0.7, 0.9])
    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_global_keep_masks_equal_flat_and_jax(self, frac, n_shards):
        d, mask, s = _prune_case(1)
        args = [torch.tensor(x) for x in (d, mask, s)]
        ranks, errs, _ = voronoi.pruning_order_batch(*args)
        flat = voronoi.global_keep_masks(ranks, errs, args[1], frac)
        with axis_rules(_data_rules(n_shards)):
            auto = voronoi.global_keep_masks(ranks, errs, args[1], frac)
            forced = voronoi.global_keep_masks(ranks, errs, args[1], frac,
                                               sharded=True)
        assert torch.equal(auto, flat) and torch.equal(forced, flat)
        want = j_vor.global_keep_masks(jnp.asarray(ranks.numpy()),
                                       jnp.asarray(errs.numpy()),
                                       jnp.asarray(mask), frac)
        np.testing.assert_array_equal(flat.numpy(), np.asarray(want))

    @pytest.mark.parametrize("frac", [0.2, 0.5, 0.8])
    def test_ties_signed_zeros_and_negatives(self, frac):
        """Equal keys across shards prune in global flat order; -0.0
        ties +0.0; a negative key (not produced by Eq. 8, but ordered
        all the same) sorts below every nonnegative one."""
        rng = np.random.default_rng(2)
        n_docs, m = 9, 7
        ranks = np.stack([rng.permutation(m) for _ in range(n_docs)]
                         ).astype(np.int32)
        errs = rng.choice(np.array([0.0, -0.0, 0.25, 0.5, -1.5, 2.0],
                                   np.float32), size=(n_docs, m))
        errs[ranks == m - 1] = np.inf          # each doc's survivor
        mask = rng.random((n_docs, m)) < 0.85
        args = [torch.tensor(x) for x in (ranks, errs, mask)]
        flat = voronoi.global_keep_masks(*args, frac)
        for n in (2, 3, 4):
            with axis_rules(_data_rules(n)):
                got = voronoi.global_keep_masks(*args, frac, sharded=True)
            assert torch.equal(got, flat), n

    @pytest.mark.parametrize("frac", [0.3, 0.7])
    @pytest.mark.parametrize("backend", ["reference", "shortlist",
                                         "shortlist_topk", "fused"])
    def test_prune_corpus_equals_flat(self, frac, backend):
        d, mask, s = _prune_case(3)
        args = [torch.tensor(x) for x in (d, mask, s)]
        flat = pruning_pipeline.prune_corpus(*args, frac, backend=backend)
        with axis_rules(_data_rules()):
            got = pruning_pipeline.prune_corpus(*args, frac, backend=backend)
        for a, b in zip(got, flat):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("kw", [dict(shortlist=True),
                                    dict(granularity=6), {}])
    def test_bucketed_orders_equal_flat(self, kw):
        d, mask, s = _prune_case(4)
        args = [torch.tensor(x) for x in (d, mask, s)]
        flat = pruning_pipeline.pruning_order_bucketed(*args, **kw)
        with axis_rules(_data_rules()):
            got = pruning_pipeline.pruning_order_bucketed(*args, **kw)
        for a, b in zip(got, flat):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("frac", [0.3, 0.5])
    def test_prune_corpus_matches_jax(self, frac):
        rng = np.random.default_rng(5)
        e = _unit(rng, 10, 24, 16)
        mask = np.arange(24)[None] < rng.integers(5, 25, 10)[:, None]
        s = _unit(rng, 512, 16)
        with axis_rules(_data_rules()):
            gk, gr, ge = pruning_pipeline.prune_corpus(
                torch.tensor(e), torch.tensor(mask), torch.tensor(s), frac)
        wk, wr, we = j_pipe.prune_corpus(jnp.asarray(e), jnp.asarray(mask),
                                         jnp.asarray(s), frac,
                                         backend="reference")
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
        fin = np.isfinite(np.asarray(we))
        np.testing.assert_allclose(ge.numpy()[fin], np.asarray(we)[fin],
                                   atol=ATOL)

    def test_forced_without_mesh_raises(self):
        d, mask, s = _prune_case(6)
        with pytest.raises(ValueError, match="pruning_order_bucketed"):
            pruning_pipeline.prune_corpus(
                *[torch.tensor(x) for x in (d, mask, s)], 0.5, sharded=True)


class TestPlainScorerPerDoc:
    """The plain MaxSim versions score each doc with a product of its
    own, so a doc's score is the same bits whichever docs share the call
    (a product over all docs at once, the einsum this replaced, gave
    other bits to a doc of a small slab on the CPU)."""

    @pytest.mark.parametrize("seed", range(3))
    def test_slices_and_pads_give_the_same_bits(self, seed):
        from repro_torch.kernels.colbert_maxsim.ref import (
            colbert_maxsim_multi_ref, colbert_maxsim_ref)
        rng = np.random.default_rng(70 + seed)
        for n, m, l, dim in [(3, 8, 5, 8), (37, 16, 5, 8), (40, 32, 32,
                                                              128)]:
            q = torch.tensor(rng.normal(size=(4, l, dim)).astype(
                np.float32))
            d = torch.tensor(rng.normal(size=(n, m, dim)).astype(
                np.float32))
            mk = torch.tensor(rng.random((n, m)) < 0.8)
            full = colbert_maxsim_multi_ref(q, d, mk)
            for s in (1, 2, 3, 7):
                parts = torch.cat([colbert_maxsim_multi_ref(
                    q, d[a:a + s], mk[a:a + s]) for a in range(0, n, s)], 1)
                assert torch.equal(parts, full), (n, s)
                pad = torch.cat([d[:1], torch.zeros(s, m, dim)])
                pmk = torch.cat([mk[:1], torch.zeros(s, m, dtype=torch.bool)])
                assert torch.equal(colbert_maxsim_multi_ref(q, pad, pmk)[:, 0],
                                   full[:, 0])
            assert torch.equal(colbert_maxsim_ref(q[0], d[:2], mk[:2]),
                               full[0, :2])
