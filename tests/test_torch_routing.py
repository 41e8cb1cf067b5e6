"""Candidate routing and token pooling of the PyTorch port against the
JAX reference, on the same numpy corpora.

Lloyd's init draws its priorities from ``jax.random`` in the reference
and from a ``torch.Generator`` in the port; no torch generator
reproduces the JAX stream, so these tests compute the reference's init
points and inject them into the port (``routing._init_indices``).  From
the same start, centroids agree within 1e-6 (the centroid sums run in
another order), the bucket selections are equal and routed top-k ids
are equal; scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning_pipeline as j_pp
from repro.serve import retrieval as j_ret
from repro.serve import routing as j_routing
from repro_torch.core import pruning_pipeline
from repro_torch.serve import retrieval, routing
from repro_torch.serve.routing import RoutingIndex

ATOL = 1e-5


def jax_init_indices(mask, k, seed, bucket_index):
    """The reference's Lloyd's init (``_lloyd``'s seeded priorities under
    ``fold_in(PRNGKey(seed), bucket_index)``, then ``lax.top_k``) in the
    shape of the port's ``_init_indices``."""
    m = jnp.asarray(mask.cpu().numpy())
    key = jax.random.fold_in(jax.random.PRNGKey(seed), bucket_index)
    pri = jnp.where(m, jax.random.uniform(key, m.shape), -jnp.inf)
    top, idx = jax.lax.top_k(pri, k)
    return (torch.as_tensor(np.array(idx), dtype=torch.long,
                            device=mask.device),
            torch.as_tensor(np.array(top > -jnp.inf), device=mask.device))


@pytest.fixture
def jax_init(monkeypatch):
    monkeypatch.setattr(routing, "_init_indices", jax_init_indices)


def _corpus(seed, n_docs=40, m=12, dim=8, clustered=False):
    """Unit token embeddings, ragged lengths, random keep masks, one doc
    pruned to nothing; ``clustered`` ties content to kept length so
    routing has structure to find."""
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(4, dim))
        lab = rng.integers(0, 4, n_docs)
        e = centers[lab][:, None, :] + 0.1 * rng.normal(size=(n_docs, m, dim))
        lens = np.array([2, 4, 8, 12])[lab]
    else:
        e = rng.normal(size=(n_docs, m, dim))
        lens = rng.integers(2, m + 1, n_docs)
    e = (e / np.linalg.norm(e, axis=-1, keepdims=True)).astype(np.float32)
    mask = np.arange(m)[None, :] < lens[:, None]
    keep = (rng.random((n_docs, m)) < 0.7) | clustered
    keep[5] = False
    return e, mask, keep


def _queries(seed, n_q=5, l=4, dim=8):
    rng = np.random.default_rng(seed + 50)
    q = rng.normal(size=(n_q, l, dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qm = np.ones((n_q, l), bool)
    qm[1, 2:] = False
    return q, qm


def _pack_both(e, mask, keep, **kw):
    jp = j_ret.TokenIndex.build(jnp.asarray(e), jnp.asarray(mask)
                                ).with_keep(jnp.asarray(keep)).pack(**kw)
    tp = retrieval.TokenIndex.build(torch.tensor(e), torch.tensor(mask)
                                    ).with_keep(torch.tensor(keep)).pack(**kw)
    return jp, tp


class TestPoolTokens:
    @pytest.mark.parametrize("threshold", [0.5, 0.9, 1.0])
    def test_matches_jax(self, threshold):
        e, mask, keep = _corpus(0, clustered=True)
        e[3, 1] = e[3, 0]                  # exact duplicates pool at 1.0
        e[3, 4] = e[3, 0]
        want_e, want_k = j_pp.pool_tokens(e, keep & mask, threshold)
        got_e, got_k = pruning_pipeline.pool_tokens(
            torch.tensor(e), torch.tensor(keep & mask), threshold)
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_allclose(got_e, want_e, atol=1e-6)
        assert got_k.sum() < (keep & mask).sum()

    def test_rejects_bad_threshold(self):
        with pytest.raises(ValueError, match="threshold"):
            pruning_pipeline.pool_tokens(np.zeros((1, 2, 4)),
                                         np.ones((1, 2), bool), 0.0)


class TestSelection:
    @pytest.mark.parametrize("n_probe,threshold",
                             [(1, None), (2, None), (3, 0.5), (9, None)])
    def test_nprobe_matches_jax(self, n_probe, threshold):
        rng = np.random.default_rng(n_probe)
        s = np.round(rng.normal(size=(6, 5)), 1).astype(np.float32)
        s[0, 1] = s[0, 3] = s[0].max()     # a tie: lowest bucket first
        got = routing.select_nprobe(s, n_probe, threshold)
        want = j_routing.select_nprobe(s, n_probe, threshold)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])

    def test_bounded_matches_jax(self):
        rng = np.random.default_rng(7)
        u = rng.normal(size=(4, 6)).astype(np.float32)
        tau = np.array([0.5, -np.inf, 1.0, u[3].max() + 2e-5], np.float32)
        for seeds in [(), (2,), (0, 5)]:
            assert (routing.select_bounded(u, tau, seeds)
                    == j_routing.select_bounded(u, tau, seeds))

    def test_nprobe_rejects_zero(self):
        with pytest.raises(ValueError, match="n_probe"):
            routing.select_nprobe(np.zeros((1, 2)), 0)


class TestRoutingIndex:
    @pytest.mark.parametrize("n_centroids", [1, 3, 16])
    def test_build_matches_jax(self, jax_init, n_centroids):
        """Includes buckets with fewer kept tokens than centroids (16)
        and the all-empty-doc bucket's zero radius."""
        e, mask, keep = _corpus(1)
        jp, tp = _pack_both(e, mask, keep)
        want = j_routing.RoutingIndex.build(jp, n_centroids=n_centroids)
        got = RoutingIndex.build(tp, n_centroids=n_centroids)
        np.testing.assert_array_equal(got.cmask.numpy(),
                                      np.asarray(want.cmask))
        np.testing.assert_allclose(got.centroids.numpy(),
                                   np.asarray(want.centroids), atol=1e-6)
        np.testing.assert_allclose(got.radius.numpy(),
                                   np.asarray(want.radius), atol=1e-6)
        assert (got.n_buckets, got.dim, got.epoch) == (
            want.n_buckets, want.dim, want.epoch)

    def test_own_init_is_seeded(self):
        e, mask, keep = _corpus(2)
        _, tp = _pack_both(e, mask, keep)
        a = RoutingIndex.build(tp, n_centroids=3, seed=4)
        b = RoutingIndex.build(tp, n_centroids=3, seed=4)
        assert torch.equal(a.centroids, b.centroids)
        assert torch.equal(a.radius, b.radius)

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_centroid_scores_match_jax(self, jax_init, backend):
        e, mask, keep = _corpus(3)
        q, qm = _queries(3)
        jp, tp = _pack_both(e, mask, keep)
        jr = j_routing.RoutingIndex.build(jp, n_centroids=3)
        tr = RoutingIndex.build(tp, n_centroids=3)
        ws, wu = j_routing.centroid_scores(jr, jnp.asarray(q),
                                           jnp.asarray(qm),
                                           backend="reference")
        gs, gu = routing.centroid_scores(tr, torch.tensor(q),
                                         torch.tensor(qm), backend=backend)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=ATOL)
        np.testing.assert_allclose(gu.numpy(), np.asarray(wu), atol=ATOL)

    def test_validate_for(self):
        e, mask, keep = _corpus(4)
        _, tp = _pack_both(e, mask, keep)
        table = RoutingIndex.build(tp, n_centroids=2)
        assert table.validate_for(tp) is table
        tp.epoch = 1
        with pytest.raises(ValueError, match="epoch"):
            table.validate_for(tp)
        with pytest.raises(ValueError, match="buckets"):
            table.validate_for(retrieval._bucket_view(tp, (0,)))
        with pytest.raises(TypeError, match="PackedIndex"):
            RoutingIndex.build(retrieval.TokenIndex.build(
                torch.tensor(e), torch.tensor(mask)))


def _routed_case(seed, compression):
    e, mask, keep = _corpus(seed, n_docs=48, clustered=True)
    q, qm = _queries(seed)
    kw = {"compression": compression, "n_centroids": 4}
    jp, tp = _pack_both(e, mask, keep, **kw)
    jr = j_routing.RoutingIndex.build(jp, n_centroids=2)
    tr = RoutingIndex.build(tp, n_centroids=2)
    return jp, tp, jr, tr, q, qm


class TestRoutedSearch:
    @pytest.mark.parametrize("compression", ["none", "residual"])
    @pytest.mark.parametrize("route,n_probe", [("nprobe", 1),
                                               ("nprobe", 2),
                                               ("bounded", 1)])
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_matches_jax(self, jax_init, compression, route, n_probe,
                         backend):
        jp, tp, jr, tr, q, qm = _routed_case(5, compression)
        wst, gst = {}, {}
        wi, ws = j_ret.topk_search(jp, jnp.asarray(q), k=6,
                                   q_masks=jnp.asarray(qm),
                                   backend="reference", route=route,
                                   routing=jr, n_probe=n_probe,
                                   route_stats=wst)
        gi, gs = retrieval.topk_search(tp, torch.tensor(q), k=6,
                                       q_masks=torch.tensor(qm),
                                       backend=backend, route=route,
                                       routing=tr, n_probe=n_probe,
                                       route_stats=gst)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=ATOL)
        assert gst == wst

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_bounded_equals_exhaustive_bitwise(self, backend):
        """Within the port the bounded route returns the exhaustive
        sweep's ids and scores bit for bit, and prunes on a clustered
        corpus whose tokens are their own centroids (radius 0)."""
        e, mask, keep = _corpus(6, n_docs=16, clustered=True)
        _, tp = _pack_both(e, mask, keep)
        n_points = max(int(b.masks.sum()) for b in tp.buckets)
        table = RoutingIndex.build(tp, n_centroids=n_points)
        assert (table.radius == 0).all()
        q = torch.tensor(e[np.flatnonzero(mask.sum(1) == 2)[:3], :4])
        oi, ov = retrieval.topk_search(tp, q, k=2, backend=backend)
        st = {}
        ri, rv = retrieval.topk_search(tp, q, k=2, backend=backend,
                                       route="bounded", routing=table,
                                       route_stats=st)
        assert torch.equal(oi, ri) and torch.equal(ov, rv)
        assert 0 < st["fraction"] < 1.0

    def test_server_routed_matches_jax(self, jax_init):
        jp, tp, jr, tr, q, _ = _routed_case(7, "residual")
        want = j_ret.RetrievalServer(jp, k=5, backend="reference",
                                     route="bounded", routing=jr
                                     ).query_batch(jnp.asarray(q))
        server = retrieval.RetrievalServer(tp, k=5, backend="fused",
                                           route="bounded", routing=tr)
        got = server.query_batch(torch.tensor(q))
        np.testing.assert_array_equal(got.top_idx, np.asarray(want[0]))
        np.testing.assert_allclose(got.top_scores, np.asarray(want[1]),
                                   atol=ATOL)

    def test_routing_errors(self):
        e, mask, keep = _corpus(8)
        _, tp = _pack_both(e, mask, keep)
        q = torch.tensor(_queries(8)[0])
        table = RoutingIndex.build(tp, n_centroids=2)
        with pytest.raises(ValueError, match="routing table"):
            retrieval.topk_search(tp, q, route="nprobe")
        with pytest.raises(ValueError, match="not in"):
            retrieval.topk_search(tp, q, route="fast", routing=table)
        with pytest.raises(ValueError, match="e2e route"):
            retrieval.search(tp, q, n_first=4, route="nprobe",
                             routing=table, return_full=False)
        with pytest.raises(ValueError, match="routing table"):
            retrieval.RetrievalServer(tp, route="bounded")
        server = retrieval.RetrievalServer(tp, route="nprobe",
                                           routing=table)
        with pytest.raises(ValueError, match="routing table"):
            server.swap_index(tp)
        server.swap_index(tp, routing=table)
        assert server.epoch_key == (1, 1, 0)
