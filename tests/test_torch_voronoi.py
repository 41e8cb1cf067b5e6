"""Voronoi pruning, the bucketed pipeline, samplers, metrics and the
backend seam of the PyTorch port against the JAX reference.

Fixtures are random unit-norm documents from a numpy seed; their
per-step error gaps are far wider than fp32 rounding, so removal ranks
must agree exactly and errors within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as j_metrics
from repro.core import pruning_pipeline as j_pipe
from repro.core import voronoi as j_vor
from repro_torch.core import backend as backend_lib
from repro_torch.core import metrics, pruning_pipeline, sampling, voronoi

ATOL = 1e-5
BACKENDS = ["reference", "fused", "shortlist", "shortlist_topk"]


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed, n_docs=6, m=20, dim=16, n_samples=512):
    rng = np.random.default_rng(seed)
    e = _unit(rng, n_docs, m, dim)
    lens = rng.integers(5, m + 1, size=n_docs)
    mask = np.arange(m)[None, :] < lens[:, None]
    if n_docs > 1:
        mask[1] = np.arange(m) % 3 != 1    # scattered, non-prefix mask
    return e, mask, _unit(rng, n_samples, dim)


def _assert_orders_match(got, want):
    (r, er, o), (wr, we, wo) = got, [np.asarray(x) for x in want]
    np.testing.assert_array_equal(r.numpy(), wr)
    er = er.numpy()
    np.testing.assert_array_equal(np.isinf(er), np.isinf(we))
    fin = np.isfinite(we)
    np.testing.assert_allclose(er[fin], we[fin], atol=ATOL)
    np.testing.assert_array_equal(o.numpy()[:, :wo.shape[1]], wo)


class TestPruningOrder:
    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_batch_matches_jax_reference(self, backend, seed):
        e, mask, s = _corpus(seed)
        want = j_vor.pruning_order_batch(jnp.asarray(e), jnp.asarray(mask),
                                         jnp.asarray(s), backend="reference")
        got = voronoi.pruning_order_batch(torch.tensor(e), torch.tensor(mask),
                                          torch.tensor(s), backend=backend)
        _assert_orders_match(got, want)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_single_doc_matches_jax(self, backend):
        e, mask, s = _corpus(4, n_docs=1)
        want = j_vor.pruning_order(jnp.asarray(e[0]), jnp.asarray(mask[0]),
                                   jnp.asarray(s), backend="reference")
        got = voronoi.pruning_order(torch.tensor(e[0]),
                                    torch.tensor(mask[0]), torch.tensor(s),
                                    backend=backend)
        _assert_orders_match(tuple(x[None] for x in got),
                             tuple(np.asarray(x)[None] for x in want))

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_step_size_two_matches_jax(self, backend):
        e, mask, s = _corpus(2)
        want = j_vor.pruning_order_batch(jnp.asarray(e), jnp.asarray(mask),
                                         jnp.asarray(s), step_size=2,
                                         backend="reference")
        got = voronoi.pruning_order_batch(torch.tensor(e), torch.tensor(mask),
                                          torch.tensor(s), step_size=2,
                                          backend=backend)
        _assert_orders_match(got, want)

    def test_shortlist_pinned_at_exactness_boundary(self):
        e, mask, s = _corpus(3, n_docs=1)
        args = [torch.tensor(x) for x in (e[0], mask[0], s)]
        want = voronoi.pruning_order(*args, backend="reference")
        got = voronoi.pruning_order_shortlist(*args, shortlist=3,
                                              rescan_every=2, rescan="topk")
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        with pytest.raises(ValueError, match="exactness"):
            voronoi.pruning_order_shortlist(*args, shortlist=3,
                                            rescan_every=3)

    def test_estimate_errors_match_jax(self):
        e, mask, s = _corpus(5, n_docs=1)
        want = np.asarray(j_vor.estimate_errors(
            jnp.asarray(e[0]), jnp.asarray(mask[0]), jnp.asarray(s)))
        got = voronoi.estimate_errors(torch.tensor(e[0]),
                                      torch.tensor(mask[0]),
                                      torch.tensor(s)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)

    def test_keep_mask_from_order_matches_jax(self):
        e, mask, s = _corpus(6, n_docs=1)
        r, _, _ = j_vor.pruning_order(jnp.asarray(e[0]), jnp.asarray(mask[0]),
                                      jnp.asarray(s), backend="reference")
        want = np.asarray(j_vor.keep_mask_from_order(r, jnp.asarray(mask[0]),
                                                     4))
        got = voronoi.keep_mask_from_order(torch.tensor(np.asarray(r)),
                                           torch.tensor(mask[0]), 4)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.sum() == 4


class TestPipeline:
    def test_bucket_plan_matches_jax(self):
        rng = np.random.default_rng(0)
        n_real = rng.integers(0, 90, size=40)
        want = j_pipe.bucket_plan(n_real, 90)
        got = pruning_pipeline.bucket_plan(n_real, 90)
        assert [(b.width, b.indices.tolist()) for b in got] == \
            [(b.width, b.indices.tolist()) for b in want]

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_bucketed_matches_flat(self, backend):
        """Same ranks and orders; errors agree to fp32 rounding (the
        Eq. 8 one-hot product sums in an order that depends on the
        bucket width)."""
        e, mask, s = _corpus(7, n_docs=9, m=24)
        args = [torch.tensor(x) for x in (e, mask, s)]
        fr, fe, fo = voronoi.pruning_order_batch(*args, backend=backend)
        br, be, bo = voronoi.pruning_order_batch(*args, backend=backend,
                                                 bucketed=True)
        assert torch.equal(fr, br) and torch.equal(fo, bo)
        torch.testing.assert_close(be, fe, rtol=1e-6, atol=1e-9)

    @pytest.mark.parametrize("keep", [0.3, 0.5])
    def test_prune_corpus_matches_jax(self, keep):
        e, mask, s = _corpus(8, n_docs=10, m=24)
        wk, wr, we = j_pipe.prune_corpus(jnp.asarray(e), jnp.asarray(mask),
                                         jnp.asarray(s), keep,
                                         backend="reference")
        gk, gr, ge = pruning_pipeline.prune_corpus(
            torch.tensor(e), torch.tensor(mask), torch.tensor(s), keep,
            backend="shortlist_topk")
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
        fin = np.isfinite(np.asarray(we))
        np.testing.assert_allclose(ge.numpy()[fin], np.asarray(we)[fin],
                                   atol=ATOL)

    def test_global_keep_masks_ties_follow_flat_order(self):
        """Equal merge keys (empty cells cost exactly 0) prune in flat
        (doc, token) order, as the reference's stable argsort does."""
        ranks = np.tile(np.arange(6, dtype=np.int32), (3, 1))
        errs = np.zeros((3, 6), np.float32)
        errs[:, 5] = np.inf
        mask = np.ones((3, 6), bool)
        want = np.asarray(j_vor.global_keep_masks(
            jnp.asarray(ranks), jnp.asarray(errs), jnp.asarray(mask), 0.5))
        got = voronoi.global_keep_masks(torch.tensor(ranks),
                                        torch.tensor(errs),
                                        torch.tensor(mask), 0.5)
        np.testing.assert_array_equal(got.numpy(), want)


class TestSampling:
    def test_sphere_norms_and_moments(self):
        g = torch.Generator().manual_seed(0)
        s = sampling.sample_sphere(g, 20000, 16)
        assert s.shape == (20000, 16) and s.dtype == torch.float32
        torch.testing.assert_close(s.norm(dim=-1), torch.ones(20000))
        # uniform on S^{n-1}: mean 0, E[x_i^2] = 1/n
        assert s.mean(0).abs().max() < 0.02
        assert ((s * s).mean(0) - 1 / 16).abs().max() < 0.005

    def test_ball_radii(self):
        g = torch.Generator().manual_seed(0)
        r = sampling.sample_ball(g, 5000, 8).norm(dim=-1)
        assert r.max() <= 1.0 + 1e-6
        assert abs(r.mean().item() - 8 / 9) < 0.02


class TestMetrics:
    def test_mrr_ndcg_match_jax(self):
        rng = np.random.default_rng(0)
        scores = np.round(rng.normal(size=(6, 30)), 1).astype(np.float32)
        rel = rng.random((6, 30)) < 0.1
        rel[0] = False
        gains = rel * rng.integers(1, 3, size=rel.shape).astype(np.float32)
        for k in (1, 5, 10):
            np.testing.assert_allclose(
                metrics.mrr_at_k(torch.tensor(scores), torch.tensor(rel),
                                 k).item(),
                float(j_metrics.mrr_at_k(jnp.asarray(scores),
                                         jnp.asarray(rel), k)), atol=1e-6)
            np.testing.assert_allclose(
                metrics.ndcg_at_k(torch.tensor(scores), torch.tensor(gains),
                                  k).item(),
                float(j_metrics.ndcg_at_k(jnp.asarray(scores),
                                          jnp.asarray(gains), k)),
                atol=1e-6)

    def test_recall_pad_rule_matches_jax(self):
        pruned = np.array([[3, 1, -1], [5, -1, -1], [-1, -1, -1]])
        oracle = np.array([[1, 2, 3], [-1, -1, -1], [4, 5, 6]])
        assert metrics.recall_at_k(pruned, oracle) == \
            j_metrics.recall_at_k(pruned, oracle)


class TestBackendSeam:
    def test_platform_defaults(self, monkeypatch):
        monkeypatch.delenv("REPRO_BACKEND", raising=False)
        r = backend_lib.resolve_backend
        assert r(None, device="cpu") == "reference"
        assert r(None, device="cuda") == "shortlist_topk"
        assert r(None, allow=backend_lib.SERVING, device="cuda") == "fused"

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("REPRO_BACKEND", "shortlist")
        assert backend_lib.resolve_backend(None, device="cpu") == "shortlist"
        assert backend_lib.resolve_backend(
            None, allow=backend_lib.SERVING, device="cpu") == "reference"
        monkeypatch.setenv("REPRO_BACKEND", "bogus")
        with pytest.raises(ValueError, match="known backend"):
            backend_lib.resolve_backend(None, device="cpu")

    def test_tf32_is_off(self):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

    @pytest.mark.parametrize("m", [8, 24, 180, 1024])
    def test_shortlist_knobs_match_reference_heuristic(self, m):
        from repro.core.tuning import heuristic_config
        cfg = heuristic_config("pruning", n_samples=2048, m=m, dim=128)
        got = backend_lib.tuned("pruning", device="cpu", n_samples=2048,
                                m=m, dim=128)
        assert (got.shortlist, got.rescan_every) == (cfg.shortlist,
                                                     cfg.rescan_every)
