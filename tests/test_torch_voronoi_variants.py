"""The Voronoi ablation variants and the analysis helpers of the
PyTorch port against the JAX reference: ``assign_cells``/``CellState``,
``prune_to_size``, ``mean_error(_batch)``, ``beam_pruning_order``, the
reference-path knobs ``single_pass``/``fast`` and ``bf16_scores`` with
the backend resolution policy, the sphere/ball marginals, the Fig. 1
uniformity report, ``relevance_recall_at_k`` and ``linear_fit``.  The
same numpy inputs feed both packages.

Tolerances: cell state, Mean Error and beam errors within 1e-6, ids,
keep masks and ranks exactly (on fixtures whose scores sit on a 1/8
grid, so dot products are exact and ties are real ties, or whose error
gaps exceed 1e-5); the log marginals within 1e-6 relative of float64
and within 1e-6 relative plus 5e-5 of the reference (the reference
takes each log Γ of the normalizer in fp32, good to ~1.5e-5 at dim 128;
the port takes it in float64), and so its expected density within
5e-5 relative; the report's histogram counts exactly, its density and
bin edges within 5e-6 relative and 2e-7 (the port's edges are the
float64 linspace rounded to fp32, XLA's fp32 linspace is an ulp off at
some edges, and the density divides by the bin widths) and its
correlation fields within 1e-6; ``relevance_recall_at_k``
exactly and ``linear_fit`` within 1e-12.
"""

import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import metrics as j_metrics
    from repro.core import sampling as j_sampling
    from repro.core import voronoi as j_vor
except ImportError:     # a GPU host without JAX
    jax = None
from repro_torch.core import backend as backend_lib
from repro_torch.core import metrics, sampling, voronoi

pytestmark = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _grid(rng, *shape):
    """Values on a 1/8 grid: every dot product is exact in fp32."""
    return (np.round(rng.normal(size=shape) * 4) / 8).astype(np.float32)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _docs(seed, B=3, m=9, dim=6, unit=True):
    rng = np.random.default_rng(seed)
    d = _unit(rng, B, m, dim) if unit else _grid(rng, B, m, dim)
    lens = rng.integers(2, m + 1, size=B)
    lens[0] = m
    mask = np.arange(m)[None, :] < lens[:, None]
    return d, mask


def _samples(seed, n=96, dim=6, unit=True):
    rng = np.random.default_rng(seed + 100)
    return _unit(rng, n, dim) if unit else _grid(rng, n, dim)


class TestCells:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_assign_cells(self, seed):
        d, mask = _docs(seed, unit=False)
        S = _samples(seed, unit=False)
        got = voronoi.assign_cells(_t(d), _t(mask), _t(S))
        assert isinstance(got, voronoi.CellState)
        assert got._fields == ("best", "second", "bi", "si")
        for b in range(d.shape[0]):
            want = j_vor.assign_cells(d[b], mask[b], S)
            one = voronoi.assign_cells(_t(d[b]), _t(mask[b]), _t(S))
            for g, o, w in zip(got, one, want):
                _close(g[b].float(), np.asarray(w, np.float32))
                _close(o.float(), np.asarray(w, np.float32))
            np.testing.assert_array_equal(got.bi[b].numpy(), np.asarray(want.bi))
            np.testing.assert_array_equal(got.si[b].numpy(), np.asarray(want.si))
            errs = voronoi.token_errors(one, _t(mask[b]), S.shape[0])
            _close(errs, j_vor.token_errors(want, mask[b], S.shape[0]))

    @pytest.mark.parametrize("target", [1, 3, 6])
    def test_prune_to_size(self, target):
        d, mask = _docs(2, B=3, m=10, dim=8)
        S = _samples(2, n=256, dim=8)
        for b in range(3):
            got = voronoi.prune_to_size(_t(d[b]), _t(mask[b]), _t(S), target,
                                        backend="reference")
            want = j_vor.prune_to_size(d[b], mask[b], S, target,
                                       backend="reference")
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert int(got.sum()) == min(target, int(mask[b].sum()))


class TestMeanError:
    @pytest.mark.parametrize("ball", [False, True])
    def test_mean_error(self, ball):
        d, mask = _docs(3, B=4, m=9, dim=8)
        S = _samples(3, n=200, dim=8)
        rng = np.random.default_rng(3)
        keep = mask & (rng.random(mask.shape) < 0.5)
        keep[:, 0] = True
        got = voronoi.mean_error_batch(_t(d), _t(mask), _t(keep), _t(S),
                                       ball_normalized=ball)
        want = j_vor.mean_error_batch(d, mask, keep, S, ball_normalized=ball)
        _close(got, want)
        for b in range(4):
            _close(voronoi.mean_error(_t(d[b]), _t(mask[b]), _t(keep[b]),
                                      _t(S), ball_normalized=ball),
                   j_vor.mean_error(d[b], mask[b], keep[b], S,
                                    ball_normalized=ball))
        assert float(voronoi.mean_error(_t(d[0]), _t(mask[0]), _t(mask[0]),
                                        _t(S))) == 0.0


class TestBeam:
    @pytest.mark.parametrize("beam", [1, 3])
    @pytest.mark.parametrize("target", [1, 4])
    def test_beam_pruning_order(self, beam, target):
        d, mask = _docs(4, B=3, m=8, dim=6)
        S = _samples(4, n=128, dim=6)
        keep, err = voronoi.beam_pruning_order(_t(d), _t(mask), _t(S),
                                               beam=beam, target=target)
        for b in range(3):
            wk, we = j_vor.beam_pruning_order(d[b], mask[b], S, beam=beam,
                                              target=target)
            np.testing.assert_array_equal(keep[b].numpy(), np.asarray(wk))
            _close(err[b], we)
            one_k, one_e = voronoi.beam_pruning_order(
                _t(d[b]), _t(mask[b]), _t(S), beam=beam, target=target)
            np.testing.assert_array_equal(one_k.numpy(), np.asarray(wk))
            _close(one_e, we)

    def test_beam_one_is_greedy(self):
        """Beam 1 removes what Alg. 1 removes, down to the target."""
        d, mask = _docs(5, B=2, m=8, dim=6)
        S = _samples(5, n=128, dim=6)
        keep, _ = voronoi.beam_pruning_order(_t(d), _t(mask), _t(S), beam=1,
                                             target=3)
        rank, _, _ = voronoi.pruning_order_batch(_t(d), _t(mask), _t(S),
                                                 backend="reference")
        np.testing.assert_array_equal(
            keep.numpy(),
            voronoi.keep_mask_from_order(rank, _t(mask), 3).numpy())


class TestReferenceKnobs:
    @pytest.mark.parametrize("step_size", [1, 2])
    def test_single_pass_and_fast(self, step_size):
        d, mask = _docs(6, B=3, m=10, dim=8)
        S = _samples(6, n=256, dim=8)
        got = voronoi.pruning_order_batch(_t(d), _t(mask), _t(S),
                                          step_size=step_size, fast=True)
        want = j_vor.pruning_order_batch(d, mask, S, step_size=step_size,
                                         fast=True)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        fin = np.isfinite(np.asarray(want[1]))
        _close(got[1].numpy()[fin], np.asarray(want[1])[fin])
        for b in range(3):
            r, e, o = voronoi.pruning_order(_t(d[b]), _t(mask[b]), _t(S),
                                            step_size=step_size,
                                            single_pass=True)
            jr, je, jo = j_vor.pruning_order(d[b], mask[b], S,
                                             step_size=step_size,
                                             single_pass=True)
            np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
            np.testing.assert_array_equal(o.numpy(), np.asarray(jo))

    @pytest.mark.parametrize("kw", [{"bf16_scores": True},
                                    {"bf16_scores": True, "fast": True},
                                    {"bf16_scores": True, "shortlist": True}],
                             ids=["bf16", "bf16_fast", "bf16_shortlist"])
    def test_bf16_scores(self, kw):
        d, mask = _docs(7, B=3, m=8, dim=8)
        S = _samples(7, n=64, dim=8)
        got = voronoi.pruning_order_batch(_t(d), _t(mask), _t(S), **kw)
        want = j_vor.pruning_order_batch(d, mask, S, **kw)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        # the errors live in the cache's precision where every reduction
        # runs in bf16, as in the reference
        assert got[1].dtype == (torch.bfloat16 if kw == {"bf16_scores": True}
                                else torch.float32)
        assert str(np.asarray(want[1]).dtype) == str(got[1].dtype).split(".")[1]

    def test_knobs_raise_on_kernel_backends(self):
        d, mask = _docs(8, B=2, m=6, dim=4)
        S = _t(_samples(8, n=16, dim=4))
        d, mask = _t(d), _t(mask)
        for backend in ("fused", "shortlist_topk"):
            for kw in ({"fast": True}, {"bf16_scores": True}):
                with pytest.raises(ValueError, match="no .*equivalent"):
                    voronoi.pruning_order_batch(d, mask, S, backend=backend,
                                                **kw)
        for kw in ({"single_pass": True}, {"bf16_scores": True}):
            with pytest.raises(ValueError, match="reference-path knobs"):
                voronoi.pruning_order(d[0], mask[0], S, backend="fused",
                                      **kw)
        with pytest.raises(ValueError, match="topk-kernel"):
            voronoi.pruning_order(d[0], mask[0], S, backend="shortlist_topk",
                                  bf16_scores=True)
        with pytest.raises(ValueError, match="topk-kernel"):
            voronoi.pruning_order_shortlist(d[0], mask[0], S, rescan="topk",
                                            bf16_scores=True)

    @pytest.mark.parametrize("backend", [None, "reference", "fused",
                                         "shortlist", "shortlist_topk"])
    @pytest.mark.parametrize("step_size", [1, 3])
    def test_resolution_policy(self, backend, step_size, monkeypatch):
        """The reference's policy on the CPU, and the CUDA defaults."""
        monkeypatch.delenv("REPRO_BACKEND", raising=False)
        for shortlist in (False, True):
            for fast, bf16 in ((False, False), (True, False), (False, True)):
                kw = dict(shortlist=shortlist, fast=fast, bf16_scores=bf16,
                          step_size=step_size)
                try:
                    want = j_vor.resolve_pruning_backend(backend, **kw)
                except ValueError:
                    with pytest.raises(ValueError):
                        voronoi.resolve_pruning_backend(backend, device="cpu",
                                                        **kw)
                    continue
                assert voronoi.resolve_pruning_backend(
                    backend, device="cpu", **kw) == want
        cuda = voronoi.resolve_pruning_backend
        assert cuda(None, device="cuda") == backend_lib.SHORTLIST_TOPK
        assert cuda(None, fast=True, device="cuda") == backend_lib.REFERENCE
        assert cuda(None, bf16_scores=True,
                    device="cuda") == backend_lib.REFERENCE
        assert cuda("shortlist", device="cuda") == backend_lib.SHORTLIST
        assert cuda(None, shortlist=True, step_size=3,
                    device="cuda") == backend_lib.FUSED


class TestSampling:
    @pytest.mark.parametrize("dim", [3, 8, 128])
    def test_marginals(self, dim):
        x = np.linspace(-0.999, 0.999, 4001).astype(np.float32)
        for fn in ("sphere_marginal_logpdf", "ball_marginal_logpdf"):
            got = getattr(sampling, fn)(_t(x), dim)
            want = getattr(j_sampling, fn)(x, dim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=5e-5)
            # against float64: the port's normalizer is float64's
            a, b, k = ((dim / 2, (dim - 1) / 2, (dim - 3) / 2)
                       if fn.startswith("sphere") else
                       (dim / 2 + 1, (dim + 1) / 2, (dim - 1) / 2))
            x2 = (x * x).astype(np.float64)      # x^2 rounded as in fp32
            f64 = (math.lgamma(a) - math.lgamma(b) - 0.5 * math.log(math.pi)
                   + k * np.log1p(-x2))
            np.testing.assert_allclose(got.numpy(), f64, rtol=1e-6,
                                       atol=1e-6)
            # a density on [-1, 1]
            total = np.trapezoid(np.exp(got.numpy().astype(np.float64)), x)
            assert abs(total - 1.0) < 2e-3, (fn, total)

    @pytest.mark.parametrize("n,dim", [(500, 128), (300, 24)])
    def test_uniformity_report(self, n, dim):
        v = _unit(np.random.default_rng(n), n, dim)
        got = sampling.embedding_uniformity_report(_t(v))
        want = j_sampling.embedding_uniformity_report(v)
        assert set(got) == set(want)
        for k in ("bin_centers", "corr_edges"):
            _close(got[k], want[k], atol=2e-7)
        np.testing.assert_array_equal(got["corr_hist"].numpy(),
                                      np.asarray(want["corr_hist"]))
        # the density's counts exactly; the density itself divides by
        # the bin widths, which carry the edges' ulp
        np.testing.assert_allclose(got["observed_density"].numpy(),
                                   np.asarray(want["observed_density"]),
                                   rtol=5e-6, atol=0)
        width = 2.0 / 41
        np.testing.assert_array_equal(
            np.round(got["observed_density"].numpy() * width * n),
            np.round(np.asarray(want["observed_density"]) * width * n))
        for k in ("max_abs_off_corr", "mean_abs_off_corr"):
            _close(got[k], want[k])
        np.testing.assert_allclose(got["expected_density"].numpy(),
                                   np.asarray(want["expected_density"]),
                                   rtol=5e-5, atol=1e-6)


class TestMetrics:
    @pytest.mark.parametrize("k", [1, 3, 10])
    def test_relevance_recall_at_k(self, k):
        rng = np.random.default_rng(k)
        scores = (np.round(rng.normal(size=(7, 12)) * 2) / 2).astype(
            np.float32)
        rel = rng.random((7, 12)) < 0.15
        rel[2] = False
        _close(metrics.relevance_recall_at_k(_t(scores), _t(rel), k),
               j_metrics.relevance_recall_at_k(scores, rel, k), atol=0)
        none = np.zeros_like(rel)
        assert float(metrics.relevance_recall_at_k(_t(scores), _t(none),
                                                   k)) == 0.0

    def test_linear_fit(self):
        rng = np.random.default_rng(0)
        x = rng.random(8)
        y = 0.3 - 2.0 * x + 0.01 * rng.normal(size=8)
        got, want = metrics.linear_fit(x, y), j_metrics.linear_fit(x, y)
        assert set(got) == set(want)
        for key in got:
            assert abs(got[key] - want[key]) <= 1e-12
        assert metrics.linear_fit([1, 2], [3, 3])["r2"] == 1.0
