"""The pruning baselines and the LP dominance margin of the PyTorch port
against the JAX reference (``repro.core.baselines``, ``repro.core.lp``,
``repro.models.attention.attention_weights_received``,
``repro.models.colbert.encode_docs_with_attention``).  The same numpy
inputs feed both packages.

Tolerances: keep masks exactly (IDF ties and one-token docs crafted
in); ``build_idf``'s table exactly equal to numpy's float64 log of the
fp32 quotient rounded to fp32, and within 1e-6 of the reference's (XLA's
fp32 log and quotient are not correctly rounded: up to 4 ulps apart on
these tables); ``dominance_margin`` within 1e-4 of the reference's and
``lp_prunable`` exactly where a margin lies more than 1e-4 from theta;
``random_prune`` per-doc keep counts only, on unpadded docs (the two
packages' RNGs differ by design, and padded slots draw scores too, so a
padded doc's count depends on the draw); the received attention within
1e-6 at an fp32 smoke config.

The LP ascent takes a first-index argmin of q.(d_i - d_j) at each step.
The port forms that as q.d_i - q.d_j, the reference forms the
difference first; the two round differently, so on a near-tie the
argmin can flip and the paths part.  On the fixtures below (random
unit-scale tokens, dim 2-24, m <= 12, 60-500 steps) the margins agreed
within 1.2e-7; 1e-4 leaves room for a flip that rejoins the path.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro import configs
    from repro.core import baselines as j_base
    from repro.core import lp as j_lp
    from repro.models import attention as j_attn
    from repro.models import colbert as j_colbert
except ImportError:     # a GPU host without JAX
    jax = None
from repro_torch.configs import colbert_base
from repro_torch.core import baselines, lp
from repro_torch.models.attention import attention_weights_received
from repro_torch.models.colbert import ColBERT
from repro_torch.models.common import rms_norm
from repro_torch.models.convert import params_from_jax

pytestmark = pytest.mark.skipif(jax is None, reason="needs the JAX package")


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _token_batch(seed=0, B=6, m=11, vocab=12):
    """Token ids with repeats inside and across docs (IDF ties), padded
    docs, a one-token doc and a doc with every id the same."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, size=(B, m)).astype(np.int32)
    lens = rng.integers(2, m + 1, size=B)
    lens[1], lens[2] = 1, m
    ids[np.arange(m)[None, :] >= lens[:, None]] = 0
    ids[3, :lens[3]] = 5
    return ids, ids != 0


FRACTIONS = [0.01, 0.1, 0.3, 0.5, 0.75, 1.0]


class TestLearningFree:
    @pytest.mark.parametrize("f", FRACTIONS)
    def test_first_k(self, f):
        _, mask = _token_batch()
        _eq(baselines.first_k(_t(mask), f), j_base.first_k(mask, f))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_build_idf(self, seed):
        ids, mask = _token_batch(seed, B=9, m=13, vocab=20)
        got = baselines.build_idf(_t(ids), _t(mask), 20).numpy()
        want = np.asarray(j_base.build_idf(ids, mask, 20))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        df = np.array([sum(v in set(row[k]) for row, k in zip(ids, mask))
                       for v in range(20)])
        quot = (np.float32(9) / (np.float32(1) + df.astype(np.float32)))
        np.testing.assert_array_equal(
            got, np.log(quot.astype(np.float64)).astype(np.float32))

    @pytest.mark.parametrize("f", FRACTIONS)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_idf_prune(self, f, seed):
        ids, mask = _token_batch(seed)
        idf = np.asarray(j_base.build_idf(ids, mask, 12))
        _eq(baselines.idf_prune(_t(ids), _t(mask), _t(idf), f),
            j_base.idf_prune(ids, mask, idf, f))

    def test_stopword_prune(self):
        ids, mask = _token_batch(3)
        stop = np.zeros(12, bool)
        stop[[2, 5, 7]] = True
        _eq(baselines.stopword_prune(_t(ids), _t(mask), _t(stop)),
            j_base.stopword_prune(ids, mask, stop))

    @pytest.mark.parametrize("f", FRACTIONS)
    def test_attention_prune(self, f):
        _, mask = _token_batch(4)
        rng = np.random.default_rng(4)
        recv = (np.round(rng.random(mask.shape) * 8) / 8).astype(np.float32)
        _eq(baselines.attention_prune(_t(recv), _t(mask), f),
            j_base.attention_prune(recv, mask, f))

    def test_norm_prune(self):
        rng = np.random.default_rng(5)
        _, mask = _token_batch(5)
        d = rng.normal(size=mask.shape + (8,)).astype(np.float32)
        # norms on a grid that keeps every token 0.05 from theta
        r = rng.choice([0.2, 0.4, 0.6, 0.8], size=mask.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)
             * r[..., None]).astype(np.float32)
        for theta in (0.5, 0.7, 0.9):
            _eq(baselines.norm_prune(_t(d), _t(mask), theta),
                j_base.norm_prune(d, mask, theta))

    @pytest.mark.parametrize("f", [0.01, 0.25, 0.5, 0.9])
    def test_random_prune_counts(self, f):
        mask = np.ones((6, 11), bool)
        keep = baselines.random_prune(
            torch.Generator().manual_seed(0), _t(mask), f)
        want = j_base.random_prune(jax.random.PRNGKey(0), mask, f)
        _eq(keep.sum(-1), np.asarray(want).sum(-1))
        _, padded = _token_batch(6)
        keep = baselines.random_prune(
            torch.Generator().manual_seed(0), _t(padded), f)
        assert bool((keep <= _t(padded)).all() and keep.any(-1).all())


def _ball_doc(seed, m=8, dim=16, n_real=None):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(m, dim)).astype(np.float32)
    r = rng.uniform(0.3, 1.0, size=(m, 1))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True) * r).astype(
        np.float32)
    mask = np.arange(m) < (m if n_real is None else n_real)
    return d, mask


class TestLP:
    @pytest.mark.parametrize("seed,m,dim,n_real", [(0, 8, 16, None),
                                                   (1, 12, 24, 9),
                                                   (2, 6, 8, 1)])
    def test_dominance_margin(self, seed, m, dim, n_real):
        d, mask = _ball_doc(seed, m, dim, n_real)
        got = lp.dominance_margin(_t(d), _t(mask), n_iters=60)
        want = np.asarray(j_lp.dominance_margin(d, mask, n_iters=60))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    def test_batched_margin_is_per_doc(self):
        docs = [_ball_doc(s, 10, 12, n) for s, n in ((3, None), (4, 6),
                                                      (5, 2))]
        d = np.stack([x for x, _ in docs])
        mask = np.stack([k for _, k in docs])
        got = lp.dominance_margin(_t(d), _t(mask), n_iters=80)
        want = np.asarray(jax.vmap(
            lambda e, k: j_lp.dominance_margin(e, k, n_iters=80))(d, mask))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)

    def test_reference_2d_case(self):
        """The reference test's 2-D case (``test_voronoi_core.py``), and
        against brute-force search as that test holds it."""
        k = jax.random.PRNGKey(7)
        d = jax.random.normal(k, (5, 2))
        d = np.asarray(d / jnp.linalg.norm(d, axis=-1, keepdims=True) * 0.8)
        mask = np.ones((5,), bool)
        got = lp.dominance_margin(_t(d), _t(mask), n_iters=500, lr=0.2)
        want = np.asarray(j_lp.dominance_margin(d, mask, n_iters=500,
                                                lr=0.2))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        bf = lp.brute_force_margin(_t(d), _t(mask), n_probe=200_000)
        np.testing.assert_allclose(got.numpy(), bf.numpy(), atol=0.02)
        j_bf = np.asarray(j_lp.brute_force_margin(
            jnp.asarray(d), jnp.asarray(mask), n_probe=200_000))
        np.testing.assert_allclose(bf.numpy(), j_bf, atol=0.02)

    def test_dominated_token_pruned(self):
        d = np.array([[0.9, 0.0], [0.0, 0.9], [0.45, 0.0]], np.float32)
        mask = np.ones((3,), bool)
        pr = lp.lp_prunable(_t(d), _t(mask), theta=0.4, n_iters=400)
        assert pr.tolist() == [False, False, True]

    @pytest.mark.parametrize("theta", [0.3, 0.5, 0.7])
    def test_lp_prunable_and_prune(self, theta):
        docs = [_ball_doc(s, 9, 12, n) for s, n in ((6, None), (7, 5),
                                                     (8, 1))]
        d = np.stack([x for x, _ in docs])
        mask = np.stack([k for _, k in docs])
        margins = np.asarray(jax.vmap(
            lambda e, k: j_lp.dominance_margin(e, k, n_iters=60))(d, mask))
        clear = np.abs(margins - theta) > 1e-4
        assert clear.sum() >= 0.8 * mask.size
        got = lp.lp_prunable(_t(d), _t(mask), theta, n_iters=60).numpy()
        want = np.asarray(jax.vmap(lambda e, k: j_lp.lp_prunable(
            e, k, theta, n_iters=60))(d, mask))
        np.testing.assert_array_equal(got[clear], want[clear])
        got = baselines.lp_prune(_t(d), _t(mask), theta, n_iters=60).numpy()
        want = np.asarray(jax.vmap(lambda e, k: j_base.lp_prune(
            e, k, theta, n_iters=60))(d, mask))
        np.testing.assert_array_equal(got[clear], want[clear])
        assert got.any(-1).all()


class TestAttentionReceived:
    @staticmethod
    def _pair():
        jcfg = configs.get("colbert").smoke
        params = j_colbert.init_params(jax.random.PRNGKey(3), jcfg)
        model = ColBERT(colbert_base.SMOKE)
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
        rng = np.random.default_rng(8)
        ids = rng.integers(4, jcfg.vocab, size=(5, jcfg.doc_len)).astype(
            np.int32)
        lens = rng.integers(1, jcfg.doc_len + 1, size=5)
        ids[np.arange(jcfg.doc_len)[None, :] >= lens[:, None]] = 0
        return jcfg, params, model, ids

    def test_attention_weights_received(self):
        jcfg, params, model, ids = self._pair()
        lm = jcfg.lm_config()
        rng = np.random.default_rng(9)
        x = rng.normal(size=(5, jcfg.doc_len, jcfg.d_model)).astype(
            np.float32)
        mask = ids != 0
        layer0 = jax.tree_util.tree_map(lambda a: a[0],
                                        params["backbone"]["layers"])
        for theta in (None, lm.rope_theta):
            want = j_attn.attention_weights_received(
                j_attn.AttnParams(**layer0["attn"]), x, n_heads=lm.n_heads,
                n_kv_heads=lm.n_kv_heads, head_dim=lm.hd, attn_mask=mask,
                rope_theta=theta)
            with torch.no_grad():
                got = attention_weights_received(
                    model.backbone.layers[0].attn, _t(x), attn_mask=_t(mask),
                    rope_theta=theta)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)

    def test_encode_docs_with_attention(self):
        jcfg, params, model, ids = self._pair()
        je, jm, jr = j_colbert.encode_docs_with_attention(params, jcfg, ids)
        with torch.no_grad():
            te, tm, tr = model.encode_docs_with_attention(_t(ids))
        _eq(tm, jm)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5,
                                   rtol=0)
        # the layer-0 input is the embedding through ln1, as the reference
        h = rms_norm(model.backbone._embed(_t(ids)),
                     model.backbone.layers[0].ln1)
        assert h.shape == (5, jcfg.doc_len, jcfg.d_model)
