"""Kernel modules of the PyTorch port against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; the same numpy
inputs go through the JAX op (Pallas in interpret mode, as the JAX
package's own tests run it) or its jnp oracle.  Quantized inputs make
scores exact in both frameworks, so ties are real ties and ids must
agree exactly.  The ``cuda``-marked tests hold the CUDA kernels against
the plain versions and run only where there is a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.colbert_maxsim.ops import (
    colbert_maxsim_multi_op as j_multi, colbert_maxsim_op as j_single,
    colbert_maxsim_rerank_op as j_rerank)
from repro.kernels.maxsim_top2.ops import (maxsim_top2_op as j_top2,
                                           maxsim_top2_update_op as j_update,
                                           voronoi_errors_fused as j_errs)
from repro.kernels.maxsim_top2.ref import maxsim_top2_ref as j_top2_ref
from repro.kernels.maxsim_topk.ref import maxsim_topk_ref as j_topk_ref
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from repro_torch.kernels.maxsim_top2 import ops as t2
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
from repro_torch.kernels.maxsim_topk import ops as tk
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref

ATOL = 1e-5


def _q(rng, *shape):
    """Values on a 0.5 grid: dot products are exact in fp32."""
    return (np.round(rng.normal(size=shape) * 2) / 2).astype(np.float32)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tied_doc(seed, N=40, m=24, dim=8, p_alive=0.8):
    rng = np.random.default_rng(seed)
    S, D = _q(rng, N, dim), _q(rng, m, dim)
    D[m - 1], D[m // 2], D[2] = D[0], D[1], D[1]     # duplicate rows
    alive = rng.random(m) < p_alive
    alive[[0, 1]] = True
    return S, D, alive


class TestMaxsimTop2:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_ties_match_jax_kernel(self, seed):
        S, D, alive = _tied_doc(seed)
        want = j_top2(jnp.asarray(S), jnp.asarray(D), jnp.asarray(alive))
        got = t2.maxsim_top2_op(_t(S), _t(D), _t(alive))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_batched_docs_match_per_doc(self):
        docs = [_tied_doc(s) for s in range(3)]
        S = docs[0][0]
        D = np.stack([d[1] for d in docs])
        A = np.stack([d[2] for d in docs])
        got = t2.maxsim_top2_op(_t(S), _t(D), _t(A))
        for b in range(3):
            want = j_top2_ref(jnp.asarray(S), jnp.asarray(D[b]),
                              jnp.asarray(A[b]))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))

    @pytest.mark.parametrize("alive_ix", [[2], [0], []])
    def test_few_alive_tokens(self, alive_ix):
        """One or no alive token: the second is the -1e30 sentinel at the
        index the reference's reset-the-best argmax gives."""
        rng = np.random.default_rng(5)
        S, D = _unit(rng, 32, 8), _unit(rng, 5, 8)
        alive = np.zeros(5, bool)
        alive[alive_ix] = True
        want = j_top2_ref(jnp.asarray(S), jnp.asarray(D), jnp.asarray(alive))
        got = maxsim_top2_ref(_t(S), _t(D), _t(alive))
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_update_op_matches_jax(self):
        S, D, alive = _tied_doc(7, m=20)
        prev = j_top2(jnp.asarray(S), jnp.asarray(D), jnp.asarray(alive))
        shrunk = alive.copy()
        shrunk[[0, 5, 9]] = False
        (want, w_aff) = j_update(jnp.asarray(S), jnp.asarray(D),
                                 jnp.asarray(shrunk), prev,
                                 skip_unaffected=False)
        got, g_aff = t2.maxsim_top2_update_op(
            _t(S), _t(D), _t(shrunk), tuple(_t(p) for p in prev))
        np.testing.assert_array_equal(g_aff.numpy(), np.asarray(w_aff))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_voronoi_errors_match_jax(self):
        rng = np.random.default_rng(3)
        S, D = _unit(rng, 512, 16), _unit(rng, 20, 16)
        alive = np.arange(20) < 15
        want = np.asarray(j_errs(jnp.asarray(S), jnp.asarray(D),
                                 jnp.asarray(alive)))
        got = t2.voronoi_errors_fused(_t(S), _t(D), _t(alive)).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_allclose(got[:15], want[:15], atol=ATOL)


class TestMaxsimTopk:
    @pytest.mark.parametrize("k", [1, 4, 8, 24])
    def test_ties_match_jax_oracle(self, k):
        S, D, alive = _tied_doc(k)
        wv, wi = j_topk_ref(jnp.asarray(S), jnp.asarray(D),
                            jnp.asarray(alive), k)
        gv, gi = tk.maxsim_topk_op(_t(S), _t(D), _t(alive), k=k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))

    def test_dead_tokens_fill_the_tail(self):
        """Fewer than k alive: dead tokens enter at -1e30 with their own
        indices, lowest dead index first — the sentinel trap of the
        reference kernel's seeded list."""
        rng = np.random.default_rng(1)
        S, D = _unit(rng, 16, 8), _unit(rng, 12, 8)
        alive = np.zeros(12, bool)
        alive[[3, 7, 8]] = True
        wv, wi = j_topk_ref(jnp.asarray(S), jnp.asarray(D),
                            jnp.asarray(alive), 8)
        gv, gi = tk.maxsim_topk_op(_t(S), _t(D), _t(alive), k=8)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL)
        np.testing.assert_array_equal(gi.numpy()[:, 3:],
                                      np.tile([0, 1, 2, 4, 5], (16, 1)))

    def test_batched_matches_per_doc(self):
        rng = np.random.default_rng(2)
        S, D = _q(rng, 24, 8), _q(rng, 3, 20, 8)
        A = rng.random((3, 20)) < 0.7
        gv, gi = tk.maxsim_topk_op(_t(S), _t(D), _t(A), k=6)
        for b in range(3):
            wv, wi = j_topk_ref(jnp.asarray(S), jnp.asarray(D[b]),
                                jnp.asarray(A[b]), 6)
            np.testing.assert_array_equal(gi[b].numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gv[b].numpy(), np.asarray(wv))

    def test_k_above_m_rejected(self):
        with pytest.raises(ValueError, match="exceeds token count"):
            tk.maxsim_topk_op(torch.zeros(4, 8), torch.zeros(5, 8),
                              torch.ones(5, dtype=torch.bool), k=6)


def _colbert_case(seed, n_q=3, l=5, n_docs=7, m=9, dim=16):
    rng = np.random.default_rng(seed)
    q, d = _unit(rng, n_q, l, dim), _unit(rng, n_docs, m, dim)
    dm = rng.random((n_docs, m)) < 0.6
    dm[2] = False                      # empty-after-prune doc
    qm = np.ones((n_q, l), bool)
    qm[1, 3:] = False                  # masked query tokens
    return q, d, dm, qm


class TestColbertMaxsim:
    @pytest.mark.parametrize("with_qmask", [False, True])
    def test_multi_matches_jax_kernel(self, with_qmask):
        q, d, dm, qm = _colbert_case(0)
        qm_j = jnp.asarray(qm) if with_qmask else None
        want = np.asarray(j_multi(jnp.asarray(q), jnp.asarray(d),
                                  jnp.asarray(dm), qm_j))
        got = cm.colbert_maxsim_multi_op(
            _t(q), _t(d), _t(dm), _t(qm) if with_qmask else None).numpy()
        real = want > -1e29
        np.testing.assert_allclose(got[real], want[real], atol=ATOL)
        # the empty doc scores the finite l x -1e30 sentinel
        np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-6)
        assert np.isfinite(got).all()

    def test_rerank_matches_jax_kernel(self):
        q, _, _, qm = _colbert_case(1)
        rng = np.random.default_rng(1)
        d = _unit(rng, 3, 4, 9, 16)
        dm = rng.random((3, 4, 9)) < 0.6
        dm[0, 1] = False
        want = np.asarray(j_rerank(jnp.asarray(q), jnp.asarray(d),
                                   jnp.asarray(dm), jnp.asarray(qm)))
        got = cm.colbert_maxsim_rerank_op(_t(q), _t(d), _t(dm),
                                          _t(qm)).numpy()
        real = want > -1e29
        np.testing.assert_allclose(got[real], want[real], atol=ATOL)
        np.testing.assert_allclose(got[~real], want[~real], rtol=1e-6)

    def test_single_query_matches_jax_kernel(self):
        q, d, dm, qm = _colbert_case(2)
        want = np.asarray(j_single(jnp.asarray(q[1]), jnp.asarray(d),
                                   jnp.asarray(dm), jnp.asarray(qm[1])))
        got = cm.colbert_maxsim_op(_t(q[1]), _t(d), _t(dm),
                                   _t(qm[1])).numpy()
        real = want > -1e29
        np.testing.assert_allclose(got[real], want[real], atol=ATOL)
        np.testing.assert_allclose(got[~real], want[~real], rtol=1e-6)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs them on the card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    def test_top2_and_topk_match_plain(self):
        dev = _cuda()
        S, D, alive = _tied_doc(0, N=300, m=150, dim=128)
        S, D = _t(S).to(dev), _t(D)[None].repeat(3, 1, 1).to(dev)
        A = _t(alive)[None].repeat(3, 1).to(dev)
        for g, w in zip(t2.maxsim_top2_op(S, D, A),
                        maxsim_top2_ref(S, D, A)):
            assert torch.equal(g, w)
        gv, gi = tk.maxsim_topk_op(S, D, A, k=16)
        wv, wi = maxsim_topk_ref(S, D, A, 16)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)

    def test_colbert_kernels_match_plain(self):
        dev = _cuda()
        q, d, dm, qm = (_t(x).to(dev) for x in _colbert_case(
            3, n_q=5, l=32, n_docs=40, m=130, dim=128))
        got = cm.colbert_maxsim_multi_op(q, d, dm, qm)
        want = cm_ref.colbert_maxsim_multi_ref(q, d, dm, qm)
        real = want > -1e29
        assert (got - want)[real].abs().max() <= ATOL
        got = cm.colbert_maxsim_rerank_op(q, d[None].expand(5, -1, -1, -1)
                                          .contiguous(),
                                          dm[None].expand(5, -1, -1)
                                          .contiguous(), qm)
        assert (got - want)[real].abs().max() <= ATOL
