"""Kernel modules of the PyTorch port against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; the same numpy
inputs go through the JAX op (Pallas in interpret mode, as the JAX
package's own tests run it) or its jnp oracle.  Quantized inputs make
scores exact in both frameworks, so ties are real ties and ids must
agree exactly.  The ``cuda``-marked tests hold the CUDA kernels against
the plain versions and run only where there is a GPU; they need no JAX,
so a GPU host without it runs them with ``-m cuda``.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.colbert_maxsim.ops import (
        colbert_maxsim_batch_op as j_batch, colbert_maxsim_multi_op as j_multi,
        colbert_maxsim_op as j_single, colbert_maxsim_rerank_op as j_rerank)
    from repro.kernels.colbert_maxsim.ref import (
        colbert_maxsim_ref as j_single_ref)
    from repro.kernels.maxsim_top2.ops import (
        maxsim_top2_op as j_top2, maxsim_top2_update_op as j_update,
        voronoi_errors_fused as j_errs)
    from repro.kernels.maxsim_top2.ref import maxsim_top2_ref as j_top2_ref
    from repro.kernels.maxsim_topk.ref import maxsim_topk_ref as j_topk_ref
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from repro_torch.kernels.maxsim_top2 import ops as t2
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
from repro_torch.kernels.maxsim_topk import ops as tk
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref
from repro_torch.serve import retrieval
from repro_torch.serve.index import PackedIndex
from repro_torch.train import compress

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


    def test_batch_op_matches_jax_op(self):
        """The reference's ``vmap`` of the single-query kernel over shared
        docs, as ``tests/test_kernels.py`` runs it, against the plain
        version: random normal queries and docs, every token alive."""
        import jax
        k = jax.random.PRNGKey(9)
        q = jax.random.normal(k, (5, 8, 32))
        d = jax.random.normal(jax.random.fold_in(k, 1), (12, 16, 32))
        msk = jnp.ones((12, 16), bool)
        want = np.asarray(j_batch(q, d, msk))
        ref = np.stack([np.asarray(j_single_ref(q[i], d, msk))
                        for i in range(5)])
        got = cm.colbert_maxsim_batch_op(_t(q), _t(d), _t(msk)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        # masked doc tokens, and the plain version by query
        q2, d2, dm2, _ = _colbert_case(3)
        got = cm.colbert_maxsim_batch_op(_t(q2), _t(d2), _t(dm2))
        want = np.asarray(j_batch(jnp.asarray(q2), jnp.asarray(d2),
                                  jnp.asarray(dm2)))
        real = want > -1e29
        np.testing.assert_allclose(got.numpy()[real], want[real], atol=ATOL)
        for i in range(q2.shape[0]):
            assert torch.equal(got[i], cm_ref.colbert_maxsim_ref(
                _t(q2[i]), _t(d2), _t(dm2)))


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

    def test_bf16_docs_match_plain(self):
        """bf16 docs widen exactly in the loader: kernel and plain
        version score the same fp32 values."""
        dev = _cuda()
        q, d, dm, qm = (_t(x).to(dev) for x in _colbert_case(
            4, n_q=5, l=32, n_docs=40, m=130, dim=128))
        d = d.to(torch.bfloat16)
        before = cm.colbert_maxsim_multi_op.bf16_launches
        got = cm.colbert_maxsim_multi_op(q, d, dm, qm)
        want = cm_ref.colbert_maxsim_multi_ref(q, d, dm, qm)
        assert cm.colbert_maxsim_multi_op.bf16_launches == before + 1
        real = want > -1e29
        assert (got - want)[real].abs().max() <= ATOL
        assert torch.allclose(got[~real], want[~real], rtol=1e-6)
        ds = d[None].expand(5, -1, -1, -1).contiguous()
        ms = dm[None].expand(5, -1, -1).contiguous()
        got = cm.colbert_maxsim_rerank_op(q, ds, ms, qm)
        assert (got - want)[real].abs().max() <= ATOL


def _residual_case(dev, lead, m, dim, bits, C, seed=0, unit=False):
    """Codes, packed residuals, scales and codebook on ``dev`` through
    the port's codec; doc masks with one empty doc.  The codebook is
    ``randn`` (norm ~11, scores up to ~90), or with ``unit`` its rows
    normalized and the residuals scaled to norm ~0.3, as on the paths."""
    g = torch.Generator().manual_seed(seed)
    cb = torch.randn(C, dim, generator=g)
    noise = 0.3 / dim ** 0.5 if unit else 0.3
    if unit:
        cb = cb / cb.norm(dim=-1, keepdim=True)
    codes = torch.randint(0, C, lead + (m,), generator=g, dtype=torch.int8)
    d = cb[codes.long()] + noise * torch.randn(lead + (m, dim), generator=g)
    resq, scale = compress.quantize_residual(d - cb[codes.long()], bits)
    dm = torch.rand(lead + (m,), generator=g) < 0.8
    dm.view(-1, m)[1] = False
    return [t.to(dev) for t in (codes, resq, scale, cb, dm)]


def _exact_maxsim(eq, q, d, dm, qm):
    """MaxSim in float64 of the same decoded tokens (``eq`` the einsum
    of the query axis against the docs), masked as the kernels mask."""
    s = torch.einsum(eq, q.double(), d.double())
    s = torch.where(dm[..., None, :], s, -1e30)
    return torch.where(qm[:, None, :], s.amax(-1), 0.0).sum(-1)


def _assert_near(got, want, exact):
    """The kernel against a float64 MaxSim (``exact``: a randn codebook,
    scores up to ~90, where the fp32 plain version ``want`` is itself
    ~1e-5 from the exact value) or, where ``exact`` is None (a unit
    codebook), against the plain version; both at 1e-5.  All-masked docs
    hold the plain version's sentinel within 1e-6."""
    real = want > -1e29
    assert (~real).any() and torch.isfinite(got).all()
    ref = want.double() if exact is None else exact
    assert (got.double() - ref)[real].abs().max() <= ATOL
    assert torch.allclose(got[~real], want[~real], rtol=1e-6)


# (C, bits, unit codebook): the ids of the randn cases are "C-bits"
MULTI_CASES = [pytest.param(C, bits, False, id=f"{C}-{bits}")
               for C in (1, 8, 127) for bits in (2, 4)] + [
    pytest.param(8, 4, True, id="unit-8-4")]
RERANK_CASES = [pytest.param(C, bits, False, id=f"{C}-{bits}")
                for C in (1, 127) for bits in (2, 4)] + [
    pytest.param(8, 4, True, id="unit-8-4")]


@pytest.mark.cuda
class TestResidualKernelsOnCard:
    @pytest.mark.parametrize("C,bits,unit", MULTI_CASES)
    def test_multi_matches_plain(self, C, bits, unit):
        dev = _cuda()
        codes, resq, scale, cb, dm = _residual_case(dev, (37,), 130, 128,
                                                    bits, C, unit=unit)
        q, _, _, qm = (_t(x).to(dev) for x in _colbert_case(
            5, n_q=6, l=32, n_docs=3, m=1, dim=128))
        before = cm.colbert_maxsim_residual_multi_op.launches
        got = cm.colbert_maxsim_residual_multi_op(q, codes, resq, scale, cb,
                                                  dm, qm, bits=bits)
        assert cm.colbert_maxsim_residual_multi_op.launches == before + 1
        want = cm_ref.colbert_maxsim_residual_multi_ref(
            q, codes, resq, scale, cb, dm, qm, bits=bits)
        exact = None if unit else _exact_maxsim(
            "qld,nmd->qnlm", q,
            compress.dequantize_residual(resq, scale, codes, cb, bits), dm,
            qm)
        _assert_near(got, want, exact)

    @pytest.mark.parametrize("C,bits,unit", RERANK_CASES)
    def test_rerank_matches_plain(self, C, bits, unit):
        dev = _cuda()
        n_q, n_cand, n_b = 4, 33, 3
        codes, resq, scale, _, dm = _residual_case(dev, (n_q, n_cand), 70,
                                                   128, bits, C, seed=1,
                                                   unit=unit)
        g = torch.Generator().manual_seed(2)
        table = torch.randn(n_b, C, 128, generator=g)
        if unit:
            table = table / table.norm(dim=-1, keepdim=True)
        table = table.to(dev)
        bucket_of = torch.randint(0, n_b, (n_q, n_cand), generator=g,
                                  dtype=torch.int32).to(dev)
        q, _, _, qm = (_t(x).to(dev) for x in _colbert_case(
            6, n_q=n_q, l=32, n_docs=3, m=1, dim=128))
        before = cm.colbert_maxsim_residual_rerank_op.launches
        got = cm.colbert_maxsim_residual_rerank_op(
            q, codes, resq, scale, table, bucket_of, dm, qm, bits=bits)
        assert cm.colbert_maxsim_residual_rerank_op.launches == before + 1
        want = cm_ref.colbert_maxsim_residual_rerank_ref(
            q, codes, resq, scale, table, bucket_of, dm, qm, bits=bits)
        # each candidate's table: codes into the flattened (n_b·C, dim)
        flat = bucket_of.long()[..., None] * C + codes.long()
        exact = None if unit else _exact_maxsim(
            "qld,qnmd->qnlm", q,
            compress.dequantize_residual(resq, scale, flat,
                                         table.reshape(-1, 128), bits),
            dm, qm)
        _assert_near(got, want, exact)

    def test_out_of_range_indices_are_clamped(self):
        """A malformed code or bucket id reads inside its table (the
        kernel clamps, as XLA's gather does) instead of faulting."""
        dev = _cuda()
        codes, resq, scale, _, dm = _residual_case(dev, (2, 5), 40, 128, 4,
                                                   8, seed=3)
        table = torch.randn(3, 8, 128, device=dev)
        bucket_of = torch.tensor([[0, 1, 2, 9, -4]] * 2, dtype=torch.int32,
                                 device=dev)
        bad = codes.clone()
        bad[:, :, 0] = 127
        q, _, _, _ = (_t(x).to(dev) for x in _colbert_case(
            8, n_q=2, l=32, n_docs=3, m=1, dim=128))
        got = cm.colbert_maxsim_residual_rerank_op(
            q, bad, resq, scale, table, bucket_of, dm, bits=4)
        clamped = bad.clone()
        clamped[:, :, 0] = 7
        want = cm_ref.colbert_maxsim_residual_rerank_ref(
            q, clamped, resq, scale, table, bucket_of.clamp(0, 2), dm,
            bits=4)
        torch.cuda.synchronize()
        real = want > -1e29
        assert (got - want)[real].abs().max() <= ATOL

    @pytest.mark.parametrize("compression", ["int8", "residual"])
    def test_compressed_serving_matches_reference_backend(self, compression):
        dev = _cuda()
        q, d, dm, _ = (_t(x).to(dev) for x in _colbert_case(
            7, n_q=8, l=32, n_docs=300, m=100, dim=128))
        keep = torch.rand(dm.shape, generator=torch.Generator().manual_seed(
            3)).to(dev) < 0.6
        packed = retrieval.TokenIndex.build(d, torch.ones_like(dm)
                                            ).with_keep(keep).pack(
            compression=compression)
        assert isinstance(packed, PackedIndex)
        for n_first in (16, packed.n_docs):
            ri, rs = retrieval.search(packed, q, k=11, n_first=n_first,
                                      backend="reference",
                                      return_full=False)
            fi, fs = retrieval.search(packed, q, k=10, n_first=n_first,
                                      backend="fused", return_full=False)
            assert (fs - rs[:, :10]).abs().max() <= ATOL
            # ids equal wherever the reference's gap to a neighbour
            # exceeds the tolerance
            prev = torch.full_like(fs, torch.inf)
            prev[:, 1:] = rs[:, :9] - rs[:, 1:10]
            tie = (prev <= ATOL) | (rs[:, :10] - rs[:, 1:] <= ATOL)
            assert ((fi == ri[:, :10]) | tie).all()


class _GuardSpy:
    """Stands in for ``torch.cuda.device``: records the device each
    launch made current, and whether a C entry ran inside it."""

    def __init__(self):
        self.entered, self.inside = [], 0

    def __call__(self, device):
        spy = self

        class _Ctx:
            def __enter__(self):
                spy.entered.append(torch.device(device))
                spy.depth = 1

            def __exit__(self, *exc):
                spy.depth = 0

        return _Ctx()


class TestDeviceGuard:
    """Every kernel launch runs with its tensors' card current (the
    launch, ``cudaFuncSetAttribute`` and ``sm_count()`` act on the
    current device): each wrapper's launch goes through
    ``build.launch``, which enters ``torch.cuda.device`` around the C
    entry.  Here the wrappers' launch helpers run on CPU tensors against
    a stand-in library, counting guarded calls."""

    LAUNCHERS = ["maxsim_top2", "maxsim_topk", "multi_fp32", "multi_bf16",
                 "rerank_fp32", "rerank_bf16", "residual_multi",
                 "residual_rerank", "embedding_bag", "flash_attention",
                 "split_planes"]

    @pytest.fixture
    def spy(self, monkeypatch):
        from repro_torch.kernels import build
        guard = _GuardSpy()
        guard.depth, guard.calls = 0, []

        class _Lib:
            def __getattr__(self, entry):
                def call(*args):
                    guard.calls.append((entry, guard.depth))
                    return 0
                return call

        monkeypatch.setattr(torch.cuda, "device", guard)
        monkeypatch.setattr(build, "library", lambda name: _Lib())
        monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
        return guard

    @pytest.mark.parametrize("which", LAUNCHERS)
    def test_every_launch_is_guarded(self, spy, which):
        from repro_torch.kernels import build
        from repro_torch.kernels.embedding_bag import ops as eb
        from repro_torch.kernels.flash_attention import ops as fa
        g = torch.Generator().manual_seed(0)
        s = torch.randn(64, 16, generator=g)
        t = torch.randn(2, 8, 16, generator=g)
        a = torch.ones(2, 8, dtype=torch.bool)
        q = torch.randn(2, 4, 16, generator=g)
        d = torch.randn(3, 8, 16, generator=g)
        dm = torch.ones(3, 8, dtype=torch.bool)
        codes = torch.zeros(3, 8, dtype=torch.int8)
        resq = torch.zeros(3, 8, 8, dtype=torch.uint8)
        scale = torch.ones(3, 8, 1)
        cb = torch.randn(4, 16, generator=g)
        run = {
            # the doc block given: its default reads the tensors' card
            "maxsim_top2": lambda: t2._launch(s, t, a, 1),
            "maxsim_topk": lambda: tk._launch(s, t, a, 4, 1),
            "multi_fp32": lambda: cm._launch(
                "colbert_maxsim_multi_launch", q, d, dm, None, 3, 1),
            "multi_bf16": lambda: cm._launch(
                "colbert_maxsim_multi_launch", q, d.bfloat16(), dm, None,
                3, 1),
            "rerank_fp32": lambda: cm._launch(
                "colbert_maxsim_rerank_launch", q, d[None].expand(
                    2, -1, -1, -1).contiguous(), dm[None].expand(
                    2, -1, -1).contiguous(), None, 3),
            "rerank_bf16": lambda: cm._launch(
                "colbert_maxsim_rerank_launch", q, d.bfloat16()[None].expand(
                    2, -1, -1, -1).contiguous(), dm[None].expand(
                    2, -1, -1).contiguous(), None, 3),
            "residual_multi": lambda: cm._residual_launch(
                "colbert_maxsim_residual_multi_launch", q, None, codes, resq,
                scale, cb, None, dm, 4, 1),
            "residual_rerank": lambda: cm._residual_launch(
                "colbert_maxsim_residual_rerank_launch", q, None,
                codes[None].expand(2, -1, -1).contiguous(),
                resq[None].expand(2, -1, -1, -1).contiguous(),
                scale[None].expand(2, -1, -1, -1).contiguous(), cb[None],
                torch.zeros(2, 3, dtype=torch.int32),
                dm[None].expand(2, -1, -1).contiguous(), 4),
            "embedding_bag": lambda: eb._launch(
                torch.randn(10, 4, generator=g),
                torch.zeros(3, 2, dtype=torch.int32), "sum"),
            "flash_attention": lambda: fa._launch(
                torch.randn(2, 8, 16), torch.randn(2, 8, 16),
                torch.randn(2, 8, 16), True, None, 2, 2, 8, 8, 16),
            "split_planes": lambda: build.launch(
                "colbert_maxsim", "colbert_maxsim_split_planes", d.device,
                d.data_ptr(), 24, 16, 8, 0, 0, 0),
        }[which]
        run()
        assert spy.calls and all(depth for _, depth in spy.calls), spy.calls
        assert spy.entered == [torch.device("cpu")] * len(spy.calls)

    def test_no_wrapper_calls_a_library_directly(self):
        """Every C entry of the op wrappers is reached through
        ``build.launch`` alone."""
        from pathlib import Path
        root = Path(cm.__file__).resolve().parents[1]
        for ops in sorted(root.glob("*/ops.py")):
            text = ops.read_text()
            assert "build.launch(" in text, ops
            assert "build.library(" not in text, ops
            assert "build.check(" not in text, ops


@pytest.mark.cuda
class TestLaunchOnSecondCard:
    """A launch on ``cuda:1`` from a thread whose current device is
    ``cuda:0`` equals the same launch on ``cuda:0``, bit for bit."""

    def test_every_kernel_on_cuda_1(self):
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two GPUs: the launch guard is checked "
                        "across cards (chip_smoke's [grid] does it where "
                        "the host has them)")
        from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
        from repro_torch.kernels.flash_attention.ops import (
            flash_attention_op)
        g = torch.Generator().manual_seed(0)
        s = torch.randn(256, 128, generator=g)
        t = torch.randn(4, 64, 128, generator=g)
        a = torch.rand(4, 64, generator=g) > 0.2
        q = torch.randn(8, 32, 128, generator=g)
        d = torch.randn(16, 64, 128, generator=g)
        dm = torch.rand(16, 64, generator=g) > 0.2
        cands = torch.randn(8, 12, 64, 128, generator=g)
        cm_ = torch.rand(8, 12, 64, generator=g) > 0.2
        table = torch.randn(100, 64, generator=g)
        ids = torch.randint(0, 100, (32, 4), generator=g, dtype=torch.int32)
        att = torch.randn(2, 4, 128, 64, generator=g).bfloat16()
        codes = torch.randint(0, 8, (16, 64), generator=g).to(torch.int8)
        resq = torch.randint(0, 256, (16, 64, 64), generator=g).to(
            torch.uint8)
        scale = torch.rand(16, 64, 1, generator=g)
        cb = torch.randn(8, 128, generator=g)
        ops = [
            lambda x: t2.maxsim_top2_op(*x(s, t, a)),
            lambda x: tk.maxsim_topk_op(*x(s, t, a), k=8),
            lambda x: cm.colbert_maxsim_multi_op(*x(q, d, dm)),
            lambda x: cm.colbert_maxsim_multi_op(*x(q, d.bfloat16(), dm)),
            lambda x: cm.colbert_maxsim_rerank_op(*x(q, cands, cm_)),
            lambda x: cm.colbert_maxsim_rerank_op(*x(q, cands.bfloat16(),
                                                      cm_)),
            lambda x: cm.colbert_maxsim_residual_multi_op(
                *x(q, codes, resq, scale, cb, dm), bits=4),
            lambda x: cm.colbert_maxsim_residual_rerank_op(
                *x(q, codes[:12][None].expand(8, -1, -1).contiguous(),
                   resq[:12][None].expand(8, -1, -1, -1).contiguous(),
                   scale[:12][None].expand(8, -1, -1, -1).contiguous(),
                   cb[None], torch.zeros(8, 12, dtype=torch.int32), cm_),
                bits=4),
            lambda x: embedding_bag_op(*x(table, ids)),
            lambda x: flash_attention_op(*x(att, att, att), causal=True),
        ]
        torch.cuda.set_device(0)
        for op in ops:
            outs = []
            for dev in ("cuda:0", "cuda:1"):
                out = op(lambda *ts: [u.to(dev) for u in ts])
                out = out if isinstance(out, tuple) else (out,)
                assert all(o.device == torch.device(dev) for o in out)
                outs.append([o.cpu() for o in out])
            for x0, x1 in zip(*outs):
                assert torch.equal(x0, x1)
