"""The Hopper kernels of B3's fp32 route (``colbert_maxsim_multi`` on
fp32 docs) and of B6 (``colbert_maxsim_residual_rerank``), their
arithmetic emulated on the CPU.

Both run the split-bf16 sweep of ``csrc/colbert_maxsim.cu`` (namespace
``sweep``): the queries and the docs split into three bf16 terms (hi +
mid + lo == x), the products of the terms above 2^-24 relative summed
one 16-column step at a time, each step on its own, the steps added in
fp32 (``_scores_by_step``: the tensor cores add with truncation, so no
running sum stays in them); masked doc tokens at -1e30, each query
token's max, a query's live tokens' maxima summed in double and rounded
once.

B3 on fp32 docs splits the docs in a pre-pass with one zero-term flag a
tile group — G = 64 / m_pad docs of m_pad = pow2(m) rows, or one doc
with m > 32 — and a group whose flag is 0 (bf16-exact docs, e.g. the
bf16 index widened) spends only its hi term: ``_b3_emulate`` zeroes the
mid and lo of such groups (they are zero) and checks the flags.  B6
decodes each candidate in its producer warpgroup against its own table,
``codebooks[clamp(bucket_of[i, j])]``, codes clamped into [0, C), with
B5's arithmetic (``_decode``), bit for bit ``dequantize_residual``.

Both emulations are held against the JAX op (Pallas in interpret mode,
as the JAX package's own tests run it) and the port's plain version on
the same inputs under chip_smoke.py's gates: 1e-5 abs, the l x -1e30
sentinel within 1e-6 relative.  Where the docs are far from unit norm
(norm ~11, scores up to ~90) the fp32 plain version is itself ~1e-5 from
the exact value, so there the emulation is held to a float64 MaxSim of
the same tokens at 1e-5.  The ``cuda``-marked tests hold the kernels to
the plain versions on unit data and to a float64 MaxSim on norm-11 data;
they need no JAX.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.colbert_maxsim.colbert_maxsim import (
        colbert_maxsim_multi as j_multi)
    from repro.kernels.colbert_maxsim.ops import (
        colbert_maxsim_residual_rerank_op as j_res_rerank)
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from repro_torch.train import compress
from test_torch_prune_resid_sm90 import _decode
from test_torch_score_sm90 import (_bf16_exact, _cuda, _scores_by_step,
                                   _split, _unit)

ATOL = 1e-5
NEG = np.float32(-1e30)
TN = 64             # doc rows a tile (csrc sweep::TN)


def _geometry(m):
    """csrc sweep::geometry: docs a tile G (m_pad = pow2(m) >= 8 rows
    each), or G = 1 for a doc longer than 32."""
    m_pad = 8
    while m_pad < m:
        m_pad *= 2
    return 1 if m_pad >= TN else TN // m_pad


def _maxsim(s, dm, qm):
    """Scores s (n_q, l, n_docs, m) masked as the kernels mask: -1e30 for
    a masked doc token, each query token's max, the live tokens' maxima
    summed in double, rounded once."""
    s = torch.where(dm[None, None], s, torch.tensor(NEG, dtype=s.dtype))
    best = torch.where(qm[..., None], s.amax(-1).double(), 0.0)
    return best.sum(1)


def _exact(q, d, dm, qm):
    """float64 MaxSim of the same tokens: d (n_docs, m, dim), or (n_q,
    n_cand, m, dim) each query against its own."""
    if d.dim() == 3:
        s = torch.einsum("qld,nmd->qlnm", q.double(), d.double())
        return _maxsim(s, dm, qm)
    return torch.stack([_maxsim(torch.einsum(
        "ld,nmd->lnm", q[i].double(), d[i].double())[None], dm[i],
        qm[i:i + 1])[0] for i in range(q.shape[0])])


def _group_flags(d):
    """The pre-pass's flags: one a tile group of G docs, set iff a mid or
    lo term of the group is non-zero."""
    n, m, _ = d.shape
    G = _geometry(m)
    _, mid, lo = _split(d)
    nz = ((mid != 0) | (lo != 0)).reshape(n, -1).any(-1)
    return torch.stack([nz[g:g + G].any() for g in range(0, n, G)]), G


def _b3_emulate(q, d, dm, qm):
    """(n_q, n_docs) as the kernel computes B3 on fp32 docs: a group
    whose flag is 0 takes its hi term only (its mid and lo are zero), the
    split scores step by step, the masked reduction."""
    n_q, l, dim = q.shape
    n, m, _ = d.shape
    flags, G = _group_flags(d)
    hi, mid, lo = _split(d)
    off = ~flags.repeat_interleave(G)[:n]
    assert not mid[off].any() and not lo[off].any()
    s = _scores_by_step(q.reshape(-1, dim), (hi + mid + lo).reshape(-1, dim))
    return _maxsim(s.reshape(n_q, l, n, m), dm, qm).float()


def _b6_emulate(q, codes, resq, scale, table, bucket_of, dm, qm, bits):
    """(n_q, n_cand) as the B6 kernel computes it: candidate (i, j)
    decoded against table clamp(bucket_of[i, j]), codes clamped into
    [0, C), then per query the split scores step by step and the masked
    reduction."""
    n_q, l, dim = q.shape
    n_b, C, _ = table.shape
    tab = bucket_of.long().clamp(0, n_b - 1)[..., None]
    flat = tab * C + codes.long().clamp(0, C - 1)
    out = []
    for i in range(n_q):
        d = _decode(flat[i], resq[i], scale[i], table.reshape(-1, dim), bits)
        s = _scores_by_step(q[i], d.reshape(-1, dim))
        out.append(_maxsim(s.reshape(1, l, *codes.shape[1:]), dm[i],
                           qm[i:i + 1])[0])
    return torch.stack(out).float()


def _assert_scores(got, want):
    real = want > -1e29
    assert (got - want)[real].abs().max() <= ATOL
    assert ((got - want) / want)[~real].abs().max() <= 1e-6


# ---- B3 on fp32 docs ----

def _dense_case(seed, n_q, l, n_docs, m, dim, kind):
    """Unit queries (one all-masked, masked tokens) and docs: ``fp32``
    unit tokens (three terms), ``exact`` bf16-exact ones (every flag 0),
    ``mixed`` bf16-exact but for the docs of one tile group, or ``int8``
    int8 values times per-token fp32 scales (the int8 index's dense view,
    three terms); doc 1 all masked."""
    rng = np.random.default_rng(seed)
    q = _unit(rng, n_q, l, dim)
    d = _unit(rng, n_docs, m, dim)
    if kind in ("exact", "mixed"):
        d = _bf16_exact(d)
    if kind == "mixed":
        G = _geometry(m)
        d[G:2 * G] = _unit(rng, len(d[G:2 * G]), m, dim)
    if kind == "int8":
        scale = np.abs(d).max(-1, keepdims=True) / 127
        d = (np.round(d / scale).astype(np.int8) * scale).astype(np.float32)
    dm = rng.random((n_docs, m)) < 0.7
    dm[:, 0] = True
    dm[1] = False
    qm = rng.random((n_q, l)) < 0.8
    qm[:, 0] = True
    qm[1 % n_q] = False
    return q, d, dm, qm


B3_CASES = [
    # (n_q, l, n_docs, m, dim, kind): m 1 and 8 pack G = 8 docs a tile
    # (9 docs: the last group has one), m 20 two, m 100 one doc of two
    # tiles, 130 and 180 three; l 32 and 64 (one query a warpgroup)
    (3, 32, 9, 1, 16, "fp32"),
    (3, 32, 9, 8, 16, "mixed"),
    (4, 8, 11, 20, 32, "exact"),
    (2, 64, 5, 130, 16, "fp32"),
    (3, 32, 4, 180, 32, "mixed"),
    (2, 32, 6, 100, 16, "int8"),
    (2, 64, 3, 180, 16, "exact"),
]


class TestMultiFp32Arithmetic:
    @pytest.mark.parametrize("n_q,l,n_docs,m,dim,kind", B3_CASES)
    def test_emulation_matches_pallas_and_plain(self, n_q, l, n_docs, m, dim,
                                                kind):
        q, d, dm, qm = _dense_case(n_q * l + m, n_q, l, n_docs, m, dim, kind)
        tq, td, tdm, tqm = (torch.from_numpy(x) for x in (q, d, dm, qm))
        got = _b3_emulate(tq, td, tdm, tqm)
        plain = cm.colbert_maxsim_multi_op(tq, td, tdm, tqm)
        want = torch.from_numpy(np.array(j_multi(
            jnp.asarray(q), jnp.asarray(d), jnp.asarray(dm), jnp.asarray(qm),
            interpret=True)))
        for ref in (plain, want):
            _assert_scores(got, ref)
        assert (plain[0, 1] < -1e29).all()        # the all-masked doc
        assert (plain[1 % n_q] == 0).all()        # the all-masked query
        flags, _ = _group_flags(td)
        if kind == "exact":
            assert not flags.any()
        elif kind == "mixed":
            assert flags.tolist() == [i == 1 for i in range(len(flags))]
        else:
            assert flags.all()

    def test_large_scores_stay_near_exact(self):
        """Docs of norm ~11 (scores up to ~90): the step-by-step sum stays
        within 1e-5 of a float64 MaxSim."""
        rng = np.random.default_rng(7)
        q = torch.from_numpy(_unit(rng, 2, 32, 128))
        d = torch.from_numpy(rng.normal(size=(5, 130, 128)).astype(
            np.float32))
        dm = torch.from_numpy(rng.random((5, 130)) < 0.8)
        dm[1] = False
        qm = torch.from_numpy(rng.random((2, 32)) < 0.9)
        got = _b3_emulate(q, d, dm, qm)
        exact = _exact(q, d, dm, qm)
        real = exact > -1e29
        assert exact[real].abs().max() > 50
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6


# ---- B6 ----

def _rerank_case(seed, n_q, l, n_cand, m, dim, bits, C, n_b=3, *,
                 unit=True):
    """Candidates through the port's codec against an (n_b, C, dim)
    table: unit rows and residuals of norm ~0.2, or (``unit`` False)
    randn rows (norm ~11) and residuals of 0.3 a value; candidate (i, 1)
    all masked and the last candidate's second half pad rows (code 0,
    residual bytes 0, masked); unit queries with masked tokens and one
    all-masked query."""
    rng = np.random.default_rng(seed)
    table = (_unit(rng, n_b, C, dim) if unit else
             rng.normal(size=(n_b, C, dim)).astype(np.float32))
    bucket_of = rng.integers(0, n_b, (n_q, n_cand)).astype(np.int32)
    codes = rng.integers(0, C, (n_q, n_cand, m)).astype(np.int8)
    noise = (0.2 * _unit(rng, n_q, n_cand, m, dim) if unit else
             0.3 * rng.normal(size=(n_q, n_cand, m, dim)).astype(np.float32))
    resq, scale = compress.quantize_residual(torch.from_numpy(noise), bits)
    dm = rng.random((n_q, n_cand, m)) < 0.7
    dm[..., 0] = True
    dm[:, 1] = False
    dm[:, -1, m // 2:] = False
    codes[:, -1, m // 2:] = 0
    resq[:, -1, m // 2:] = 0
    q = _unit(rng, n_q, l, dim)
    qm = rng.random((n_q, l)) < 0.8
    qm[:, 0] = True
    qm[1 % n_q] = False
    return (torch.from_numpy(q), torch.from_numpy(codes), resq, scale,
            torch.from_numpy(table), torch.from_numpy(bucket_of),
            torch.from_numpy(dm), torch.from_numpy(qm))


def _decoded(codes, resq, scale, table, bucket_of, bits):
    """The candidates decoded eagerly (``dequantize_residual`` against
    the flattened table), for the float64 reference."""
    C, dim = table.shape[1:]
    flat = bucket_of.long()[..., None] * C + codes.long()
    return compress.dequantize_residual(resq, scale, flat,
                                        table.reshape(-1, dim), bits)


B6_CASES = [
    # (n_q, l, n_cand, m, dim, bits, C): m 1 and 20 pack 8 and 2
    # candidates a tile, 130 and 180 take three tiles; l 32 and 64
    (2, 32, 5, 1, 16, 4, 8),
    (3, 8, 7, 20, 32, 2, 8),
    (2, 64, 3, 130, 16, 2, 8),
    (2, 32, 3, 180, 16, 4, 127),
]


class TestResidualRerankArithmetic:
    @pytest.mark.parametrize("n_q,l,n_cand,m,dim,bits,C", B6_CASES)
    def test_emulation_matches_pallas_and_plain(self, n_q, l, n_cand, m, dim,
                                                bits, C):
        args = _rerank_case(n_q * l + m + bits, n_q, l, n_cand, m, dim, bits,
                            C)
        q, codes, resq, scale, table, bucket_of, dm, qm = args
        got = _b6_emulate(*args, bits)
        plain = cm.colbert_maxsim_residual_rerank_op(*args, bits=bits)
        want = torch.from_numpy(np.array(j_res_rerank(
            *(jnp.asarray(t.numpy()) for t in (q, codes, resq, scale)),
            jnp.asarray(table.numpy()[bucket_of.numpy()]),
            jnp.asarray(dm.numpy()), jnp.asarray(qm.numpy()), bits=bits)))
        for ref in (plain, want):
            _assert_scores(got, ref)
        others = [i for i in range(n_q) if i != 1 % n_q]
        assert (plain[others, 1] < -1e29).all()   # the all-masked candidate
        assert (plain[1 % n_q] == 0).all()        # the all-masked query

    @pytest.mark.parametrize("bits", [2, 4])
    def test_decode_is_dequantize_residual(self, bits):
        """Each candidate's decode against its own table equals the eager
        decode bit for bit, and its three terms add back to it."""
        _, codes, resq, scale, table, bucket_of, _, _ = _rerank_case(
            3, 2, 8, 5, 40, 64, bits, 8)
        C, dim = table.shape[1:]
        flat = bucket_of.long()[..., None] * C + codes.long()
        d = torch.stack([_decode(flat[i], resq[i], scale[i],
                                 table.reshape(-1, dim), bits)
                         for i in range(codes.shape[0])])
        assert torch.equal(d, _decoded(codes, resq, scale, table, bucket_of,
                                       bits))
        hi, mid, lo = _split(d)
        assert torch.equal(hi + mid + lo, d)

    @pytest.mark.parametrize("bits", [2, 4])
    def test_indices_out_of_range_are_clamped(self, bits):
        """A bucket id outside [0, n_tables) reads the nearest table, a
        code outside [0, C) the nearest centroid, as the plain version
        reads clamped indices."""
        args = list(_rerank_case(5, 2, 8, 5, 30, 32, bits, 8))
        bucket_of, codes = args[5].clone(), args[1].clone()
        bucket_of[0, 0], bucket_of[1, 2] = 7, -2
        codes[0, 3, :5], codes[1, 0, 2:9] = 127, -5
        got = _b6_emulate(args[0], codes, *args[2:5], bucket_of, *args[6:],
                          bits)
        want = cm_ref.colbert_maxsim_residual_rerank_ref(
            args[0], codes.clamp(0, 7), *args[2:5], bucket_of.clamp(0, 2),
            *args[6:], bits=bits)
        _assert_scores(got, want)

    def test_large_scores_stay_near_exact(self):
        """Tables of norm ~11 (scores up to ~90): within 1e-5 of a
        float64 MaxSim of the same decoded candidates."""
        args = _rerank_case(11, 2, 32, 6, 130, 128, 4, 8, unit=False)
        q, codes, resq, scale, table, bucket_of, dm, qm = args
        got = _b6_emulate(*args, 4)
        exact = _exact(q, _decoded(codes, resq, scale, table, bucket_of, 4),
                       dm, qm)
        real = exact > -1e29
        assert exact[real].abs().max() > 50
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6


# ---- on the card ----

B3_CARD = [
    # (n_q, l, n_docs, m): m 1, 8 and 20 pack docs, 64 fills a tile, 100,
    # 128, 130 and 180 take two or three; 1,000 docs x 128 at 64 queries
    # fills the card
    (64, 32, 1000, 128), (5, 32, 37, 100), (7, 40, 33, 180), (9, 1, 50, 8),
    (6, 32, 41, 1), (5, 32, 29, 20), (64, 32, 300, 64), (3, 64, 17, 130),
]


@pytest.mark.cuda
class TestMultiFp32OnCard:
    @pytest.mark.parametrize("kind", ["fp32", "mixed", "exact", "int8"])
    @pytest.mark.parametrize("n_q,l,n_docs,m", B3_CARD)
    def test_kernel_matches_plain(self, n_q, l, n_docs, m, kind):
        dev = _cuda()
        q, d, dm, qm = (torch.from_numpy(x).to(dev) for x in _dense_case(
            n_q + l + m, n_q, l, n_docs, m, 128, kind))
        before = cm.colbert_maxsim_multi_op.launches
        bf16_before = cm.colbert_maxsim_multi_op.bf16_launches
        got = cm.colbert_maxsim_multi_op(q, d, dm, qm)
        torch.cuda.synchronize()
        assert cm.colbert_maxsim_multi_op.launches == before + 1
        assert cm.colbert_maxsim_multi_op.bf16_launches == bf16_before
        _assert_scores(got, cm_ref.colbert_maxsim_multi_ref(q, d, dm, qm))
        assert (got[1 % n_q] == 0).all()

    @pytest.mark.parametrize("m", [8, 130])
    def test_large_scores_stay_near_exact(self, m):
        dev = _cuda()
        rng = np.random.default_rng(m)
        q = torch.from_numpy(_unit(rng, 6, 32, 128)).to(dev)
        d = torch.from_numpy(rng.normal(size=(37, m, 128)).astype(
            np.float32)).to(dev)
        dm = torch.from_numpy(rng.random((37, m)) < 0.8).to(dev)
        dm[1] = False
        qm = torch.from_numpy(rng.random((6, 32)) < 0.9).to(dev)
        got = cm.colbert_maxsim_multi_op(q, d, dm, qm)
        exact = _exact(q, d, dm, qm)
        real = exact > -1e29
        assert exact[real].abs().max() > 20
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        for dim in (36, 136):
            q = torch.zeros(2, 4, dim, device=dev)
            d = torch.zeros(3, 8, dim, device=dev)
            with pytest.raises(ValueError, match=f"dim={dim}"):
                cm.colbert_maxsim_multi_op(
                    q, d, torch.ones(3, 8, dtype=torch.bool, device=dev))


B6_CARD = [(64, 64, 128, bits, C) for bits, C in ((4, 8), (2, 127))] + [
    (3, 33, m, bits, C) for m in (1, 20, 64, 180)
    for bits, C in ((4, 8), (2, 127))]


@pytest.mark.cuda
class TestResidualRerankOnCard:
    @pytest.mark.parametrize("n_q,n_cand,m,bits,C", B6_CARD)
    def test_kernel_matches_plain(self, n_q, n_cand, m, bits, C):
        """64 queries x 64 candidates x 128 is the two-stage path's
        shape; m 1 and 20 pack candidates a tile, 180 takes three tiles."""
        dev = _cuda()
        args = [t.to(dev) for t in _rerank_case(
            n_q + n_cand + m, n_q, 32, n_cand, m, 128, bits, C)]
        before = cm.colbert_maxsim_residual_rerank_op.launches
        got = cm.colbert_maxsim_residual_rerank_op(*args, bits=bits)
        torch.cuda.synchronize()
        assert cm.colbert_maxsim_residual_rerank_op.launches == before + 1
        _assert_scores(got, cm_ref.colbert_maxsim_residual_rerank_ref(
            *args, bits=bits))
        assert (got[1 % n_q] == 0).all()

    @pytest.mark.parametrize("bits", [2, 4])
    def test_large_scores_stay_near_exact(self, bits):
        dev = _cuda()
        args = [t.to(dev) for t in _rerank_case(
            bits, 6, 32, 37, 130, 128, bits, 127, unit=False)]
        q, codes, resq, scale, table, bucket_of, dm, qm = args
        got = cm.colbert_maxsim_residual_rerank_op(*args, bits=bits)
        exact = _exact(q, _decoded(codes, resq, scale, table, bucket_of,
                                   bits), dm, qm)
        real = exact > -1e29
        assert exact[real].abs().max() > 50
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        for dim in (36, 136):
            args = [t.to(dev) for t in _rerank_case(1, 2, 4, 3, 8, dim, 4,
                                                    8)]
            with pytest.raises(ValueError, match=f"dim={dim}"):
                cm.colbert_maxsim_residual_rerank_op(*args, bits=4)
