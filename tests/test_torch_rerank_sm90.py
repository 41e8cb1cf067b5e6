"""The Hopper kernel of B4 (``colbert_maxsim_rerank``, and
``colbert_maxsim`` as its one-query case), its arithmetic emulated on the
CPU.

B4 runs the split-bf16 sweep of ``csrc/colbert_maxsim.cu`` (namespace
``rerank_dense``): a block takes one query, its rows padded to 64, and a
group of that query's candidates (``_docs_per_block``: about four blocks
an SM of the H100's 132); it sweeps them in 64-token tiles, each G = 64 /
m_pad candidates of m_pad = pow2(m) >= 8 rows, or one 64-row slice of a
candidate longer than 32, zero rows past m and past the block's last
candidate.  The query splits into three bf16 terms (hi + mid + lo ==
x); fp32 candidates split into three in the producer, bf16 ones are one
exact term.  ``_b4_emulate`` walks that grid: each tile's products summed
one 16-column step at a time, each step on its own, the steps added in
fp32 (``_scores_by_step``), each row's max over the tile's live columns
of each candidate (masked tokens at -1e30), carried across the tiles of
a long candidate, and a query's live tokens' maxima summed in double and
rounded once (masked query tokens add 0).

The emulation is held against the JAX ops (``colbert_maxsim_rerank_op``
and, for one query, ``colbert_maxsim``: Pallas in interpret mode, as the
JAX package's own tests run it) and the port's plain versions on the
same inputs, under chip_smoke.py's gates: 1e-5 abs, the l x -1e30
sentinel within 1e-6 relative.  On candidates of norm ~11 (scores up to
~90), where the fp32 plain version is itself ~1e-5 from the exact value,
it is held to a float64 MaxSim of the same tokens at 1e-5.  The
``cuda``-marked tests hold the kernel to the plain version on unit data
and to a float64 MaxSim on norm-11 data, and check what the wrapper
rejects and counts; they need no JAX.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.colbert_maxsim.colbert_maxsim import (
        colbert_maxsim as j_single)
    from repro.kernels.colbert_maxsim.ops import (
        colbert_maxsim_rerank_op as j_rerank)
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from test_torch_multi_fp32_resid_rerank_sm90 import _assert_scores, _exact
from test_torch_score_sm90 import (_bf16_exact, _cuda, _scores_by_step,
                                   _unit)

ATOL = 1e-5
NEG = np.float32(-1e30)
TN = 64             # doc rows a tile (csrc sweep::TN)
SMS = 132           # the H100's SMs, which size a block's candidate group


def _tiles(m):
    """csrc sweep::geometry: (G, m_pad, tiles a candidate)."""
    m_pad = 8
    while m_pad < m:
        m_pad *= 2
    if m_pad >= TN:
        return 1, TN, -(-m // TN)
    return TN // m_pad, m_pad, 1


def _docs_per_block(n_cand, G, n_q):
    """csrc sweep::docs_per_block: candidates a block, a whole number of
    tile groups, for about four blocks an SM over n_q query blocks."""
    units = -(-n_cand // G)
    groups = max(1, min(units, -(-4 * SMS // n_q)))
    return -(-units // groups) * G


def _b4_emulate(q, d, dm, qm):
    """(n_q, n_cand) as the B4 kernel computes it, block by block and
    tile by tile: q (n_q, l, dim) f32; d (n_q, n_cand, m, dim) f32 or
    bf16; dm (n_q, n_cand, m); qm (n_q, l)."""
    n_q, l, dim = q.shape
    n_cand, m = d.shape[1:3]
    G, m_pad, per_doc = _tiles(m)
    dpb = _docs_per_block(n_cand, G, n_q)
    cols = torch.arange(TN)
    out = torch.zeros(n_q, n_cand, dtype=torch.float64)

    def finish(i, c, best):
        out[i, c] = torch.where(qm[i], best.double(), 0.0).sum()

    for i in range(n_q):
        for d_begin in range(0, n_cand, dpb):
            d_end = min(n_cand, d_begin + dpb)
            n_tiles = ((d_end - d_begin) * per_doc if G == 1
                       else -(-(d_end - d_begin) // G))
            run = None
            for it in range(n_tiles):
                t = it % per_doc if G == 1 else 0
                doc0 = d_begin + (it // per_doc if G == 1 else it * G)
                doc = doc0 + (0 * cols if G == 1 else cols // m_pad)
                tok = t * TN + cols if G == 1 else cols % m_pad
                real = (doc < d_end) & (tok < m)
                tile = torch.zeros(TN, dim)
                tile[real] = d[i, doc[real], tok[real]].float()
                live = torch.zeros(TN, dtype=torch.bool)
                live[real] = dm[i, doc[real], tok[real]]
                s = torch.where(live, _scores_by_step(q[i], tile),
                                torch.tensor(NEG))
                if G == 1:
                    best = s.amax(1)
                    run = best if t == 0 else torch.maximum(run, best)
                    if t + 1 == per_doc:
                        finish(i, doc0, run)
                    continue
                for g in range(G):
                    if doc0 + g < d_end:
                        finish(i, doc0 + g,
                               s[:, g * m_pad:(g + 1) * m_pad].amax(1))
    return out.float()


def _case(seed, n_q, l, n_cand, m, dim, kind, *, norm11=False):
    """Unit queries with masked tokens, query 1 all masked where there
    are two or more; the candidates ``fp32`` unit tokens (three terms),
    ``exact`` bf16-exact fp32, or ``bf16``; randn tokens (norm ~11) with
    ``norm11``; candidate (i, 1) all masked and each candidate's first
    token live."""
    rng = np.random.default_rng(seed)
    q = _unit(rng, n_q, l, dim)
    d = (rng.normal(size=(n_q, n_cand, m, dim)).astype(np.float32)
         if norm11 else _unit(rng, n_q, n_cand, m, dim))
    if kind != "fp32":
        d = _bf16_exact(d)
    dm = rng.random((n_q, n_cand, m)) < 0.7
    dm[..., 0] = True
    dm[:, 1 % n_cand] = False
    qm = rng.random((n_q, l)) < 0.8
    qm[:, 0] = True
    qm[1 % n_q] = n_q == 1
    q, d, dm, qm = (torch.from_numpy(x) for x in (q, d, dm, qm))
    return q, (d.bfloat16() if kind == "bf16" else d), dm, qm


def _jax_rerank(q, d, dm, qm):
    jd = jnp.asarray(d.float().numpy())
    if d.dtype == torch.bfloat16:
        jd = jd.astype(jnp.bfloat16)
    return torch.from_numpy(np.array(j_rerank(
        jnp.asarray(q.numpy()), jd, jnp.asarray(dm.numpy()),
        jnp.asarray(qm.numpy()))))


CASES = [
    # (n_q, l, n_cand, m, dim, kind): m 1, 7 and 8 pack G = 8 candidates
    # a tile, 12 four, 20 two; 33 and 64 fill one tile (G 1), 65 and 130
    # take two or three, 180 three; n_cand 9 and 11 leave a partial last
    # group; 301 candidates at 2 queries give blocks of two, the last of
    # one; l 1, 32 and 64
    (3, 32, 9, 1, 16, "fp32"),
    (3, 32, 11, 7, 32, "bf16"),
    (2, 64, 9, 8, 16, "exact"),
    (3, 1, 11, 12, 16, "fp32"),
    (4, 32, 9, 20, 32, "bf16"),
    (2, 32, 5, 33, 16, "fp32"),
    (2, 64, 4, 64, 16, "bf16"),
    (3, 32, 5, 65, 32, "exact"),
    (2, 1, 301, 130, 16, "fp32"),
    (2, 32, 3, 180, 16, "bf16"),
]


class TestRerankDenseArithmetic:
    @pytest.mark.parametrize("n_q,l,n_cand,m,dim,kind", CASES)
    def test_emulation_matches_pallas_and_plain(self, n_q, l, n_cand, m, dim,
                                                kind):
        q, d, dm, qm = _case(n_q * l + m, n_q, l, n_cand, m, dim, kind)
        got = _b4_emulate(q, d, dm, qm)
        plain = cm.colbert_maxsim_rerank_op(q, d, dm, qm)
        for ref in (plain, _jax_rerank(q, d, dm, qm)):
            _assert_scores(got, ref)
        others = [i for i in range(n_q) if i != 1 % n_q]
        assert (plain[others, 1 % n_cand] < -1e29).all()   # all masked
        assert (plain[1 % n_q] == 0).all()        # the all-masked query

    @pytest.mark.parametrize("kind", ["fp32", "bf16"])
    def test_single_query_matches_pallas_and_plain(self, kind):
        """colbert_maxsim: one query against 300 candidates, the n_q = 1
        case of the same kernel, its candidates spread over blocks."""
        q, d, dm, qm = _case(5, 1, 32, 300, 20, 32, kind)
        assert _docs_per_block(300, _tiles(20)[0], 1) < 300
        got = _b4_emulate(q, d, dm, qm)[0]
        plain = cm.colbert_maxsim_op(q[0], d[0], dm[0], qm[0])
        jd = jnp.asarray(d[0].float().numpy())
        want = torch.from_numpy(np.array(j_single(
            jnp.asarray(q[0].numpy()),
            jd.astype(jnp.bfloat16) if kind == "bf16" else jd,
            jnp.asarray(dm[0].numpy()), jnp.asarray(qm[0].numpy()),
            interpret=True)))
        for ref in (plain, want):
            _assert_scores(got, ref)

    @pytest.mark.parametrize("kind", ["fp32", "bf16"])
    def test_large_scores_stay_near_exact(self, kind):
        """Candidates of norm ~11 (scores up to ~90): within 1e-5 of a
        float64 MaxSim of the same tokens."""
        q, d, dm, qm = _case(11, 2, 32, 5, 130, 128, kind, norm11=True)
        got = _b4_emulate(q, d, dm, qm)
        exact = _exact(q, d.float(), dm, qm)
        real = exact > -1e29
        assert exact[real].abs().max() > 50
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6


# ---- on the card ----

CARD = [
    # (n_q, l, n_cand, m): the two-stage path's 64 queries x 64
    # candidates x 128; m 1, 7, 8, 12 and 20 pack candidates, 33 and 64
    # fill a tile, 65, 130 and 180 take two or three; 301 candidates at 2
    # queries (blocks of two); l 1, 32 and 64
    (64, 32, 64, 128), (3, 32, 9, 1), (3, 32, 11, 7), (2, 64, 9, 8),
    (3, 1, 11, 12), (4, 32, 9, 20), (2, 32, 5, 33), (2, 64, 4, 64),
    (3, 32, 5, 65), (2, 32, 301, 130), (2, 32, 3, 180),
]


@pytest.mark.cuda
class TestRerankDenseOnCard:
    @pytest.mark.parametrize("kind", ["fp32", "exact", "bf16"])
    @pytest.mark.parametrize("n_q,l,n_cand,m", CARD)
    def test_kernel_matches_plain(self, n_q, l, n_cand, m, kind):
        dev = _cuda()
        q, d, dm, qm = (t.to(dev) for t in _case(
            n_q + l + m, n_q, l, n_cand, m, 128, kind))
        before = cm.colbert_maxsim_rerank_op.launches
        bf16_before = cm.colbert_maxsim_rerank_op.bf16_launches
        got = cm.colbert_maxsim_rerank_op(q, d, dm, qm)
        torch.cuda.synchronize()
        assert cm.colbert_maxsim_rerank_op.launches == before + 1
        assert (cm.colbert_maxsim_rerank_op.bf16_launches
                == bf16_before + (kind == "bf16"))
        _assert_scores(got, cm_ref.colbert_maxsim_rerank_ref(q, d, dm, qm))
        assert (got[1 % n_q] == 0).all()

    @pytest.mark.parametrize("kind", ["fp32", "bf16"])
    def test_single_query_matches_plain(self, kind):
        """colbert_maxsim_op: one query against 1,024 candidates."""
        dev = _cuda()
        q, d, dm, qm = (t.to(dev) for t in _case(
            7, 1, 32, 1024, 128, 128, kind))
        before = cm.colbert_maxsim_rerank_op.launches
        got = cm.colbert_maxsim_op(q[0], d[0], dm[0], qm[0])
        torch.cuda.synchronize()
        assert cm.colbert_maxsim_rerank_op.launches == before + 1
        _assert_scores(got, cm_ref.colbert_maxsim_ref(q[0], d[0], dm[0],
                                                      qm[0]))

    @pytest.mark.parametrize("kind", ["fp32", "bf16"])
    @pytest.mark.parametrize("m", [8, 130])
    def test_large_scores_stay_near_exact(self, m, kind):
        dev = _cuda()
        q, d, dm, qm = (t.to(dev) for t in _case(
            m, 6, 32, 37, m, 128, kind, norm11=True))
        got = cm.colbert_maxsim_rerank_op(q, d, dm, qm)
        exact = _exact(q, d.float(), dm, qm)
        real = exact > -1e29
        assert exact[real].abs().max() > 20
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        for dim in (36, 136):
            q = torch.zeros(2, 4, dim, device=dev)
            d = torch.zeros(2, 3, 8, dim, device=dev)
            with pytest.raises(ValueError, match=f"dim={dim}"):
                cm.colbert_maxsim_rerank_op(
                    q, d, torch.ones(2, 3, 8, dtype=torch.bool, device=dev))
        q = torch.zeros(2, 4, 128, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            n = 2 * 3 * 8 * 128
            d = torch.zeros(n + 2, device=dev, dtype=dtype)[2:].view(
                2, 3, 8, 128)                      # 4 or 8 bytes off
            with pytest.raises(ValueError, match="16-byte aligned"):
                cm.colbert_maxsim_rerank_op(
                    q, d, torch.ones(2, 3, 8, dtype=torch.bool, device=dev))
        with pytest.raises(ValueError, match="query length 65"):
            cm.colbert_maxsim_rerank_op(
                torch.zeros(2, 65, 128, device=dev),
                torch.zeros(2, 3, 8, 128, device=dev),
                torch.ones(2, 3, 8, dtype=torch.bool, device=dev))
