"""The Hopper pruning and residual-serving kernels' arithmetic, emulated
on the CPU: B1 (``maxsim_top2``) and B5 (``colbert_maxsim_residual_multi``).

B1 runs B2's skeleton (``csrc/maxsim_sm90.cuh``): samples and tokens
split into three bf16 terms (hi + mid + lo == x), products of terms exact
in fp32, hi·hi in one fp32 accumulator and the smaller products in a
second (``_scores`` of ``test_torch_score_sm90``).  Its epilogue — per
lane a (best, second) pair met in ascending column order with strict >,
the quad's merge with lane xor 1 then xor 2 under the explicit (value
desc, index asc) order, then ref.py's fix-up of the second on the merged
pair — is mirrored step by step by ``_b1_epilogue``.

B5 decodes a residual bucket in its producer warpgroup: ``_decode``
repeats the producer's arithmetic — a chunk's 8 values read as one
little-endian word, value i at bit bits·i, the code clamped into its
codebook, the product and the sum rounded apart — and the decoded
tokens are split into three terms and their products summed one
16-column step at a time, the steps added in fp32 (``_scores_by_step``:
the tensor cores add with truncation, so B5 keeps no running sum in
them); masked doc tokens score -1e30, each query token takes its max,
and a query's live tokens' maxima are summed in double and rounded
once.

Both are held against the JAX op (Pallas in interpret mode, as the JAX
package's own tests run it) and the port's plain version on the same
inputs, under chip_smoke.py's gates: 1e-5 abs; ids equal wherever the
gap to a neighbour exceeds 1e-5; B1's -1e30 sentinels and their indices
exact; B5's l x -1e30 sentinel within 1e-6 relative.  Codes out of range
are held to the plain version on clamped codes only: the Pallas kernel
gathers its codebook by a one-hot product, which gives a zero centroid
there.  The ``cuda``-marked tests hold the kernels against the plain
versions on the card; they need no JAX.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.colbert_maxsim.colbert_maxsim import (
        colbert_maxsim_residual_multi as j_res_multi)
    from repro.kernels.maxsim_top2.ops import maxsim_top2_op as j_top2
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.core.scoring import top2_from_scores
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from repro_torch.kernels.maxsim_top2 import ops as t2
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref
from repro_torch.train import compress
from test_torch_score_sm90 import (_before, _bf16_exact, _cuda, _scores,
                                   _scores_by_step, _split, _unit)

ATOL = 1e-5
NEG = np.float32(-1e30)
TILE = 64           # tokens a B1 tile (csrc maxsim_sm90.cuh TILE)
INT_MAX = 2 ** 31 - 1


# ---- B1 ----

def _take(p, v, j):
    """csrc Pair::take: a column of a higher index than the pair's."""
    gt1, gt2 = v > p[0], v > p[2]
    if gt1:
        p[2], p[3], p[0], p[1] = p[0], p[1], v, j
    elif gt2:
        p[2], p[3] = v, j


def _merge(p, o):
    """csrc Pair::merge: the top two of two disjoint pairs under (value
    desc, index asc)."""
    v1, i1, v2, i2 = p
    o1, j1, o2, j2 = o
    if _before(o1, j1, v1, i1):
        mine = _before(v1, i1, o2, j2)
        return [o1, j1, v1 if mine else o2, i1 if mine else j2]
    if _before(o1, j1, v2, i2):
        return [v1, i1, o1, j1]
    return [v1, i1, v2, i2]


def _fix_second(p):
    """ref.py's second on the merged pair: the best slot at -1e30 wins
    when nothing else beats -1e30, or ties there at a lower index."""
    v1, i1, v2, i2 = p
    if v2 < NEG or (v2 == NEG and i1 < i2):
        return [v1, i1, NEG, i1]
    return p


def _b1_epilogue(row, live, fix=True):
    """One sample's scores over one doc's m tokens through the kernel's
    epilogue: lane q of the quad meets columns 8 i + 2 q + e of each
    64-column tile in that order; the quad merges with lane xor 1, then
    xor 2 (every lane holds the result and all four must agree); then
    the fix-up.  Returns (best, argbest, second, argsecond)."""
    m = len(row)
    lanes = [[-np.inf, INT_MAX, -np.inf, INT_MAX] for _ in range(4)]
    for c0 in range(0, m, TILE):
        for q in range(4):
            for i in range(8):
                for e in range(2):
                    col = c0 + 8 * i + 2 * q + e
                    if col < m:
                        _take(lanes[q], row[col] if live[col] else NEG, col)
    for mask in (1, 2):
        lanes = [_merge(lanes[q], lanes[q ^ mask]) for q in range(4)]
    assert all(lane == lanes[0] for lane in lanes)
    return _fix_second(lanes[0]) if fix else lanes[0]


def _b1_emulate(samples, tokens, alive, terms=3):
    """(best, second, argbest, argsecond), each (B, N), as the B1 kernel
    computes them."""
    B, m, _ = tokens.shape
    N = samples.shape[0]
    v = np.zeros((2, B, N), np.float32)
    ix = np.zeros((2, B, N), np.int64)
    for b in range(B):
        s = _scores(samples, tokens[b], terms=terms).numpy()
        for n in range(N):
            v1, i1, v2, i2 = _b1_epilogue(list(s[n]), alive[b].tolist())
            v[:, b, n], ix[:, b, n] = (v1, v2), (i1, i2)
    return (torch.from_numpy(v[0]), torch.from_numpy(v[1]),
            torch.from_numpy(ix[0]), torch.from_numpy(ix[1]))


def _assert_top2(got, want, samples, tokens, alive):
    """chip_smoke.py's gate: values within 1e-5, argbest equal past a
    1e-5 gap to the second, argsecond equal past 1e-5 gaps on both
    sides; -1e30 seconds and their indices exact."""
    m = tokens.shape[-2]
    top3, _ = maxsim_topk_ref(samples, tokens, alive, min(3, m))
    if m < 3:
        top3 = torch.cat([top3, torch.full(top3.shape[:-1] + (3 - m,),
                                           float(NEG), device=top3.device)],
                         -1)
    g1, g2 = top3[..., 0] - top3[..., 1], top3[..., 1] - top3[..., 2]
    for g, w in zip(got[:2], want[:2]):
        assert (g - w).abs().max() <= ATOL
    assert (((got[2] == want[2].long()) | (g1 <= ATOL)).all())
    assert (((got[3] == want[3].long()) | (g1 <= ATOL) | (g2 <= ATOL)).all())
    sentinel = want[1] == NEG
    assert torch.equal(got[1][sentinel], want[1][sentinel])
    assert torch.equal(got[3][sentinel].long(), want[3][sentinel].long())


def _top2_case(seed, N, m, dim, *, exact_tokens):
    """Three docs: random alive tokens, all dead, and one alive token."""
    rng = np.random.default_rng(seed)
    S, D = _unit(rng, N, dim), _unit(rng, 3, m, dim)
    if exact_tokens:
        D = _bf16_exact(D)
    alive = rng.random((3, m)) < 0.8
    alive[1] = False
    alive[2] = False
    alive[2, m // 2] = True
    return S, D, alive


B1_CASES = [
    # (N, m, dim, exact tokens): m 7, 180 and 300 against the 64-token
    # tile (300 is five tiles, the last partial); m 1 leaves three lanes
    # of the quad empty
    (12, 7, 32, True),
    (12, 180, 32, True),
    (8, 300, 16, True),
    (12, 180, 32, False),
    (10, 1, 16, True),
]


class TestMaxsimTop2Arithmetic:
    @pytest.mark.parametrize("N,m,dim,exact_t", B1_CASES)
    def test_emulation_matches_pallas_and_plain(self, N, m, dim, exact_t):
        S, D, alive = _top2_case(N + m, N, m, dim, exact_tokens=exact_t)
        s, d, al = (torch.from_numpy(x) for x in (S, D, alive))
        got = _b1_emulate(s, d, al)
        plain = t2.maxsim_top2_op(s, d, al)
        _assert_top2(got, plain, s, d, al)
        for b in range(3):
            want = [torch.from_numpy(np.array(x)) for x in j_top2(
                jnp.asarray(S), jnp.asarray(D[b]), jnp.asarray(alive[b]))]
            _assert_top2([x[b] for x in got], want, s, d[b], al[b])
        # the all-dead doc: best and second token 0 at -1e30
        assert (got[0][1] == NEG).all() and (got[1][1] == NEG).all()
        assert (got[2][1] == 0).all() and (got[3][1] == 0).all()
        # one alive token: it is the best; the second is token 0 at
        # -1e30 (the lowest dead index), or the token itself when m = 1
        assert (got[2][2] == m // 2).all() and (got[1][2] == NEG).all()
        assert (got[3][2] == (0 if m > 1 else m // 2)).all()
        two = _b1_emulate(s, d, al, terms=2)
        print(f"N{N} m{m} exact tokens {exact_t}: three terms vs plain "
              f"{(got[0] - plain[0]).abs().max():.3e}; two terms "
              f"{(two[0] - plain[0]).abs().max():.3e}")

    @pytest.mark.parametrize("pattern", [
        "all_equal", "pairs", "integers", "dead_ties", "all_dead",
        "one_alive_first", "one_alive_late", "wide"])
    def test_epilogue_matches_ref_on_ties(self, pattern):
        """Crafted rows: the merged, fixed-up pair equals ref.py's
        (top2_from_scores) bit for bit, indices included."""
        rng = np.random.default_rng(11)
        m = 300 if pattern == "wide" else 70
        row = [np.float32(x) for x in rng.integers(0, 4, m)]
        live = [True] * m
        if pattern == "all_equal":
            row = [np.float32(0.5)] * m
        elif pattern == "pairs":
            # equal values on neighbouring lanes (columns 2q and 2q + 2)
            row = [np.float32((c // 4) % 5) for c in range(m)]
        elif pattern == "dead_ties":
            live = (rng.random(m) < 0.1).tolist()
        elif pattern == "all_dead":
            live = [False] * m
        elif pattern == "one_alive_first":
            live = [c == 0 for c in range(m)]
        elif pattern == "one_alive_late":
            live = [c == 45 for c in range(m)]
        elif pattern == "wide":
            row = [np.float32(x) for x in rng.integers(-3, 3, m)]
        v1, i1, v2, i2 = _b1_epilogue(row, live)
        w = top2_from_scores(torch.tensor(row)[None],
                             torch.tensor(live))
        assert [np.float32(v1), i1, np.float32(v2), i2] == [
            w[0].item(), w[2].item(), np.float32(w[1].item()), w[3].item()]

    def test_fix_up_on_the_merged_pair(self):
        """Without the fix-up the merged pair is lax.top_k's top two: an
        all-dead row gives second token 1 where ref.py's is token 0 (the
        best slot reset to -1e30, at a lower index), and a single token a
        -inf second where ref.py's is -1e30 at token 0."""
        for row, live, raw, want in (
                ([0.0] * 8, [False] * 8, (NEG, 0, NEG, 1), (NEG, 0, NEG, 0)),
                ([0.25], [True], (0.25, 0, -np.inf, INT_MAX),
                 (0.25, 0, NEG, 0))):
            row = [np.float32(x) for x in row]
            for fix, expect in ((False, raw), (True, want)):
                v1, i1, v2, i2 = _b1_epilogue(row, live, fix=fix)
                assert (np.float32(v1), i1, np.float32(v2), i2) == expect


# ---- B5 ----

def _decode(codes, resq, scale, codebook, bits):
    """The producer's decode: chunk c of a token's packed row (values
    8c .. 8c + 7) is one little-endian word of ``bits`` bytes, value i at
    bit bits·i; the code clamped into [0, C); cent + (u - 2^(bits-1)) ·
    scale with the product and the sum rounded apart (two fp32 torch
    ops, no fma)."""
    n, m, _ = resq.shape
    words = resq.numpy().view("<u4" if bits == 4 else "<u2")
    words = torch.from_numpy(words.astype(np.int64))
    u = torch.stack([(words >> (bits * i)) & ((1 << bits) - 1)
                     for i in range(8)], -1).reshape(n, m, -1)
    code = codes.long().clamp(0, codebook.shape[0] - 1)
    return codebook[code] + (u - 2 ** (bits - 1)).float() * scale


def _b5_emulate(q, codes, resq, scale, codebook, dm, qm, bits, terms=3):
    """(n_q, n_docs) as the B5 kernel computes it: decoded tokens split
    into three terms, split scores, masked tokens at -1e30, each query
    token's max, the live tokens' maxima summed in double, rounded
    once."""
    n_q, l, dim = q.shape
    n, m = codes.shape
    d = _decode(codes, resq, scale, codebook, bits)
    s = _scores_by_step(q.reshape(-1, dim), d.reshape(-1, dim), terms=terms)
    s = torch.where(dm.reshape(1, -1), s, torch.tensor(NEG))
    best = s.reshape(n_q, l, n, m).amax(-1).double()
    best = torch.where(qm[..., None], best, 0.0)
    return best.sum(1).float()


def _resid_case(seed, n_q, l, n_docs, m, dim, bits, C, *, exact_q):
    """A residual bucket through the port's codec: random codes, tokens
    near their centroids, one all-masked doc and a last doc whose second
    half is pad rows (code 0, residual bytes 0, masked); queries with
    masked tokens and one all-masked query."""
    rng = np.random.default_rng(seed)
    cb = _unit(rng, C, dim)
    codes = rng.integers(0, C, (n_docs, m)).astype(np.int8)
    x = cb[codes] + 0.2 * _unit(rng, n_docs, m, dim)
    resq, scale = compress.quantize_residual(
        torch.from_numpy(x - cb[codes]), bits)
    dm = rng.random((n_docs, m)) < 0.7
    dm[:, 0] = True
    dm[1] = False
    dm[-1, m // 2:] = False
    codes[-1, m // 2:] = 0
    resq[-1, m // 2:] = 0
    q = _unit(rng, n_q, l, dim)
    if exact_q:
        q = _bf16_exact(q)
    qm = rng.random((n_q, l)) < 0.8
    qm[:, 0] = True
    qm[2 % n_q] = False
    return (torch.from_numpy(q), torch.from_numpy(codes), resq, scale,
            torch.from_numpy(cb), torch.from_numpy(dm), torch.from_numpy(qm))


def _assert_scores(got, want):
    real = want > -1e29
    assert (got - want)[real].abs().max() <= ATOL
    assert ((got - want) / want)[~real].abs().max() <= 1e-6


B5_CASES = [
    # (n_q, l, n_docs, m, dim, bits, C, exact queries): m 20 packs G = 2
    # docs a 64-token tile (7 docs: the last tile half empty), m 8 packs
    # 8 (9 docs), m 100 and 130 take two and three tiles a doc
    (3, 8, 7, 20, 32, 4, 8, True),
    (3, 8, 7, 20, 32, 2, 8, False),
    (2, 8, 5, 100, 16, 4, 127, True),
    (2, 8, 5, 130, 16, 2, 127, False),
    (4, 5, 9, 8, 16, 4, 8, False),
    (4, 5, 9, 8, 16, 2, 127, True),
]


class TestResidualMultiArithmetic:
    @pytest.mark.parametrize("bits", [2, 4])
    @pytest.mark.parametrize("C", [8, 127])
    def test_decode_is_dequantize_residual(self, bits, C):
        """The producer's word-wise decode equals the eager decode bit
        for bit, and its three terms add back to it exactly."""
        _, codes, resq, scale, cb, _, _ = _resid_case(
            bits + C, 1, 1, 11, 40, 64, bits, C, exact_q=True)
        d = _decode(codes, resq, scale, cb, bits)
        assert torch.equal(d, compress.dequantize_residual(resq, scale,
                                                           codes, cb, bits))
        hi, mid, lo = _split(d)
        assert torch.equal(hi + mid + lo, d)
        assert (mid != 0).any() and (lo != 0).any()

    @pytest.mark.parametrize("n_q,l,n_docs,m,dim,bits,C,exact_q", B5_CASES)
    def test_emulation_matches_pallas_and_plain(self, n_q, l, n_docs, m, dim,
                                                bits, C, exact_q):
        args = _resid_case(n_q * l + m + bits, n_q, l, n_docs, m, dim, bits,
                           C, exact_q=exact_q)
        q, codes, resq, scale, cb, dm, qm = args
        got = _b5_emulate(q, codes, resq, scale, cb, dm, qm, bits)
        plain = cm.colbert_maxsim_residual_multi_op(q, codes, resq, scale,
                                                    cb, dm, qm, bits=bits)
        want = torch.from_numpy(np.array(j_res_multi(
            *(jnp.asarray(t.numpy()) for t in args), bits=bits,
            interpret=True)))
        for ref in (plain, want):
            _assert_scores(got, ref)
        others = [i for i in range(n_q) if i != 2 % n_q]
        assert (plain[others, 1] < -1e29).all()   # the all-masked doc
        assert (plain[2 % n_q] == 0).all()        # the all-masked query
        two = _b5_emulate(q, codes, resq, scale, cb, dm, qm, bits, terms=2)
        real = plain > -1e29
        print(f"n_q{n_q} m{m} bits{bits} C{C} exact queries {exact_q}: three "
              f"terms vs plain {(got - plain)[real].abs().max():.3e}; two "
              f"terms {(two - plain)[real].abs().max():.3e}")

    @pytest.mark.parametrize("bits", [2, 4])
    def test_codes_out_of_range_are_clamped(self, bits):
        """Codes past C - 1 read the last centroid and negative codes the
        first, as the plain version reads clamped codes."""
        q, codes, resq, scale, cb, dm, qm = _resid_case(
            5, 2, 8, 4, 30, 32, bits, 8, exact_q=False)
        bad = codes.clone()
        bad[0, :5] = 127
        bad[2, 3:9] = -5
        got = _b5_emulate(q, bad, resq, scale, cb, dm, qm, bits)
        want = cm_ref.colbert_maxsim_residual_multi_ref(
            q, bad.clamp(0, 7), resq, scale, cb, dm, qm, bits=bits)
        _assert_scores(got, want)
        assert not torch.equal(got, _b5_emulate(q, codes, resq, scale, cb,
                                                dm, qm, bits))


# ---- on the card ----

B1_CARD = [(N, m) for m in (1, 7, 64, 180, 300) for N in (200, 2048)]


@pytest.mark.cuda
class TestMaxsimTop2OnCard:
    @pytest.mark.parametrize("exact_tokens", [True, False])
    @pytest.mark.parametrize("N,m", B1_CARD)
    def test_kernel_matches_plain(self, N, m, exact_tokens):
        """N 200 is no multiple of the 128-sample block; m 1, 7, 180 and
        300 no multiple of the 64-token tile; fp32 tokens that are not
        bf16-exact take the six-product path.  Doc 1 is all dead and doc
        2 has one alive token."""
        dev = _cuda()
        S, D, alive = _top2_case(N + m, N, m, 128, exact_tokens=exact_tokens)
        s, d, al = (torch.from_numpy(x).to(dev) for x in (S, D, alive))
        before = t2.maxsim_top2_op.launches
        got = t2.maxsim_top2_op(s, d, al)
        torch.cuda.synchronize()
        assert t2.maxsim_top2_op.launches == before + 1
        want = maxsim_top2_ref(s, d, al)
        _assert_top2(got, want, s, d, al)
        for i in (1, 2, 3):     # the edge docs' ids and sentinels, exact
            assert torch.equal(got[i][1:], want[i][1:])

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        s, d = torch.zeros(4, 136, device=dev), torch.zeros(1, 8, 136,
                                                            device=dev)
        with pytest.raises(ValueError, match="dim=136"):
            t2.maxsim_top2_op(s, d, torch.ones(1, 8, dtype=torch.bool,
                                               device=dev))


B5_CARD = [(bits, C, m) for bits in (2, 4) for C in (8, 127)
           for m in (8, 20, 64, 128, 180)]


@pytest.mark.cuda
class TestResidualMultiOnCard:
    @pytest.mark.parametrize("exact_q", [True, False])
    @pytest.mark.parametrize("bits,C,m", B5_CARD)
    def test_kernel_matches_plain(self, bits, C, m, exact_q):
        """m 8 and 20 pack 8 and 2 docs a tile, 64 one, 128 and 180 two
        and three tiles a doc; 37 docs leave the last tile part empty;
        queries that are not bf16-exact take the six-product path."""
        dev = _cuda()
        args = [t.to(dev) for t in _resid_case(
            bits + C + m, 6, 32, 37, m, 128, bits, C, exact_q=exact_q)]
        before = cm.colbert_maxsim_residual_multi_op.launches
        got = cm.colbert_maxsim_residual_multi_op(*args, bits=bits)
        torch.cuda.synchronize()
        assert cm.colbert_maxsim_residual_multi_op.launches == before + 1
        want = cm_ref.colbert_maxsim_residual_multi_ref(*args, bits=bits)
        _assert_scores(got, want)
        assert (got[2] == 0).all()

    @pytest.mark.parametrize("bits", [2, 4])
    @pytest.mark.parametrize("C", [8, 127])
    def test_large_scores_stay_near_exact(self, bits, C):
        """Centroids far from unit norm (randn, norm ~11) give scores up
        to ~90, where an fp32 computation is itself some 1e-5 from the
        exact value: the kernel is held within 1e-5 of a float64 MaxSim
        of the same decoded tokens (the tensor cores add with truncation,
        and a running sum in them would drift further)."""
        dev = _cuda()
        g = torch.Generator().manual_seed(bits + C)
        cb = torch.randn(C, 128, generator=g)
        codes = torch.randint(0, C, (37, 130), generator=g, dtype=torch.int8)
        x = cb[codes.long()] + 0.3 * torch.randn(37, 130, 128, generator=g)
        resq, scale = compress.quantize_residual(x - cb[codes.long()], bits)
        dm = torch.rand(37, 130, generator=g) < 0.8
        dm[1] = False
        q = torch.from_numpy(_unit(np.random.default_rng(C), 6, 32, 128))
        qm = torch.rand(6, 32, generator=g) < 0.9
        q, codes, resq, scale, cb, dm, qm = (
            t.to(dev) for t in (q, codes, resq, scale, cb, dm, qm))
        got = cm.colbert_maxsim_residual_multi_op(q, codes, resq, scale, cb,
                                                  dm, qm, bits=bits)
        d = compress.dequantize_residual(resq, scale, codes, cb, bits)
        s = torch.einsum("qld,nmd->qnlm", q.double(), d.double())
        s = torch.where(dm[None, :, None, :], s, -1e30)
        exact = torch.where(qm[:, None, :], s.amax(-1), 0.0).sum(-1)
        real = exact > -1e29
        assert exact[real].abs().max() > 50
        assert (got.double() - exact)[real].abs().max() <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6

    def test_codes_out_of_range_are_clamped(self):
        dev = _cuda()
        q, codes, resq, scale, cb, dm, qm = (t.to(dev) for t in _resid_case(
            9, 4, 32, 20, 100, 128, 4, 8, exact_q=True))
        bad = codes.clone()
        bad[0, :5] = 127
        bad[3, 2:9] = -5
        got = cm.colbert_maxsim_residual_multi_op(q, bad, resq, scale, cb,
                                                  dm, qm, bits=4)
        want = cm_ref.colbert_maxsim_residual_multi_ref(
            q, bad.clamp(0, 7), resq, scale, cb, dm, qm, bits=4)
        torch.cuda.synchronize()
        _assert_scores(got, want)

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        for dim in (36, 136):
            q, codes, resq, scale, cb, dm, qm = (t.to(dev) for t in
                                                 _resid_case(
                1, 2, 4, 3, 8, dim, 4, 8, exact_q=True))
            with pytest.raises(ValueError, match=f"dim={dim}"):
                cm.colbert_maxsim_residual_multi_op(q, codes, resq, scale,
                                                    cb, dm, qm, bits=4)
