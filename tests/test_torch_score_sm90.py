"""The Hopper score kernels' arithmetic, emulated on the CPU: B2
(``maxsim_topk``) and the bf16-docs route of B3 (``colbert_maxsim_multi``).

Both kernels split their fp32 operands into three bf16 terms (hi + mid +
lo == x), multiply terms on the tensor cores (each product exact in
fp32) and skip the mid and lo terms of a row group whose flag says they
are all zero.  B2 keeps hi·hi in one fp32 accumulator and the smaller
products in a second (``_scores``); bf16 B3 sums each 16-column step's
products on their own and adds the steps in fp32 (``_scores_by_step``:
one running accumulator, which the tensor cores add to with truncation,
put its scores of docs of norm ~11 1.4e-5 from float64,
``TestLargeScoresOnCard``).  Both are repeated in torch fp32; B2's
register epilogue (per-thread lists, the quad's bitonic merge under the
explicit (value desc, index asc) order) is mirrored step for step by
``_b2_epilogue``.  Both are held against the JAX op (Pallas in interpret
mode, as the JAX package's own tests run it) and the port's plain
version on the same inputs under chip_smoke.py's gates: 1e-5 abs, ids
equal wherever the gap to a neighbour exceeds 1e-5, the l x -1e30
sentinel within 1e-6 relative.  The error of a two-term split (hi + mid)
is printed beside, as information.  The ``cuda``-marked tests hold the
kernels against the plain versions on the card; they need no JAX.
"""

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.colbert_maxsim.ops import (
        colbert_maxsim_multi_op as j_multi)
    from repro.kernels.maxsim_topk.ops import maxsim_topk_op as j_topk
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from repro_torch.kernels.maxsim_top2 import ops as t2
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
from repro_torch.kernels.maxsim_topk import ops as tk
from repro_torch.kernels.maxsim_topk.ref import (maxsim_topk_ref,
                                                 topk_lowest_index)

ATOL = 1e-5
NEG = -1e30
B2_TILE = 64        # tokens a B2 tile (csrc TILE)
B2_GROUP = 64       # sample rows a B2 flag covers
INT_MAX = 2 ** 31 - 1


def _split(x):
    """fp32 -> (hi, mid, lo), bf16 values held in fp32 tensors."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    lo = (x - hi - mid).bfloat16().float()
    return hi, mid, lo


def _flags(x, group_rows):
    """The pre-pass's flag per group of rows: any mid or lo non-zero."""
    _, mid, lo = _split(x)
    nz = ((mid != 0) | (lo != 0)).reshape(x.shape[0], -1).any(-1)
    return torch.stack([nz[g:g + group_rows].any()
                        for g in range(0, x.shape[0], group_rows)])


def _scores(a, b, *, terms=3):
    """a (R, d) . b (C, d)^T as the kernels compute it: hi·hi in one
    accumulator, the products of terms above 2^-24 relative (hi·mid,
    mid·hi, hi·lo, lo·hi, mid·mid) in another, added once.  A flagged-off
    group's mid and lo are zero, so skipping them is the same sum.
    ``terms=2`` drops lo (information only)."""
    ah, am, al = _split(a)
    bh, bm, bl = _split(b)
    if terms == 2:
        al, bl = torch.zeros_like(al), torch.zeros_like(bl)
    acc = ah @ bh.T
    acc2 = am @ bh.T + al @ bh.T + ah @ bm.T + ah @ bl.T + am @ bm.T
    return acc + acc2


def _scores_by_step(a, b, terms=3):
    """The split scores of B3-B6 (csrc sm90::split_mma_n64_rn): each
    16-column step's products summed on their own, the small ones first
    (mid·mid, then hi·lo and hi·mid of b's terms, then a's) and hi·hi
    last, and the steps added in fp32 in order.  ``terms=2`` drops lo."""
    ah, am, al = _split(a)
    bh, bm, bl = _split(b)
    if terms == 2:
        al, bl = torch.zeros_like(al), torch.zeros_like(bl)
    acc = None
    for k in range(0, a.shape[1], 16):
        c = slice(k, k + 16)
        t = am[:, c] @ bm[:, c].T
        for x, y in ((ah, bl), (ah, bm), (al, bh), (am, bh), (ah, bh)):
            t = t + x[:, c] @ y[:, c].T
        acc = t if acc is None else acc + t
    return acc


def _before(va, ia, vb, ib):
    return va > vb or (va == vb and ia < ib)


def _insert(kv, ki, v, j):
    """csrc maxsim_topk.cu insert(): strict > against the thread's own,
    lower-indexed entries."""
    K = len(kv)
    if not v > kv[-1]:
        return
    b = [v > x for x in kv]
    nv, ni = kv[:], ki[:]
    for p in range(K - 1, 0, -1):
        nv[p] = kv[p - 1] if b[p - 1] else (v if b[p] else kv[p])
        ni[p] = ki[p - 1] if b[p - 1] else (j if b[p] else ki[p])
    nv[0], ni[0] = (v, j) if b[0] else (kv[0], ki[0])
    kv[:], ki[:] = nv, ni


def _merge(kv, ki, ov, oi):
    """csrc merge_quad(), one step: own list and the partner's reversed,
    the better of each pair, then a bitonic sort, all under (value desc,
    index asc)."""
    K = len(kv)
    ov, oi = ov[::-1], oi[::-1]
    v, ix = kv[:], ki[:]
    for p in range(K):
        if _before(ov[p], oi[p], v[p], ix[p]):
            v[p], ix[p] = ov[p], oi[p]
    j = K // 2
    while j:
        for p in range(K):
            if p & j == 0 and _before(v[p + j], ix[p + j], v[p], ix[p]):
                v[p], v[p + j] = v[p + j], v[p]
                ix[p], ix[p + j] = ix[p + j], ix[p]
        j //= 2
    return v, ix


def _k_cap(k):
    return next(c for c in (4, 8, 16, 32) if k <= c)


def _b2_epilogue(row, live, k):
    """One sample's scores over one doc's m tokens (a list of floats),
    through the kernel's epilogue: lane q of the quad meets columns
    8 i + 2 q + e of each 64-column tile in that order; then the quad
    merges with lane xor 1, then xor 2.  The kernel has two lanes do each
    row's merges; all four are computed here and must agree."""
    m, K = len(row), _k_cap(k)
    lists = [([-np.inf] * K, [INT_MAX] * K) for _ in range(4)]
    for c0 in range(0, m, B2_TILE):
        for q in range(4):
            for i in range(8):
                for e in range(2):
                    col = c0 + 8 * i + 2 * q + e
                    if col < m:
                        v = row[col] if live[col] else np.float32(NEG)
                        _insert(*lists[q], v, col)
    for mask in (1, 2):
        lists = [_merge(*lists[q], *lists[q ^ mask]) for q in range(4)]
    assert all(lst == lists[0] for lst in lists)
    return lists[0][0][:k], lists[0][1][:k]


def _b2_emulate(samples, tokens, alive, k, terms=3):
    """(B, N, k) values and ids as the B2 kernel computes them."""
    B, m, _ = tokens.shape
    vals = np.zeros((B, samples.shape[0], k), np.float32)
    ids = np.zeros((B, samples.shape[0], k), np.int64)
    for b in range(B):
        s = _scores(samples, tokens[b], terms=terms).numpy()
        for n in range(samples.shape[0]):
            v, i = _b2_epilogue(list(s[n]), alive[b].tolist(), k)
            vals[b, n], ids[b, n] = v, i
    return torch.from_numpy(vals), torch.from_numpy(ids)


def _ids_ok(ids, ref_ids, ref_sorted, tol=ATOL):
    """chip_smoke.py's rule: ids equal wherever the reference value is
    more than ``tol`` from its neighbours (``ref_sorted`` has k + 1)."""
    k = ids.shape[-1]
    gap_prev = torch.full_like(ref_sorted[..., :k], float("inf"))
    gap_prev[..., 1:] = ref_sorted[..., 1:k] - ref_sorted[..., :k - 1]
    gap_next = ref_sorted[..., :k] - ref_sorted[..., 1:k + 1]
    tie = (gap_prev.abs() <= tol) | (gap_next.abs() <= tol)
    return int(((ids != ref_ids.long()) & ~tie).sum())


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bf16_exact(x):
    return torch.from_numpy(x).bfloat16().float().numpy()


class TestSplit:
    def test_three_terms_are_exact(self):
        """hi + mid + lo == x for normal fp32, and each term is a bf16
        value; two terms leave ~2^-16 relative."""
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=100_000).astype(np.float32) * 10.0 ** np.random.default_rng(
            1).integers(-20, 20, 100_000).astype(np.float32))
        hi, mid, lo = _split(x)
        for t in (hi, mid, lo):
            assert torch.equal(t, t.bfloat16().float())
        assert torch.equal(hi + mid + lo, x)
        assert ((x - hi - mid).abs() <= 2.0 ** -16 * x.abs()).all()
        assert ((x - hi - mid) != 0).any()

    def test_bf16_exact_data_flags_off(self):
        """The encoder's bf16 output widened: mid and lo are exactly zero,
        so the pre-pass's flag is 0 and the kernels skip them; one fp32
        sample in a group sets only that group's flag."""
        rng = np.random.default_rng(2)
        x = torch.from_numpy(_bf16_exact(_unit(rng, 200, 32)))
        _, mid, lo = _split(x)
        assert not mid.any() and not lo.any()
        assert not _flags(x, B2_GROUP).any()
        x[130, 5] = 0.1
        assert _flags(x, B2_GROUP).tolist() == [False, False, True, False]


def _topk_case(seed, N, m, dim, *, exact_tokens, exact_samples=False):
    rng = np.random.default_rng(seed)
    S, D = _unit(rng, N, dim), _unit(rng, 2, m, dim)
    if exact_tokens:
        D = _bf16_exact(D)
    if exact_samples:
        S = _bf16_exact(S)
    alive = rng.random((2, m)) < 0.8
    alive[1, :m // 2] = False
    return S, D, alive


B2_CASES = [
    # (N, m, dim, k, exact tokens, exact samples): m 70 and 130 cross the
    # 64-token tile; k 1..24 over the 4, 8, 16 and 32 lists
    (24, 70, 32, 1, True, False),
    (24, 70, 32, 8, True, False),
    (24, 130, 32, 16, True, False),
    (24, 130, 32, 24, False, False),
    (24, 70, 32, 5, False, False),
    (24, 70, 32, 16, True, True),
]


class TestMaxsimTopkArithmetic:
    @pytest.mark.parametrize("N,m,dim,k,exact_t,exact_s", B2_CASES)
    def test_emulation_matches_pallas_and_plain(self, N, m, dim, k, exact_t,
                                                exact_s):
        S, D, alive = _topk_case(N + m + k, N, m, dim, exact_tokens=exact_t,
                                 exact_samples=exact_s)
        s, d, al = (torch.from_numpy(x) for x in (S, D, alive))
        got_v, got_i = _b2_emulate(s, d, al, k)
        pv, pi = tk.maxsim_topk_op(s, d, al, k=k)
        rv, ri = maxsim_topk_ref(s, d, al, k + 1)
        for b in range(2):
            jv, ji = j_topk(jnp.asarray(S), jnp.asarray(D[b]),
                            jnp.asarray(alive[b]), k=k)
            jv = torch.from_numpy(np.array(jv))
            assert (got_v[b] - jv).abs().max() <= ATOL
            assert _ids_ok(got_i[b], torch.from_numpy(np.array(ji)),
                           rv[b]) == 0
        assert (got_v - pv).abs().max() <= ATOL
        assert _ids_ok(got_i, pi, rv) == 0
        two_v, _ = _b2_emulate(s, d, al, k, terms=2)
        print(f"N{N} m{m} k{k} exact tokens {exact_t} samples {exact_s}: "
              f"three terms vs plain {(got_v - pv).abs().max():.3e}; two "
              f"terms {(two_v - pv).abs().max():.3e}")

    def test_all_dead_and_few_alive_docs(self):
        """An all-dead doc outputs its first k tokens at -1e30; a doc with
        fewer than k alive fills the tail with its lowest dead indices."""
        rng = np.random.default_rng(5)
        S, D = _unit(rng, 8, 16), _bf16_exact(_unit(rng, 2, 70, 16))
        alive = np.zeros((2, 70), bool)
        alive[1, [3, 40, 66]] = True
        s, d, al = (torch.from_numpy(x) for x in (S, D, alive))
        v, i = _b2_emulate(s, d, al, 8)
        pv, pi = tk.maxsim_topk_op(s, d, al, k=8)
        assert torch.equal(i[0], torch.arange(8).expand(8, 8))
        assert (v[0] == np.float32(NEG)).all()
        assert torch.equal(i, pi.long())
        assert torch.equal(i[1, :, 3:], torch.tensor([0, 1, 2, 4, 5])
                           .expand(8, 5))

    @pytest.mark.parametrize("pattern", ["all_equal", "pairs", "integers",
                                         "dead_ties", "wide"])
    def test_quad_merge_orders_ties_by_index(self, pattern):
        """Crafted ties across the four lanes' columns: the merged list
        equals the stable descending sort, lowest index first among
        equal values."""
        rng = np.random.default_rng(7)
        m, k = (300, 32) if pattern == "wide" else (70, 16)
        live = [True] * m
        if pattern == "all_equal":
            row = [np.float32(0.5)] * m
        elif pattern == "pairs":
            # equal values on neighbouring lanes (columns 2q and 2q + 2)
            row = [np.float32((c // 4) % 5) for c in range(m)]
        elif pattern == "integers":
            row = [np.float32(x) for x in rng.integers(0, 4, m)]
        elif pattern == "dead_ties":
            row = [np.float32(x) for x in rng.integers(0, 3, m)]
            live = (rng.random(m) < 0.1).tolist()
        else:
            row = [np.float32(x) for x in rng.integers(-3, 3, m)]
        v, i = _b2_epilogue(row, live, k)
        masked = torch.where(torch.tensor(live), torch.tensor(row),
                             torch.tensor(NEG, dtype=torch.float32))
        wv, wi = topk_lowest_index(masked[None], k)
        assert i == wi[0].tolist()
        assert np.array_equal(np.float32(v), wv[0].numpy())


def _colbert_case(seed, n_q, l, n_docs, m, dim, *, exact_q):
    rng = np.random.default_rng(seed)
    q, d = _unit(rng, n_q, l, dim), _bf16_exact(_unit(rng, n_docs, m, dim))
    if exact_q:
        q = _bf16_exact(q)
    dm = rng.random((n_docs, m)) < 0.7
    dm[1] = False                      # all-masked doc
    qm = rng.random((n_q, l)) < 0.8
    qm[:, 0] = True
    qm[2 % n_q] = False                # all-masked query
    return q, d, dm, qm


def _b3_emulate(q, d, dm, qm, terms=3):
    """(n_q, n_docs) as the bf16 B3 kernel computes it: split scores
    summed step by step, masked doc tokens at -1e30, each row's max, the
    live query tokens' maxima summed in double and rounded once."""
    n_q, l, dim = q.shape
    s = _scores_by_step(q.reshape(-1, dim), d.reshape(-1, dim), terms=terms)
    s = s.reshape(n_q, l, d.shape[0], d.shape[1])
    s = torch.where(dm[None, None], s, torch.tensor(NEG))
    best = s.amax(-1).double()
    best = torch.where(qm[..., None], best, 0.0)
    return best.sum(1).float()


B3_CASES = [
    # (n_q, l, n_docs, m, dim, exact queries): l 1, 32 and 40 (one query a
    # warpgroup); m 8 (16 docs a tile), 100 (one, padded to 128) and 130
    # (two tiles a doc)
    (5, 32, 9, 100, 32, True),
    (5, 32, 9, 100, 32, False),
    (3, 40, 7, 130, 32, False),
    (6, 1, 20, 8, 32, False),
    (4, 32, 40, 8, 16, True),
]


class TestColbertMultiBf16Arithmetic:
    @pytest.mark.parametrize("n_q,l,n_docs,m,dim,exact_q", B3_CASES)
    def test_emulation_matches_pallas_and_plain(self, n_q, l, n_docs, m, dim,
                                                exact_q):
        q, d, dm, qm = _colbert_case(n_q * l + m, n_q, l, n_docs, m, dim,
                                     exact_q=exact_q)
        tq, td, tdm, tqm = (torch.from_numpy(x) for x in (q, d, dm, qm))
        got = _b3_emulate(tq, td, tdm, tqm)
        plain = cm.colbert_maxsim_multi_op(tq, td.bfloat16(), tdm, tqm)
        want = torch.from_numpy(np.asarray(j_multi(
            jnp.asarray(q), jnp.asarray(d).astype(jnp.bfloat16),
            jnp.asarray(dm), jnp.asarray(qm))))
        for ref in (plain, want):
            real = ref > -1e29
            assert (got - ref)[real].abs().max() <= ATOL
            assert ((got - ref) / ref)[~real].abs().max() <= 1e-6
        assert (~(plain > -1e29)).any()           # the all-masked doc
        assert (plain[2 % n_q] == 0).all()        # the all-masked query
        two = _b3_emulate(tq, td, tdm, tqm, terms=2)
        real = plain > -1e29
        print(f"n_q{n_q} l{l} n_docs{n_docs} m{m} exact queries {exact_q}: "
              f"three terms vs plain {(got - plain)[real].abs().max():.3e}; "
              f"two terms {(two - plain)[real].abs().max():.3e}")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs them on the card")
    return torch.device("cuda")


B2_CARD = [(N, m, k) for m, k in [(7, 1), (7, 7), (180, 16), (180, 1),
                                  (300, 24), (300, 32), (180, 4), (64, 8)]
           for N in (200, 2048)]


@pytest.mark.cuda
class TestMaxsimTopkOnCard:
    @pytest.mark.parametrize("exact_tokens", [True, False])
    @pytest.mark.parametrize("N,m,k", B2_CARD)
    def test_kernel_matches_plain(self, N, m, k, exact_tokens):
        """N 200 is no multiple of the 128-sample block; m 7, 180 and 300
        of the 64-token tile (300 needs the 32-entry lists); fp32 tokens
        that are not bf16-exact take the six-product path.  Doc 1 is all
        dead and doc 2 has fewer than k alive tokens."""
        dev = _cuda()
        rng = np.random.default_rng(N + m + k)
        S = _unit(rng, N, 128)
        D = _unit(rng, 5, m, 128)
        if exact_tokens:
            D = _bf16_exact(D)
        alive = rng.random((5, m)) < 0.8
        alive[1] = False
        alive[2] = False
        alive[2, :: max(1, m // max(1, k - 1))] = True
        s, d, al = (torch.from_numpy(x).to(dev) for x in (S, D, alive))
        before = tk.maxsim_topk_op.launches
        v, i = tk.maxsim_topk_op(s, d, al, k=k)
        torch.cuda.synchronize()
        assert tk.maxsim_topk_op.launches == before + 1
        rv, ri = maxsim_topk_ref(s, d, al, min(k + 1, m))
        if rv.shape[-1] == k:
            rv = torch.cat([rv, rv[..., -1:] - 1], -1)
        assert (v - rv[..., :k]).abs().max().item() <= ATOL
        assert _ids_ok(i, ri[..., :k], rv) == 0
        assert torch.equal(i[1], torch.arange(k, device=dev, dtype=i.dtype)
                           .expand(N, k))

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        s, d = torch.zeros(4, 136, device=dev), torch.zeros(1, 8, 136,
                                                            device=dev)
        with pytest.raises(ValueError, match="dim=136"):
            tk.maxsim_topk_op(s, d, torch.ones(1, 8, dtype=torch.bool,
                                               device=dev), k=4)


B3_CARD = [
    # (n_q, l, n_docs, m): l 1, 32 and 40; n_docs tails; m 8, 64, 100
    # (padded to 128), 128 and 180 (two tiles a doc)
    (64, 32, 1000, 128), (5, 32, 37, 100), (7, 40, 33, 180),
    (9, 1, 50, 8), (64, 32, 300, 64), (3, 64, 17, 128),
]


@pytest.mark.cuda
class TestColbertMultiBf16OnCard:
    @pytest.mark.parametrize("exact_q", [True, False])
    @pytest.mark.parametrize("n_q,l,n_docs,m", B3_CARD)
    def test_kernel_matches_plain(self, n_q, l, n_docs, m, exact_q):
        """All-masked docs score the l x -1e30 sentinel (1e-6 relative),
        all-masked queries 0; queries that are not bf16-exact take the
        three-term path."""
        dev = _cuda()
        q, d, dm, qm = _colbert_case(n_q + l + m, n_q, l, n_docs, m, 128,
                                     exact_q=exact_q)
        tq, tdm, tqm = (torch.from_numpy(x).to(dev) for x in (q, dm, qm))
        td = torch.from_numpy(d).to(dev).bfloat16()
        before = cm.colbert_maxsim_multi_op.bf16_launches
        got = cm.colbert_maxsim_multi_op(tq, td, tdm, tqm)
        torch.cuda.synchronize()
        assert cm.colbert_maxsim_multi_op.bf16_launches == before + 1
        want = cm_ref.colbert_maxsim_multi_ref(tq, td, tdm, tqm)
        real = want > -1e29
        assert (got - want)[real].abs().max().item() <= ATOL
        assert ((got - want) / want)[~real].abs().max().item() <= 1e-6
        assert (got[2 % n_q] == 0).all()

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        q = torch.zeros(2, 4, 36, device=dev)
        d = torch.zeros(3, 8, 36, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="dim=36"):
            cm.colbert_maxsim_multi_op(q, d, torch.ones(3, 8, dtype=torch.bool,
                                                        device=dev))


@pytest.mark.cuda
class TestLargeScoresOnCard:
    """B1, B2 and bf16 B3 where the tokens are far from unit norm (randn,
    norm ~11) and the samples and queries unit: each value within 1e-5 of
    a float64 reference of the same operands, the fp32 plain version's own
    error printed beside.  The tensor cores add each product group to
    their fp32 accumulator with truncation, which puts sums of 32 maxima
    (scores up to ~90) up to 2e-5 low unless the kernel sums its k16
    steps apart."""

    @pytest.mark.parametrize("exact_tokens", [True, False])
    def test_pruning_values_stay_near_exact(self, exact_tokens):
        dev = _cuda()
        rng = np.random.default_rng(11)
        D = rng.normal(size=(5, 180, 128)).astype(np.float32)
        if exact_tokens:
            D = _bf16_exact(D)
        s, d = (torch.from_numpy(x).to(dev) for x in (_unit(rng, 300, 128),
                                                       D))
        al = torch.from_numpy(rng.random((5, 180)) < 0.8).to(dev)
        exact = torch.where(al[:, None], torch.einsum(
            "nd,bmd->bnm", s.double(), d.double()), -1e30).topk(16).values
        for name, got, plain in (
                ("B2 top-16", tk.maxsim_topk_op(s, d, al, k=16)[0],
                 maxsim_topk_ref(s, d, al, 16)[0]),
                ("B1 best", t2.maxsim_top2_op(s, d, al)[0],
                 maxsim_top2_ref(s, d, al)[0]),
                ("B1 second", t2.maxsim_top2_op(s, d, al)[1],
                 maxsim_top2_ref(s, d, al)[1])):
            want = (exact if name.startswith("B2")
                    else exact[..., int(name.endswith("second"))])
            err = (got.double() - want).abs().max().item()
            print(f"{name}, tokens bf16-exact {exact_tokens} (|value| <= "
                  f"{want.abs().max().item():.1f}): kernel {err:.2e}, plain "
                  f"{(plain.double() - want).abs().max().item():.2e}")
            assert err <= ATOL

    @pytest.mark.parametrize("exact_q", [True, False])
    @pytest.mark.parametrize("m", [8, 130])
    def test_bf16_multi_stays_near_exact(self, m, exact_q):
        dev = _cuda()
        rng = np.random.default_rng(m)
        q = _unit(rng, 6, 32, 128)
        if exact_q:
            q = _bf16_exact(q)
        q = torch.from_numpy(q).to(dev)
        d = torch.from_numpy(rng.normal(size=(37, m, 128)).astype(
            np.float32)).to(dev).bfloat16()
        dm = torch.from_numpy(rng.random((37, m)) < 0.8).to(dev)
        dm[1] = False
        qm = torch.from_numpy(rng.random((6, 32)) < 0.9).to(dev)
        s = torch.where(dm[:, None, :], torch.einsum(
            "qld,nmd->qnlm", q.double(), d.double()), -1e30).amax(-1)
        exact = torch.where(qm[:, None, :], s, 0.0).sum(-1)
        got = cm.colbert_maxsim_multi_op(q, d, dm, qm)
        plain = cm_ref.colbert_maxsim_multi_ref(q, d, dm, qm)
        real = exact > -1e29
        err = (got.double() - exact)[real].abs().max().item()
        print(f"bf16 B3 m {m}, queries bf16-exact {exact_q} (|score| <= "
              f"{exact[real].abs().max().item():.1f}): kernel {err:.2e}, "
              f"plain {(plain.double() - exact)[real].abs().max().item():.2e}")
        assert exact[real].abs().max() > 20
        assert err <= ATOL
        assert ((got.double() - exact) / exact)[~real].abs().max() <= 1e-6
