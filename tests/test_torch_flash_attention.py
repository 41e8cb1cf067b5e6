"""The flash-attention kernel module of the PyTorch port (B7) against the
JAX reference.

On the CPU the wrapper runs its plain PyTorch version; the same numpy
inputs go through the JAX oracle (``flash_attention_ref``) and the JAX op
(Pallas in interpret mode, as the JAX package's own tests run it).
Tolerance 2e-4 abs and rel, the JAX test's: the kernel and the oracle
sum the softmax in different orders.  ``TestSm90Arithmetic`` emulates
the bf16 CUDA route's arithmetic (split p, 128-key tiles) and holds it
to both under chip_smoke.py's bf16 gate; ``TestFp32SplitArithmetic``
emulates the fp32 route's (three-term bf16 splits of q, k, v and p, six
products into two accumulators, 32- or 64-key tiles, the softmax in
base 2) and holds it to both at 2e-4 and to the plain version at
``SPLIT_TOL``, which the same route with three products misses.  The
``cuda``-marked tests hold the CUDA kernel against the plain version on
the card; they need no JAX.
"""

import itertools
import math

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import (
        flash_attention_op as j_flash_op)
    from repro.kernels.flash_attention.ref import (
        flash_attention_ref as j_flash_ref)
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = 2e-4
# The fp32 route's own gate against the plain fp32 version.  Six split
# products leave its output within ~1e-6 of plain, the plain version's
# own distance from float64.  Keeping only hi·hi, hi·mid and mid·hi (each
# dropped product is 2^-16 of a term) moves it 4.5e-6 to 2.4e-5 on this
# file's fp32 cases, so 4e-6 tells a route with fewer products apart.
SPLIT_TOL = 4e-6


def _qkv(seed, H, KV, Sq, Sk, d, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (H, Sq, d)).astype(np.float32),
            rng.standard_normal(lead + (KV, Sk, d)).astype(np.float32),
            rng.standard_normal(lead + (KV, Sk, d)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


SWEEP = list(itertools.product([2, 4], [48, 100], [16, 32], [False, True],
                               [None, 24]))


class TestPlainMatchesJax:
    @pytest.mark.parametrize("H,S,d,causal,window", SWEEP)
    def test_sweep(self, H, S, d, causal, window):
        """The tests/test_kernels.py sweep; S 100 is no multiple of the
        Pallas kernel's 128 tile."""
        q, k, v = _qkv(H * S + d, H, H, S, S, d)
        kw = dict(causal=causal, window=window)
        want_ref = j_flash_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
        want_op = j_flash_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
        got_ref = flash_attention_ref(_t(q), _t(k), _t(v), **kw)
        got_op = ops.flash_attention_op(_t(q), _t(k), _t(v), **kw)
        for got in (got_ref, got_op):
            _close(got, want_ref)
            _close(got, want_op)

    @pytest.mark.parametrize("causal,window", [(True, None), (False, 24),
                                               (True, 24)])
    def test_gqa(self, causal, window):
        """H 4 on KV 2: query head h reads KV head h // 2, as the
        reference's jnp.repeat maps it."""
        q, k, v = _qkv(7, 4, 2, 100, 100, 32)
        kw = dict(causal=causal, window=window)
        want = j_flash_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
        got = ops.flash_attention_op(_t(q), _t(k), _t(v), **kw)
        _close(got, want)
        _close(got, j_flash_ref(jnp.asarray(q), jnp.repeat(k, 2, 0),
                                jnp.repeat(v, 2, 0), **kw))

    def test_head_dim_80(self):
        """stablelm-3b's head dim, not a power of two."""
        q, k, v = _qkv(8, 2, 2, 100, 100, 80)
        want = j_flash_op(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
        _close(ops.flash_attention_op(_t(q), _t(k), _t(v), causal=True),
               want)

    def test_cross_lengths(self):
        """Sq != Sk: rows and columns count from 0 in both, as the
        reference's vis rule counts them."""
        q, k, v = _qkv(9, 2, 2, 40, 100, 16)
        for kw in (dict(causal=True), dict(window=24)):
            want = j_flash_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw)
            _close(ops.flash_attention_op(_t(q), _t(k), _t(v), **kw), want)

    def test_bf16_cast_back(self):
        """bf16 inputs are computed in fp32 and the result cast to q's
        type: bf16 out, within one bf16 rounding of the JAX oracle."""
        q, k, v = _qkv(10, 2, 2, 48, 48, 16)
        qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
        got = ops.flash_attention_op(qb, kb, vb, causal=True)
        assert got.dtype == torch.bfloat16
        want = j_flash_ref(*(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16) for x in (qb, kb, vb)), causal=True)
        _close(got.float(), np.asarray(want.astype(jnp.float32)), tol=1e-2)


class TestWrapper:
    def test_leading_batch_dims(self):
        q, k, v = _qkv(11, 4, 2, 48, 48, 16, lead=(3,))
        got = ops.flash_attention_op(_t(q), _t(k), _t(v), causal=True)
        for b in range(3):
            want = ops.flash_attention_op(_t(q[b]), _t(k[b]), _t(v[b]),
                                          causal=True)
            torch.testing.assert_close(got[b], want, rtol=0, atol=0)

    def test_plain_path_launches_nothing(self):
        q, k, v = _qkv(12, 2, 2, 16, 16, 8)
        before = ops.flash_attention_op.launches
        ops.flash_attention_op(_t(q), _t(k), _t(v))
        assert ops.flash_attention_op.launches == before

    def test_ptxas_report_names_each_kernel(self, tmp_path, monkeypatch):
        """chip_smoke.py prints each kernel's registers and spills from
        the build's ``-Xptxas -v`` log, the anonymous namespace dropped."""
        from repro_torch.kernels import build
        entry = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea7"
                 "4sm9020flash_attention_sm90ILi128EEEv14CUtensorMap_st")
        (tmp_path / "fa.log").write_text(
            f"ptxas info    : Compiling entry function '{entry}' for "
            f"'sm_90a'\n    24 bytes stack frame, 32 bytes spill stores, 32 "
            f"bytes spill loads\nptxas info    : Used 168 registers, used 1 "
            f"barriers\n")
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        assert build.ptxas_report("fa") == (
            "sm90::flash_attention_sm90<128>: Used 168 registers, used 1 "
            "barriers; 24 bytes stack frame, 32 bytes spill stores, 32 "
            "bytes spill loads")

    @pytest.mark.parametrize("shape_k,kw,match", [
        ((3, 16, 8), {}, "multiple"),
        ((2, 16, 8), {"window": 0}, "no visible key"),
        ((2, 8, 8), {"window": 8}, "no visible key"),
        ((2, 16, 4), {}, "head dim"),
    ])
    def test_rejects(self, shape_k, kw, match):
        """A KV head count that does not divide H, and a window that
        leaves a query row with no key, raise on every device."""
        q = torch.zeros(4, 16, 8)
        k = torch.zeros(shape_k)
        with pytest.raises(ValueError, match=match):
            ops.flash_attention_op(q, k, k.clone(), **kw)


# The bf16 route of the CUDA kernel (csrc/flash_attention.cu, sm90):
# 128-key tiles, each 64-row warpgroup visiting the tiles its rows can
# see, S from bf16 q and k in fp32, an online softmax on the fp32 p, P·V
# as P_hi·V + P_lo·V (two bf16 terms of p, fp32 sums), one bf16 rounding
# of the output.  The gate is chip_smoke.py's: one output rounding.
BK_SM90, ROWS_SM90 = 128, 64


def _gate(got, want):
    """|got - want| <= 2^-7 |want| + 1e-5, chip_smoke.py's bf16 gate;
    returns the max abs error."""
    got, want = (torch.from_numpy(np.array(x, dtype=np.float32))
                 for x in (got, want))
    diff = (got - want).abs()
    assert bool((diff <= 2.0 ** -7 * want.abs() + 1e-5).all()), \
        f"max abs err {diff.max().item():.3e} past the gate"
    return diff.max().item()


def _emulate_sm90(q, k, v, *, causal, window, split=True):
    """q (H, Sq, d), k and v (KV, Sk, d), bf16 values in fp32 tensors ->
    (H, Sq, d) bf16, as the sm90 kernel computes it; ``split=False``
    rounds p to one bf16 term instead (what a single bf16 P·V gives)."""
    H, sq, d = q.shape
    sk = k.shape[1]
    k = k.repeat_interleave(H // k.shape[0], dim=0)
    v = v.repeat_interleave(H // v.shape[0], dim=0)
    scale = 1.0 / math.sqrt(d)
    neg = torch.tensor(-1e30)
    out = torch.empty(H, sq, d)
    for r0 in range(0, sq, ROWS_SM90):
        rows = torch.arange(r0, min(r0 + ROWS_SM90, sq))
        hi = min(sk, r0 + ROWS_SM90) if causal else sk
        lo = max(0, r0 - window + 1) if window else 0
        m = torch.full((H, len(rows)), -math.inf)
        l = torch.zeros(H, len(rows))
        acc = torch.zeros(H, len(rows), d)
        for k0 in range(lo // BK_SM90 * BK_SM90, hi, BK_SM90):
            cols = torch.arange(k0, min(k0 + BK_SM90, sk))
            s = q[:, rows] @ k[:, cols].transpose(1, 2) * scale
            vis = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                vis &= cols[None, :] <= rows[:, None]
            if window:
                vis &= cols[None, :] > rows[:, None] - window
            s = torch.where(vis, s, neg)
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l = l * alpha + p.sum(-1)
            p_hi = p.bfloat16().float()
            if split:
                p_lo = (p - p_hi).bfloat16().float()
                pv = p_hi @ v[:, cols] + p_lo @ v[:, cols]
            else:
                pv = p_hi @ v[:, cols]
            acc = acc * alpha[..., None] + pv
            m = mn
        out[:, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.bfloat16()


SM90_CASES = [
    # (H, KV, S, d, causal, window): GQA 1, 3 and 5; S 200 and 257 are no
    # multiple of the 128-key tile or the 64-row warpgroup
    *[(kv * r, kv, 200, 32, c, w) for (r, kv), c, w in itertools.product(
        [(1, 2), (3, 1), (5, 1)], [False, True], [None, 40])],
    (6, 2, 257, 80, True, None),
    (6, 2, 257, 80, False, 100),
]


class TestSm90Arithmetic:
    @pytest.mark.parametrize("H,KV,S,d,causal,window", SM90_CASES)
    def test_split_p_within_one_output_rounding(self, H, KV, S, d, causal,
                                                window):
        """The sm90 kernel's arithmetic, emulated in torch fp32, against
        the JAX op (Pallas in interpret mode) and the plain version on
        the same bf16 inputs, under chip_smoke.py's gate.  The error of a
        single bf16 p is printed beside it (information, not a gate)."""
        q, k, v = (_t(x).bfloat16().float()
                   for x in _qkv(S * H + d, H, KV, S, S, d))
        kw = dict(causal=causal, window=window)
        got = _emulate_sm90(q, k, v, **kw).float()
        want_op = j_flash_op(*(jnp.asarray(x.numpy()).astype(jnp.bfloat16)
                               for x in (q, k, v)), **kw)
        want_op = np.asarray(want_op.astype(jnp.float32))
        want_plain = ops.flash_attention_op(q.bfloat16(), k.bfloat16(),
                                            v.bfloat16(), **kw).float()
        err_op = _gate(got, want_op)
        err_plain = _gate(got, want_plain)
        one = _emulate_sm90(q, k, v, split=False, **kw).float()
        err_one = (one - want_plain).abs().max().item()
        print(f"H{H} KV{KV} S{S} d{d} {kw}: split p vs Pallas "
              f"{err_op:.3e}, vs plain {err_plain:.3e}; one bf16 p vs "
              f"plain {err_one:.3e}")

    def test_split_residual_is_below_two_to_the_minus_17(self):
        """p - p_hi - p_lo over p in (0, 1]: at most ~2^-17 relative, the
        bound the kernel's note states."""
        p = torch.from_numpy(np.random.default_rng(13).random(
            100_000).astype(np.float32)).clamp_min(1e-30)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        assert ((p - hi - lo).abs() <= 2.0 ** -17 * p).all()
        assert ((p - hi).abs() > 2.0 ** -12 * p).any()


# The fp32 route of the CUDA kernel (csrc/flash_attention.cu, sm90_f32):
# 32-key tiles at d <= 32 (64 above), each 64-row warpgroup visiting the
# tiles its rows can see; q times scale · log2(e) (one fp32 rounding),
# then q, k, v and p split into three bf16 terms; hi·hi into one fp32
# accumulator and hi·mid, mid·hi, hi·lo, mid·mid, lo·hi into a second,
# for S and for O alike; an online softmax in base 2; o = (o1 + o2) /
# max(l, 1e-30).
ROWS_F32 = 64
LOG2E = np.float32(1.4426950408889634)


def _split3(x):
    """x (fp32) -> hi, mid, lo: bf16 values in fp32 tensors."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    lo = (x - hi - mid).bfloat16().float()
    return hi, mid, lo


def _split_mm(a, b):
    """a @ b as the route's six bf16 products: (hi·hi, the other five)."""
    ah, am, al = _split3(a)
    bh, bm, bl = _split3(b)
    return ah @ bh, am @ bh + ah @ bm + al @ bh + am @ bm + ah @ bl


def _split_mm_three(a, b):
    """a @ b as three bf16 products, hi·hi, hi·mid and mid·hi: a route
    that SPLIT_TOL must refuse."""
    ah, am, _ = _split3(a)
    bh, bm, _ = _split3(b)
    return ah @ bh, am @ bh + ah @ bm


def _emulate_f32(q, k, v, *, causal, window, split_mm=_split_mm):
    """q (H, Sq, d), k and v (KV, Sk, d) fp32 -> (H, Sq, d) fp32, as the
    sm90_f32 kernel computes it."""
    H, sq, d = q.shape
    sk = k.shape[1]
    bk = 32 if d <= 32 else 64
    k = k.repeat_interleave(H // k.shape[0], dim=0)
    v = v.repeat_interleave(H // v.shape[0], dim=0)
    q = q * torch.tensor(np.float32(1.0 / math.sqrt(d)) * LOG2E)
    neg = torch.tensor(-1e30)
    out = torch.empty(H, sq, d)
    for r0 in range(0, sq, ROWS_F32):
        rows = torch.arange(r0, min(r0 + ROWS_F32, sq))
        hi = min(sk, r0 + ROWS_F32) if causal else sk
        lo = max(0, r0 - window + 1) if window else 0
        m = torch.full((H, len(rows)), -math.inf)
        l = torch.zeros(H, len(rows))
        o1 = torch.zeros(H, len(rows), d)
        o2 = torch.zeros(H, len(rows), d)
        for k0 in range(lo // bk * bk, hi, bk):
            cols = torch.arange(k0, min(k0 + bk, sk))
            s1, s2 = split_mm(q[:, rows], k[:, cols].transpose(1, 2))
            x = s1 + s2
            vis = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                vis &= cols[None, :] <= rows[:, None]
            if window:
                vis &= cols[None, :] > rows[:, None] - window
            x = torch.where(vis, x, neg)
            mn = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - mn)
            p = torch.exp2(x - mn[..., None])
            l = l * alpha + p.sum(-1)
            d1, d2 = split_mm(p, v[:, cols])
            o1 = o1 * alpha[..., None] + d1
            o2 = o2 * alpha[..., None] + d2
            m = mn
        out[:, rows] = (o1 + o2) / l.clamp_min(1e-30)[..., None]
    return out


F32_CASES = [
    # (H, KV, S, d, causal, window): S 100 is no multiple of the 64-key
    # tile or the 64-row warpgroup
    (2, 2, 100, 32, False, None),     # BERT4Rec's head dim
    (2, 2, 100, 8, True, None),
    (2, 2, 100, 80, True, None),
    (2, 2, 100, 16, False, 24),
    (4, 2, 100, 32, True, 40),        # GQA 4 / 2
]


class TestFp32SplitArithmetic:
    @pytest.mark.parametrize("H,KV,S,d,causal,window", F32_CASES)
    def test_split_route_matches_jax(self, H, KV, S, d, causal, window):
        """The fp32 route's arithmetic, emulated in torch fp32, against
        the JAX op (Pallas in interpret mode) and the JAX oracle at 2e-4
        on the same numpy-seeded fp32 inputs; its error against the plain
        fp32 version (expected near 1e-6) is printed."""
        q, k, v = _qkv(S * H + d + 1, H, KV, S, S, d)
        kw = dict(causal=causal, window=window)
        got = _emulate_f32(_t(q), _t(k), _t(v), **kw)
        _close(got, j_flash_op(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), **kw))
        rep = H // KV
        _close(got, j_flash_ref(jnp.asarray(q), jnp.repeat(k, rep, 0),
                                jnp.repeat(v, rep, 0), **kw))
        plain = ops.flash_attention_op(_t(q), _t(k), _t(v), **kw)
        err = (got - plain).abs().max().item()
        print(f"H{H} KV{KV} S{S} d{d} {kw}: emulated split route vs plain "
              f"fp32 {err:.3e}")
        assert err <= SPLIT_TOL

    @pytest.mark.parametrize("H,KV,S,d,causal,window", F32_CASES)
    def test_fewer_products_miss_the_split_gate(self, H, KV, S, d, causal,
                                                window):
        """The same route with three products, hi·hi, hi·mid and mid·hi,
        in place of six: within 2e-4 of plain but past SPLIT_TOL, so the
        card's SPLIT_TOL gate shows that the six products run."""
        q, k, v = _qkv(S * H + d + 1, H, KV, S, S, d)
        kw = dict(causal=causal, window=window)
        got = _emulate_f32(_t(q), _t(k), _t(v), split_mm=_split_mm_three,
                           **kw)
        err = (got - ops.flash_attention_op(_t(q), _t(k), _t(v), **kw)
               ).abs().max().item()
        print(f"H{H} KV{KV} S{S} d{d} {kw}: three products vs plain fp32 "
              f"{err:.3e}")
        assert SPLIT_TOL < err <= TOL

    def test_split3_is_exact_above_two_to_the_minus_100(self):
        """hi + mid + lo == p for p in (2^-100, 1]: the route's p (and any
        normal q, k, v value that far above the subnormals) loses nothing
        to its split."""
        rng = np.random.default_rng(14)
        p = (rng.random(200_000) * 2.0 ** -rng.uniform(0, 100, 200_000))
        p = torch.from_numpy(np.concatenate([p, [1.0, 2.0 ** -100]])
                             .astype(np.float32))
        p = p[p >= 2.0 ** -100]
        hi, mid, lo = _split3(p)
        assert torch.equal(hi.double() + mid.double() + lo.double(),
                           p.double())
        assert (mid != 0).any() and (lo != 0).any()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs them on the card")
    return torch.device("cuda")


CARD_CASES = [
    # (H, KV, Sq, Sk, d, causal, window)
    (8, 2, 300, 300, 128, True, None),
    (4, 4, 300, 300, 80, True, None),
    (4, 4, 300, 300, 80, False, None),
    (6, 3, 257, 257, 128, True, 100),
    (6, 3, 257, 257, 64, False, 70),
    (10, 2, 200, 200, 128, True, None),
    (4, 2, 200, 200, 72, True, None),
    (4, 2, 100, 333, 128, False, None),
    (4, 2, 333, 100, 64, True, None),
    (4, 2, 1, 1, 128, True, None),
    (4, 2, 1, 50, 16, False, None),
    # the fp32 route's head dims 32 (BERT4Rec's S 200), 8 and 24
    (2, 2, 200, 200, 32, False, None),
    (2, 2, 100, 100, 8, True, None),
    (4, 2, 150, 150, 24, False, 30),
]


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("H,KV,Sq,Sk,d,causal,window", CARD_CASES)
    def test_kernel_matches_plain(self, H, KV, Sq, Sk, d, causal, window,
                                  dtype):
        """S 300, 257, 200 and 333 are no multiple of either route's
        tiles; d 72 and 80 no multiple of the 16-deep wgmma.  fp32 (the
        sm90_f32 kernel: split-bf16 wgmma, d padded to 32, 64 or 128):
        within 2e-4 of the plain version, and within SPLIT_TOL, which a
        route with fewer split products misses.  bf16 (the
        sm90 kernel): within one output rounding, 2^-7 |plain| + 1e-5,
        chip_smoke.py's gate (the kernel and the plain version round the
        same fp32 function once)."""
        dev = _cuda()
        q, k, v = _qkv(Sq * Sk + d, H, KV, Sq, Sk, d, lead=(2,))
        q, k, v = (_t(x).to(dev, dtype) for x in (q, k, v))
        before = ops.flash_attention_op.launches
        got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.flash_attention_op.launches == before + 1
        want = flash_attention_ref(q, k.repeat_interleave(H // KV, dim=-3),
                                   v.repeat_interleave(H // KV, dim=-3),
                                   causal=causal, window=window)
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
            err = (got - want).abs().max().item()
            assert err <= SPLIT_TOL, f"max abs err {err:.3e}"
        else:
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-5)
                        .all()), f"max abs err {diff.max().item():.3e}"

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        for d in (100, 136):
            q = torch.zeros(2, 16, d, device=dev)
            with pytest.raises(ValueError, match="head dim"):
                ops.flash_attention_op(q, q, q)
        for dtype in (torch.float64, torch.float16):
            q = torch.zeros(2, 16, 16, device=dev, dtype=dtype)
            with pytest.raises(ValueError, match="dtype"):
                ops.flash_attention_op(q, q, q)
