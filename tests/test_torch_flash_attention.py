"""The flash-attention kernel module of the PyTorch port (B7) against the
JAX reference.

On the CPU the wrapper runs its plain PyTorch version; the same numpy
inputs go through the JAX oracle (``flash_attention_ref``) and the JAX op
(Pallas in interpret mode, as the JAX package's own tests run it).
Tolerance 2e-4 abs and rel, the JAX test's: the kernel and the oracle
sum the softmax in different orders.  The ``cuda``-marked tests hold the
CUDA kernel against the plain version on the card; they need no JAX.
"""

import itertools

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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs them on the card")
    return torch.device("cuda")


CARD_CASES = [
    # (H, KV, S, d, causal, window, dtype)
    (8, 2, 300, 128, True, None, torch.float32),
    (8, 2, 300, 128, True, None, torch.bfloat16),
    (4, 4, 300, 80, True, None, torch.float32),
    (4, 4, 300, 80, False, None, torch.bfloat16),
    (6, 3, 257, 128, True, 100, torch.float32),
    (6, 3, 257, 64, False, 70, torch.bfloat16),
]


@pytest.mark.cuda
class TestFlashAttentionOnCard:
    @pytest.mark.parametrize("H,KV,S,d,causal,window,dtype", CARD_CASES)
    def test_kernel_matches_plain(self, H, KV, S, d, causal, window, dtype):
        """S 300 and 257 are no multiple of the 64-row tile.  fp32:
        within 2e-4 of the plain version; bf16 outputs within one
        rounding of the output type (the kernel and the plain version
        round the same fp32 function once)."""
        dev = _cuda()
        q, k, v = (_t(x).to(dev, dtype)
                   for x in _qkv(S + d, H, KV, S, S, d, lead=(2,)))
        before = ops.flash_attention_op.launches
        got = ops.flash_attention_op(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert ops.flash_attention_op.launches == before + 1
        want = flash_attention_ref(q, k.repeat_interleave(H // KV, dim=-3),
                                   v.repeat_interleave(H // KV, dim=-3),
                                   causal=causal, window=window)
        assert got.dtype == dtype
        tol = TOL if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

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
