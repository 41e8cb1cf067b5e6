"""The index codecs of the PyTorch port (``repro_torch.train.compress``)
against the JAX reference (``repro.train.compress``): the same numpy
inputs give the same bytes, codes and scales, bit for bit.  Both sides
divide by the scale and round half to even, so exact halves are
included on purpose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compress as jc
from repro_torch.train import compress as tc


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.array(want)).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _residuals(bits, seed=0, shape=(6, 5, 16)):
    rng = np.random.default_rng(seed)
    r = (rng.normal(size=shape) * 0.3).astype(np.float32)
    r[0, 0] = 0.0                                  # all-zero row: 1e-12 scale
    qmax = 2 ** (bits - 1) - 1
    # exact halves after the division: max |r| = qmax, so scale = 1
    r[0, 1] = 0.0
    r[0, 1, :4] = [qmax, 0.5, -0.5, 1.5 if qmax > 1 else -0.25]
    return r


class TestBits:
    @pytest.mark.parametrize("bits", [2, 4])
    def test_pack_and_unpack_match_jax(self, bits):
        rng = np.random.default_rng(bits)
        u = rng.integers(0, 2 ** bits, size=(4, 3, 16)).astype(np.uint8)
        packed = tc.pack_bits(torch.from_numpy(u), bits)
        _eq(packed, jc.pack_bits(jnp.asarray(u), bits))
        _eq(tc.unpack_bits(packed, bits),
            jc.unpack_bits(jnp.asarray(packed.numpy()), bits))
        np.testing.assert_array_equal(tc.unpack_bits(packed, bits).numpy(),
                                      u.astype(np.int32))

    def test_bad_widths_rejected(self):
        with pytest.raises(ValueError, match="bits=3"):
            tc.pack_bits(torch.zeros(2, 8, dtype=torch.uint8), 3)
        with pytest.raises(ValueError, match="multiple of 4"):
            tc.pack_bits(torch.zeros(2, 6, dtype=torch.uint8), 2)
        with pytest.raises(ValueError, match="bits=8"):
            tc.quantize_residual(torch.zeros(2, 8), 8)


class TestResidualCodec:
    @pytest.mark.parametrize("bits", [2, 4])
    def test_quantize_matches_jax(self, bits):
        r = _residuals(bits)
        tp, ts = tc.quantize_residual(torch.from_numpy(r), bits)
        jp, js = jc.quantize_residual(jnp.asarray(r), bits)
        _eq(tp, jp)
        _eq(ts, js)
        assert tp.shape == (6, 5, 16 * bits // 8) and ts.shape == (6, 5, 1)

    @pytest.mark.parametrize("bits", [2, 4])
    def test_dequantize_matches_jax(self, bits):
        r = _residuals(bits, seed=1)
        rng = np.random.default_rng(bits + 10)
        codes = rng.integers(0, 7, size=r.shape[:2]).astype(np.int8)
        cb = rng.normal(size=(7, r.shape[-1])).astype(np.float32)
        jp, js = jc.quantize_residual(jnp.asarray(r), bits)
        want = jc.dequantize_residual(jp, js, jnp.asarray(codes),
                                      jnp.asarray(cb), bits)
        got = tc.dequantize_residual(torch.from_numpy(np.array(jp)),
                                     torch.from_numpy(np.array(js)),
                                     torch.from_numpy(codes),
                                     torch.from_numpy(cb), bits)
        _eq(got, want)
        # round trip within scale / 2 of the centroid + residual
        err = np.abs(got.numpy() - (cb[codes.astype(int)] + r))
        assert (err <= np.asarray(js) / 2 + 1e-6).all()


class TestInt8:
    @pytest.mark.parametrize("shape", [(3, 7, 16), (2, 256), (5,)])
    def test_quantize_matches_jax(self, shape):
        rng = np.random.default_rng(len(shape))
        g = rng.normal(size=shape).astype(np.float32)
        g.reshape(-1)[:3] = [127.0, 0.5, -64.5]    # exact halves, scale 1
        tq, ts = tc.quantize_int8(torch.from_numpy(g))
        jq, js = jc.quantize_int8(jnp.asarray(g))
        _eq(tq, jq)
        _eq(ts, js)
        n = g.size
        _eq(tc.dequantize_int8(tq, ts, shape, n),
            jc.dequantize_int8(jq, js, shape, n))

    def test_zero_block_scale_is_clamped(self):
        tq, ts = tc.quantize_int8(torch.zeros(300))
        jq, js = jc.quantize_int8(jnp.zeros(300))
        _eq(ts, js)
        assert float(ts.min()) == pytest.approx(1e-12)
        _eq(tq, jq)

    @pytest.mark.parametrize("dim", [None, -1])
    def test_symmetric_scale_matches_jax(self, dim):
        x = np.random.default_rng(3).normal(size=(4, 9)).astype(np.float32)
        got = tc.symmetric_scale(torch.from_numpy(x), 7.0, dim=dim,
                                 keepdim=dim is not None)
        want = jc.symmetric_scale(jnp.asarray(x), 7.0, axis=dim,
                                  keepdims=dim is not None)
        _eq(got, want)
