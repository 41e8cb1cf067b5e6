"""The EmbeddingBag kernel module of the PyTorch port (B8) against the JAX
reference.

On the CPU the wrapper runs its plain PyTorch version; the same numpy
inputs go through the JAX oracle (``embedding_bag_ref``: ``jnp.take``
then a sum) and the JAX op (the Pallas kernel in interpret mode, as the
JAX package's own tests run it).  Tolerance 1e-6 abs against the oracle:
fp32 sums of at most 26 rows with entries in [-1, 1), which XLA adds in
another order.  The plain version adds a bag's rows in the Pallas
kernel's order, so its sums equal the Pallas kernel's bit for bit, and
at nnz 1 it equals the oracle bit for bit.  The ``cuda``-marked tests hold the
CUDA kernel against the plain version on the card; they need no JAX.
"""

import itertools

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.kernels.embedding_bag.ops import (
        embedding_bag_op as j_bag_op)
    from repro.kernels.embedding_bag.ref import (
        embedding_bag_ref as j_bag_ref)
except ImportError:     # a GPU host without JAX: the cuda tests still run
    jnp = None
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

TOL = 1e-6


def _case(seed, V, D, n_bags, nnz):
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1.0, 1.0, (V, D)).astype(np.float32)
    ids = rng.integers(0, V, (n_bags, nnz), dtype=np.int32)
    return table, ids


def _t(x):
    return torch.from_numpy(np.array(x))


SWEEP = list(itertools.product([32, 500], [1, 8, 64], [4, 32], [1, 3, 26],
                               ["sum", "mean"]))


class TestPlainMatchesJax:
    @pytest.mark.parametrize("V,D,n_bags,nnz,mode", SWEEP)
    def test_sweep(self, V, D, n_bags, nnz, mode):
        table, ids = _case(V * D + n_bags * nnz, V, D, n_bags, nnz)
        want_ref = np.asarray(j_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                        mode))
        want_op = np.asarray(j_bag_op(jnp.asarray(table), jnp.asarray(ids),
                                      mode=mode))
        got_ref = embedding_bag_ref(_t(table), _t(ids), mode).numpy()
        got_op = ops.embedding_bag_op(_t(table), _t(ids), mode=mode).numpy()
        np.testing.assert_array_equal(got_op, got_ref)
        assert got_ref.dtype == np.float32 and got_ref.shape == (n_bags, D)
        np.testing.assert_allclose(got_ref, want_ref, atol=TOL, rtol=0)
        np.testing.assert_allclose(got_ref, want_op, atol=TOL, rtol=0)
        if mode == "sum":
            # the Pallas kernel's order: bit for bit.  (Its jit'd mean
            # multiplies by 1/nnz, one rounding away from the oracle's
            # division, which the port keeps.)
            np.testing.assert_array_equal(got_ref, want_op)
        if nnz == 1:
            np.testing.assert_array_equal(got_ref, want_ref)

    def test_repeated_ids(self):
        """tests/test_kernels.py's case: one id three times in a bag."""
        table = np.eye(4, dtype=np.float32)
        ids = np.array([[2, 2, 2]], np.int32)
        got = ops.embedding_bag_op(_t(table), _t(ids)).numpy()
        np.testing.assert_array_equal(got, [[0.0, 0.0, 3.0, 0.0]])
        np.testing.assert_array_equal(
            got, np.asarray(j_bag_op(jnp.asarray(table), jnp.asarray(ids))))

    @pytest.mark.parametrize("mode", ["sum", "mean"])
    def test_ids_out_of_range(self, mode):
        """jnp.take's rule, held against the oracle (the Pallas kernel's
        reads out of range are undefined): -1 and -V wrap, V and -V-1
        give NaN rows, and a NaN row makes its bag NaN."""
        V = 10
        table, _ = _case(3, V, 8, 1, 1)
        ids = np.array([[-1], [-V], [V], [-V - 1], [3]], np.int32)
        ids = np.concatenate([ids, np.array([[1, -1], [2, V], [-V, 4],
                                             [0, 1], [9, -V - 1]],
                                            np.int32)], axis=1)
        want = np.asarray(j_bag_ref(jnp.asarray(table), jnp.asarray(ids),
                                    mode))
        got = ops.embedding_bag_op(_t(table), _t(ids), mode=mode).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[[1, 2, 3, 4]]).all()
        assert not np.isnan(got[[0]]).any()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        one = ops.embedding_bag_op(_t(table), _t(ids[:, :1]), mode=mode)
        np.testing.assert_array_equal(one[0].numpy(), table[V - 1])
        np.testing.assert_array_equal(one[1].numpy(), table[0])

    def test_empty_bags_and_no_ids(self):
        table, ids = _case(4, 16, 8, 3, 0)
        np.testing.assert_array_equal(
            ops.embedding_bag_op(_t(table), _t(ids)).numpy(),
            np.asarray(j_bag_ref(jnp.asarray(table), jnp.asarray(ids))))
        assert ops.embedding_bag_op(_t(table),
                                    _t(ids[:0])).shape == (0, 8)


class TestWrapper:
    def test_plain_path_launches_nothing(self):
        table, ids = _case(5, 16, 8, 4, 3)
        before = ops.embedding_bag_op.launches
        ops.embedding_bag_op(_t(table), _t(ids), mode="mean")
        assert ops.embedding_bag_op.launches == before

    @pytest.mark.parametrize("table,ids,mode,match", [
        (torch.zeros(8, 4), torch.zeros(2, 3, dtype=torch.int64), "sum",
         "int32"),
        (torch.zeros(8, 4), torch.zeros(2, 3, dtype=torch.int32), "max",
         "mode"),
        (torch.zeros(8), torch.zeros(2, 3, dtype=torch.int32), "sum",
         "expected"),
        (torch.zeros(8, 4), torch.zeros(6, dtype=torch.int32), "sum",
         "expected"),
    ])
    def test_rejects(self, table, ids, mode, match):
        """int64 ids, an unknown mode and wrong ranks raise on every
        device."""
        with pytest.raises(ValueError, match=match):
            ops.embedding_bag_op(table, ids, mode=mode)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs them on the card")
    return torch.device("cuda")


CARD_CASES = [
    # (V, D, n_bags, nnz, mode): D 64 (DLRM), 16 (DCN), 32 (W&D deep),
    # 1 (W&D wide), 6 (no 16-byte rows), 200 (more than 32 lanes' units)
    (1000, 64, 3000, 1, "sum"),
    (1000, 64, 513, 26, "mean"),
    (1000, 16, 2049, 26, "sum"),
    (1000, 32, 700, 40, "sum"),
    (5000, 1, 4097, 40, "sum"),
    (100, 6, 300, 3, "mean"),
    (100, 200, 70, 5, "sum"),
]


@pytest.mark.cuda
class TestEmbeddingBagOnCard:
    @pytest.mark.parametrize("V,D,n_bags,nnz,mode", CARD_CASES)
    def test_kernel_matches_plain(self, V, D, n_bags, nnz, mode):
        """Bit for bit: the kernel adds a bag's rows in the plain
        version's order and divides as it does."""
        dev = _cuda()
        table, ids = (_t(x).to(dev) for x in _case(V + D, V, D, n_bags, nnz))
        before = ops.embedding_bag_op.launches
        got = ops.embedding_bag_op(table, ids, mode=mode)
        torch.cuda.synchronize()
        assert ops.embedding_bag_op.launches == before + 1
        torch.testing.assert_close(got, embedding_bag_ref(table, ids, mode),
                                   rtol=0, atol=0)

    def test_unaligned_table(self):
        """A table 4 bytes off 16-byte alignment takes the 4-byte path (a
        16-byte load there would fault)."""
        dev = _cuda()
        table, ids = (_t(x).to(dev) for x in _case(6, 64, 8, 40, 3))
        flat = torch.empty(64 * 8 + 1, device=dev)
        shifted = flat[1:].view(64, 8)
        shifted.copy_(table)
        assert shifted.data_ptr() % 16
        torch.testing.assert_close(ops.embedding_bag_op(shifted, ids),
                                   embedding_bag_ref(table, ids),
                                   rtol=0, atol=0)

    def test_ids_out_of_range(self):
        """jnp.take's rule on the card, with no device-side assert."""
        dev = _cuda()
        V = 10
        table = _t(_case(7, V, 8, 1, 1)[0]).to(dev)
        ids = torch.tensor([[-1, 3], [-V, 2], [V, 1], [-V - 1, 0],
                            [2 ** 31 - 1, 4], [-2 ** 31, 5]],
                           dtype=torch.int32, device=dev)
        got = ops.embedding_bag_op(table, ids)
        torch.cuda.synchronize()
        want = embedding_bag_ref(table, ids)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(got[2:]).all() and not torch.isnan(got[:2]).any()

    def test_table_above_2_31_bytes(self):
        """64-bit row addresses: a (2^23 + 8, 64) fp32 table is 2.1 GB;
        rows past byte 2^31 read back exactly."""
        dev = _cuda()
        V, D = 2 ** 23 + 8, 64
        if torch.cuda.mem_get_info(dev)[0] < 3 * V * D * 4:
            pytest.skip("not enough free device memory for a 2 GB table")
        table = torch.arange(V, device=dev, dtype=torch.float32)[:, None] \
            + torch.arange(D, device=dev, dtype=torch.float32) / 128
        ids = torch.tensor([[V - 1], [V - 8], [2 ** 23], [0], [-1]],
                           dtype=torch.int32, device=dev)
        got = ops.embedding_bag_op(table, ids)
        torch.testing.assert_close(got, table[[V - 1, V - 8, 2 ** 23, 0,
                                               V - 1]], rtol=0, atol=0)

    def test_rejects_what_the_kernel_does_not_take(self):
        dev = _cuda()
        ids = torch.zeros(2, 3, dtype=torch.int32, device=dev)
        for dtype in (torch.float64, torch.bfloat16):
            with pytest.raises(ValueError, match="dtype"):
                ops.embedding_bag_op(torch.zeros(8, 4, dtype=dtype,
                                                 device=dev), ids)
        with pytest.raises(ValueError, match="contiguous"):
            ops.embedding_bag_op(torch.zeros(4, 8, device=dev).T, ids)
        with pytest.raises(ValueError, match="expected cuda"):
            ops.embedding_bag_op(torch.zeros(8, 4, device=dev), ids.cpu())
