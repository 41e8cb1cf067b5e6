"""Voronoi table pruning (``repro_torch.core.table_pruning``) against the
reference's ``repro.core.table_pruning``, the chunked top-2 over a
table's rows (``maxsim_top2_rows_op`` / ``maxsim_top2_rows_ref``) and
its merge, and the batch invariance of Alg. 1's pruning orders.

Inputs are drawn by numpy and fed to both packages; the reference's
samples reach ``prune_table`` through its ``sample_sphere`` seam.
Tolerances: errors within 1e-6 relative plus 1e-7 absolute of the
reference's (both sum Eq. 8 in fp32, in sample order, over products
taken in other orders); everything else is held bit for bit.
"""

import os

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import table_pruning as j_tp
    from repro.core import voronoi as j_vor
    from repro.core.sampling import sample_sphere as j_sample_sphere
except ImportError:     # a GPU host without JAX: the cuda test still runs
    jax = None
from repro_torch.core import table_pruning as tp
from repro_torch.core import voronoi
from repro_torch.core.scoring import NEG_INF, top2_from_scores
from repro_torch.core.segment import segment_rows_sum
from repro_torch.kernels.maxsim_top2 import ops as t2
from repro_torch.kernels.maxsim_top2.ref import (maxsim_top2_rows_ref,
                                                 merge_chunk_top2)

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

V, D, N = 3000, 16, 512
RTOL, ATOL = 1e-6, 1e-7


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(seed=0, v=V, d=D, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(v, d)).astype(np.float32) * 0.5,
            _unit(rng, n, d))


def _exact_case(seed, v, n=64, d=8, dup=()):
    """Small-integer rows and samples of 0 / ±1/2 / ±1/4 entries: every
    score is exact in fp32 whatever the summation order, so ties are
    real.  ``dup`` (src, dst) pairs copy row src onto row dst."""
    rng = np.random.default_rng(seed)
    table = rng.integers(-3, 4, (v, d)).astype(np.float32)
    for src, dst in dup:
        table[dst] = table[src]
    samples = rng.choice(np.float32([0, 0.5, -0.5, 0.25, -0.25]), (n, d))
    return table, samples.astype(np.float32)


def _whole_row_top2(table, samples):
    """The reference's definition over the whole (N, V) matrix."""
    scores = torch.from_numpy(samples) @ torch.from_numpy(table).T
    return top2_from_scores(scores, torch.ones(table.shape[0], dtype=bool))


class TestRowErrors:
    @needs_jax
    def test_errors_and_cells_match_jax(self):
        table, samples = _case()
        want = np.asarray(j_tp.table_row_errors(jnp.asarray(table),
                                                jnp.asarray(samples)))
        got = tp.table_row_errors(torch.from_numpy(table),
                                  torch.from_numpy(samples))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        state = j_vor.assign_cells(jnp.asarray(table), jnp.ones((V,), bool),
                                   jnp.asarray(samples))
        bi = maxsim_top2_rows_ref(torch.from_numpy(samples),
                                  torch.from_numpy(table))[2]
        np.testing.assert_array_equal(bi.numpy(), np.asarray(state.bi))
        assert ((got > 0).sum() <= N) and ((want > 0).sum() <= N)

    @pytest.mark.parametrize("chunk", [1, 7, 1024, 3000])
    def test_errors_bit_equal_for_any_chunk(self, chunk):
        table, samples = (torch.from_numpy(x) for x in _case(1))
        base = tp.table_row_errors(table, samples)
        got = tp.table_row_errors(table, samples, chunk=chunk)
        assert torch.equal(got, base)
        # the kernel wrapper's CPU route is the same plain version
        for a, b in zip(t2.maxsim_top2_rows_op(samples, table, chunk),
                        maxsim_top2_rows_ref(samples, table, 4096)):
            assert torch.equal(a, b)

    def test_cell_sums_in_sample_order(self):
        rng = np.random.default_rng(2)
        gap = rng.random(700).astype(np.float32)
        bi = rng.integers(0, 40, 700)
        bi[::7] = 3                               # one long run
        want = np.zeros(50, np.float32)
        np.add.at(want, bi, gap)                  # sequential, in order
        # table_row_errors sums Eq. 8 by core.segment.segment_rows_sum
        got = segment_rows_sum(torch.from_numpy(gap),
                               torch.from_numpy(bi).int(), 50)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(segment_rows_sum(torch.zeros(0), torch.zeros(
            0, dtype=torch.int32), 4), torch.zeros(4))


class TestTiesAndEdges:
    @pytest.mark.parametrize("v,chunk,dup", [
        (200, 16, ((3, 40), (3, 41), (100, 17))),  # ties across chunks
        (200, 16, ((5, 6), (6, 150))),             # ties inside a chunk
        (65, 16, ((0, 64),)),                      # a last chunk of 1 row
        (33, 32, ()),                              # the same, pad 31 rows
        (2, 4096, ((0, 1),)),                      # 2 equal rows, padded
        (2, 1, ()),
        (1, 4096, ()),                             # 1 row: NEG_INF, 0
        (1, 1, ()),
    ])
    def test_chunked_top2_equals_whole_row(self, v, chunk, dup):
        table, samples = _exact_case(v + chunk, v, dup=dup)
        want = _whole_row_top2(table, samples)
        for c in (chunk, 1, 3, v):
            got = t2.maxsim_top2_rows_op(torch.from_numpy(samples),
                                         torch.from_numpy(table), c)
            for a, b in zip(got, want):
                assert torch.equal(a, b), c
        if v == 1:
            assert (got[1] == NEG_INF).all() and (got[3] == 0).all()
        else:
            assert (got[1] > NEG_INF).all() and (got[3] < v).all()
            assert (got[2] != got[3]).all()

    def test_merge_tie_rules(self):
        """Crafted (C, N) parts: the winner's second ties another
        part's best (lower global row wins); a one-row part's NEG_INF
        second loses to any other best; equal bests across parts."""
        f = lambda *x: torch.tensor(x, dtype=torch.float32)[:, None]
        i = lambda *x: torch.tensor(x, dtype=torch.int32)[:, None]
        starts = torch.tensor([0, 4, 8])
        for best, second, bi, si, want in [
            (f(5, 3, 4), f(4, 1, 0), i(2, 0, 1), i(3, 1, 0),
             (5, 4, 2, 3)),                    # part 0 second at row 3 < 9
            (f(3, 5, 4), f(1, 4, 0), i(0, 2, 1), i(1, 0, 0),
             (5, 4, 6, 4)),                    # row 4 (part 1) < row 9
            (f(2, 5, 1), f(NEG_INF, NEG_INF, 0), i(0, 0, 1), i(0, 0, 0),
             (5, 2, 4, 0)),
            (f(5, 5, 5), f(1, 1, 1), i(3, 1, 0), i(0, 0, 1),
             (5, 5, 3, 5)),
        ]:
            got = merge_chunk_top2(best, second, bi, si, starts)
            assert [x.item() for x in got] == list(want)

    def test_zero_error_rows_keep_by_index(self):
        """Rows without a sample (error 0) are kept lowest index first,
        after every row of nonzero error."""
        table = torch.from_numpy(_case(4)[0])
        keep = tp.prune_table(torch.Generator().manual_seed(0), table, 0.5,
                              n_samples=N)
        s = tp.sample_sphere(torch.Generator().manual_seed(0), N, D)
        nz = tp.table_row_errors(table, s) > 0
        assert keep[nz].all() and 0 < int(nz.sum()) < V // 2
        zero_kept = torch.nonzero(keep & ~nz).squeeze(1)
        assert torch.equal(zero_kept, torch.nonzero(~nz).squeeze(1)[
            :zero_kept.numel()])


@needs_jax
class TestPruneTable:
    @pytest.mark.parametrize("keep", [0.001, 0.3, 0.9])
    def test_keep_masks_match_jax(self, keep, monkeypatch):
        table, _ = _case(3)
        key = jax.random.PRNGKey(7)

        def sample_sphere(generator, n, dim, device=None):
            return torch.from_numpy(np.asarray(j_sample_sphere(key, n, dim)))

        monkeypatch.setattr(tp, "sample_sphere", sample_sphere)
        want = np.asarray(j_tp.prune_table(key, jnp.asarray(table), keep,
                                           n_samples=N))
        got = tp.prune_table(torch.Generator().manual_seed(0),
                             torch.from_numpy(table), keep, n_samples=N)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.sum() == int(np.ceil(np.float32(keep * V)))

@pytest.mark.cuda
class TestRowsOnCard:
    @pytest.mark.parametrize("v,chunk", [(3000, 1024), (4097, 4096),
                                         (65, 16), (1, 4096)])
    def test_kernel_chunks_match_plain(self, v, chunk):
        """B1 over row chunks against the plain chunked version: argbest
        equal where the top-2 gap exceeds 1e-5, values within 1e-5 (B1's
        rule in ``kernels/score_check.py``); errors bit-equal across
        chunk sizes; one launch a call."""
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                        "mode); chip_smoke.py runs them on the card")
        dev = torch.device("cuda")
        table, samples = (torch.from_numpy(x).to(dev)
                          for x in _case(5, v=v, d=64, n=1000))
        before = t2.maxsim_top2_op.launches
        got = t2.maxsim_top2_rows_op(samples, table, chunk)
        assert t2.maxsim_top2_op.launches == before + 1
        want = maxsim_top2_rows_ref(samples, table, chunk)
        err = max((got[k] - want[k]).abs().max().item() for k in (0, 1))
        gap = want[0] - want[1]
        assert err <= 1e-5
        assert not ((got[2] != want[2]) & (gap > 1e-5)).any()
        e1 = tp.table_row_errors(table, samples, chunk=chunk)
        e2 = tp.table_row_errors(table, samples, chunk=max(1, chunk // 2))
        assert torch.equal(e1, e2)


def _docs(seed, n_docs=9, m=20, dim=8, n_samples=300):
    rng = np.random.default_rng(seed)
    d = (rng.normal(size=(n_docs, m, dim)) * 0.5).astype(np.float32)
    mask = np.arange(m)[None] < rng.integers(1, m + 1, n_docs)[:, None]
    return d, mask, _unit(rng, n_samples, dim)


class TestBatchInvariance:
    @pytest.mark.parametrize("threads", [1, 4, os.cpu_count()])
    @pytest.mark.parametrize("backend", ["reference", "fused", "shortlist",
                                         "shortlist_topk"])
    def test_doc_alone_equals_doc_in_batch(self, backend, threads):
        """Each doc's (ranks, errs, orders) alone are its batch rows bit
        for bit, at this many CPU threads; also in a 3-doc slice."""
        prev = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            d, mask, s = (torch.from_numpy(x) for x in _docs(threads))
            batch = voronoi.pruning_order_batch(d, mask, s, backend=backend)
            for b in range(d.shape[0]):
                alone = voronoi.pruning_order_batch(
                    d[b:b + 1], mask[b:b + 1], s, backend=backend)
                for x, y in zip(alone, batch):
                    assert torch.equal(x[0], y[b]), (b, backend)
            part = voronoi.pruning_order_batch(d[3:6], mask[3:6], s,
                                               backend=backend)
            for x, y in zip(part, batch):
                assert torch.equal(x, y[3:6])
        finally:
            torch.set_num_threads(prev)
