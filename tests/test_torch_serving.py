"""Packed index and exact MaxSim serving of the PyTorch port against the
JAX reference: same numpy corpus, queries and keep masks into both;
storage accounting equal, top-k ids exactly equal, scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import index as j_index
from repro.serve import retrieval as j_ret
from repro_torch.serve import retrieval
from repro_torch.serve.index import PackedIndex

ATOL = 1e-5


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _case(seed=0, n_docs=40, m=20, dim=16, n_q=5, l=6):
    rng = np.random.default_rng(seed)
    e = _unit(rng, n_docs, m, dim)
    lens = rng.integers(3, m + 1, size=n_docs)
    mask = np.arange(m)[None, :] < lens[:, None]
    keep = rng.random((n_docs, m)) < 0.5
    keep[3] = False                    # a doc emptied by pruning
    q = _unit(rng, n_q, l, dim)
    return e, mask, keep, q


def _both(seed=0, **kw):
    e, mask, keep, q = _case(seed, **kw)
    jp = j_index.PackedIndex.pack(jnp.asarray(e), jnp.asarray(mask),
                                  jnp.asarray(keep))
    tp = PackedIndex.pack(torch.tensor(e), torch.tensor(mask),
                          torch.tensor(keep))
    return jp, tp, jnp.asarray(q), torch.tensor(q)


def _assert_topk(got, want):
    gi, gs = (np.asarray(x) for x in got[:2])
    wi, ws = (np.asarray(x) for x in want[:2])
    np.testing.assert_array_equal(gi, wi)
    real = ws > -1e29
    np.testing.assert_allclose(gs[real], ws[real], atol=ATOL)
    np.testing.assert_allclose(gs[~real], ws[~real], rtol=1e-6)


class TestPackedIndex:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_storage_matches_jax(self, seed):
        jp, tp, _, _ = _both(seed)
        assert tp.storage() == jp.storage()

    def test_buckets_match_jax(self):
        jp, tp, _, _ = _both(2)
        assert [b.cap for b in tp.buckets] == [b.cap for b in jp.buckets]
        for tb, jb in zip(tp.buckets, jp.buckets):
            np.testing.assert_array_equal(tb.doc_ids.numpy(),
                                          np.asarray(jb.doc_ids))
            np.testing.assert_array_equal(tb.masks.numpy(),
                                          np.asarray(jb.masks))
            np.testing.assert_array_equal(tb.embs.numpy(),
                                          np.asarray(jb.embs))

    def test_views_match_jax(self):
        jp, tp, _, _ = _both(3)
        te, tm = tp.padded()
        je, jm = jp.padded()
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(tp.pooled().numpy(),
                                   np.asarray(jp.pooled()), atol=1e-6)

    def test_unknown_compression_rejected(self):
        e, mask, keep, _ = _case()
        with pytest.raises(ValueError, match="one of"):
            PackedIndex.pack(torch.tensor(e), torch.tensor(mask),
                             compression="zstd")


class TestScoring:
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_maxsim_scores_packed_and_dense(self, backend):
        e, mask, keep, q = _case(4)
        jt = j_ret.TokenIndex.build(jnp.asarray(e), jnp.asarray(mask)
                                    ).with_keep(jnp.asarray(keep))
        want = np.asarray(j_ret.maxsim_scores(jt, jnp.asarray(q),
                                              backend="reference"))
        tt = retrieval.TokenIndex.build(torch.tensor(e), torch.tensor(mask)
                                        ).with_keep(torch.tensor(keep))
        real = want > -1e29
        for idx in (tt, tt.pack()):
            got = retrieval.maxsim_scores(idx, torch.tensor(q),
                                          backend=backend).numpy()
            np.testing.assert_allclose(got[real], want[real], atol=ATOL)
            np.testing.assert_allclose(got[~real], want[~real], rtol=1e-6)

    def test_merge_ties_to_lowest_id(self):
        scores = torch.tensor([[1.0, 2.0, 2.0, -torch.inf, 2.0, 0.5]])
        ids = torch.tensor([[7, 9, 4, -1, 6, 1]], dtype=torch.int32)
        i, s = retrieval._merge_topk(scores, ids, 4)
        assert i.tolist() == [[4, 6, 9, 7]]
        assert s.tolist() == [[2.0, 2.0, 2.0, 1.0]]

    def test_stream_pad_audits_force_pads_below_empty_docs(self):
        """Pad ids (-1 and >= pad_from) score -inf, strictly below a real
        empty-after-prune doc's finite l x -1e30 sentinel."""
        scores = torch.tensor([[-3e30, 0.5, -3e30, -3e30, 0.2]])
        ids = torch.tensor([-1, 4, 9, 2, 7], dtype=torch.int32)
        v, i = retrieval._stream_chunk_topk(
            5, 2, 2, lambda a, b: scores[:, a:b], doc_ids=ids, pad_from=8)
        top_i, top_v = retrieval._merge_topk(v, i, 4)
        assert top_i.tolist() == [[4, 7, 2, -1]]
        assert torch.isfinite(top_v[0, 2]) and top_v[0, 3] == -torch.inf


class TestSearch:
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    @pytest.mark.parametrize("chunk_docs", [None, 7])
    def test_topk_search_matches_jax(self, backend, chunk_docs):
        jp, tp, jq, tq = _both(5)
        want = j_ret.topk_search(jp, jq, k=8, backend="reference")
        got = retrieval.topk_search(tp, tq, k=8, backend=backend,
                                    chunk_docs=chunk_docs)
        _assert_topk(got, want)

    def test_k_above_corpus_clamps_like_jax(self):
        jp, tp, jq, tq = _both(6, n_docs=6)
        want = j_ret.topk_search(jp, jq, k=10, backend="reference")
        got = retrieval.topk_search(tp, tq, k=10)
        assert got[0].shape == (5, 6)
        _assert_topk(got, want)

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    @pytest.mark.parametrize("return_full", [True, False])
    @pytest.mark.parametrize("n_first", [12, 64])
    def test_search_matches_jax(self, backend, return_full, n_first):
        jp, tp, jq, tq = _both(7)
        want = j_ret.search(jp, jq, k=5, n_first=n_first,
                            backend="reference", return_full=return_full)
        got = retrieval.search(tp, tq, k=5, n_first=n_first,
                               backend=backend, return_full=return_full)
        _assert_topk(got, want)
        if return_full:
            w, g = np.asarray(want[2]), got[2].numpy()
            real = w > -1e29
            np.testing.assert_allclose(g[real], w[real], atol=ATOL)

    @pytest.mark.parametrize("n_first", [12, 0])
    def test_server_query_batch_matches_jax(self, n_first):
        jp, tp, jq, tq = _both(8)
        n_first = n_first or tp.n_docs
        want = j_ret.RetrievalServer(jp, k=6, n_first=n_first,
                                     backend="reference").query_batch(jq)
        server = retrieval.RetrievalServer(tp, k=6, n_first=n_first,
                                           backend="fused")
        got = server.query_batch(tq)
        _assert_topk(got, want)
        assert got.coverage == 1.0 and got.epoch_key == (0, 0, 0)

    def test_server_swap_bumps_epoch_and_drops_closures(self):
        _, tp, _, tq = _both(9)
        server = retrieval.RetrievalServer(tp, k=4, n_first=tp.n_docs)
        first = server.query_batch(tq)
        assert len(server._search) == 1
        server.swap_index(tp)
        assert len(server._search) == 0
        again = server.query_batch(tq)
        assert again.epoch_key == (1, 1, 0)
        np.testing.assert_array_equal(again.top_idx, first.top_idx)
