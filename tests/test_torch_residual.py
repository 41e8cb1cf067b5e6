"""Compressed packed indexes (int8, residual) and bf16 buckets of the
PyTorch port against the JAX reference, on the same numpy corpora.

* int8: quantized blocks and scales equal, bit for bit.
* residual: the reference's Lloyd's init is injected into the port
  (``jax_init``, from ``test_torch_routing.py``); codebooks then agree
  within 1e-6, and codes and packed residuals are equal on fixtures
  whose nearest-centroid margins exceed 1e-5 (asserted).
* The plain versions of the residual kernels (B5, B6) agree within 1e-5
  with the JAX kernels run in Pallas interpret mode.
* Served top-k: ids equal, scores within 1e-5, on both backends.
* bf16 (a synthetic corpus, and the reference encoder's output at a
  bf16 variant of the smoke config): ``storage()``, the stored bits
  and served ids equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.sampling import sample_sphere as j_sample_sphere
from repro.data import synthetic as j_synth
from repro.kernels.colbert_maxsim.colbert_maxsim import (
    colbert_maxsim_residual_multi as j_res_multi)
from repro.kernels.colbert_maxsim.ops import (
    colbert_maxsim_residual_rerank_op as j_res_rerank)
from repro.launch.serve import serve_retrieval as j_serve_retrieval
from repro.models import colbert as j_colbert
from repro.serve import retrieval as j_ret
from repro.serve.index import PackedIndex as JPackedIndex
from repro.train import compress as jc
from repro_torch.configs import colbert_base
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.launch.serve import serve_retrieval
from repro_torch.serve import retrieval
from repro_torch.serve.index import PackedIndex
from repro_torch.serve.routing import _dist2
from test_torch_models import J_SMOKE, _port
from test_torch_routing import jax_init  # noqa: F401  (fixture)

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
    qm = np.ones((n_q, l), bool)
    qm[2, 4:] = False                  # masked query tokens
    return e, mask, keep, q, qm


def _both(seed=0, bf16=False, **kw):
    e, mask, keep, q, qm = _case(seed)
    je = jnp.asarray(e.astype(ml_dtypes.bfloat16) if bf16 else e)
    te = torch.tensor(e).to(torch.bfloat16 if bf16 else torch.float32)
    jp = JPackedIndex.pack(je, jnp.asarray(mask), jnp.asarray(keep), **kw)
    tp = PackedIndex.pack(te, torch.tensor(mask), torch.tensor(keep), **kw)
    return jp, tp, (jnp.asarray(q), jnp.asarray(qm)), (torch.tensor(q),
                                                        torch.tensor(qm))


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _code_margin(seed, tp) -> float:
    """Smallest gap, over kept tokens, between the squared distances to
    the nearest and the second-nearest valid centroid of the port's
    codebooks (the packed fp32 tokens recomputed from the same
    corpus)."""
    e, mask, keep, _, _ = _case(seed)
    dense = PackedIndex.pack(torch.tensor(e), torch.tensor(mask),
                             torch.tensor(keep))
    gaps = [np.inf]
    for db, b in zip(dense.buckets, tp.buckets):
        valid = b.codebook.abs().sum(-1) > 0
        if int(valid.sum()) < 2:
            continue
        d2 = _dist2(db.embs[db.masks], b.codebook[valid])
        top2 = d2.sort(dim=1).values[:, :2]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    return min(gaps)


def _assert_topk(got, want):
    gi, gs = (np.asarray(x) for x in got[:2])
    wi, ws = (np.asarray(x) for x in want[:2])
    np.testing.assert_array_equal(gi, wi)
    real = ws > -1e29
    np.testing.assert_allclose(gs[real], ws[real], atol=ATOL)
    np.testing.assert_allclose(gs[~real], ws[~real], rtol=1e-6)


class TestPack:
    @pytest.mark.parametrize("compression", ["int8", "residual"])
    def test_storage_matches_jax(self, jax_init, compression):
        jp, tp, _, _ = _both(0, compression=compression)
        assert tp.storage() == jp.storage()
        assert tp.codec_tag() == jp.codec_tag()
        assert tp.n_centroids == jp.n_centroids

    def test_int8_bytes_match_jax(self):
        jp, tp, _, _ = _both(1, compression="int8")
        for tb, jb in zip(tp.buckets, jp.buckets):
            _eq(tb.q8, jb.q8)
            _eq(tb.scales, jb.scales)
            _eq(tb.dense_embs(tp.dim), jb.dense_embs(jp.dim))
            assert tb.embs is None and tb.codes is None

    @pytest.mark.parametrize("bits,n_centroids", [(4, 8), (2, 8), (4, 1),
                                                  (2, 3)])
    def test_residual_codes_match_jax(self, jax_init, bits, n_centroids):
        kw = dict(compression="residual", residual_bits=bits,
                  n_centroids=n_centroids)
        jp, tp, _, _ = _both(2, **kw)
        assert _code_margin(2, tp) > 1e-5
        assert tp.residual_bits == jp.residual_bits == bits
        for tb, jb in zip(tp.buckets, jp.buckets):
            np.testing.assert_allclose(tb.codebook.numpy(),
                                       np.asarray(jb.codebook), atol=1e-6)
            _eq(tb.codes, jb.codes)
            _eq(tb.resq, jb.resq)
            np.testing.assert_allclose(tb.rscale.numpy(),
                                       np.asarray(jb.rscale), rtol=1e-6)
            assert tb.residual_bits(tp.dim) == bits

    def test_residual_views_match_jax(self, jax_init):
        jp, tp, _, _ = _both(3, compression="residual")
        np.testing.assert_allclose(tp.pooled().numpy(),
                                   np.asarray(jp.pooled()), atol=1e-6)
        te, tm = tp.padded()
        je, jm = jp.padded()
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)
        _eq(tm, jm)
        for got, want in zip(tp.padded_residual(), jp.padded_residual()):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)
        v = tp.buckets[0].residual_view(tp.dim)[2:5]
        assert (v.n_docs, v.cap) == (3, tp.buckets[0].cap)

    def test_validation(self):
        e, mask, _, _, _ = _case(4)
        e, mask = torch.tensor(e), torch.tensor(mask)
        with pytest.raises(ValueError, match="compression='zstd'"):
            PackedIndex.pack(e, mask, compression="zstd")
        with pytest.raises(ValueError, match="residual_bits=3"):
            PackedIndex.pack(e, mask, compression="residual",
                             residual_bits=3)
        with pytest.raises(ValueError, match="multiple of 4"):
            PackedIndex.pack(e[..., :6], mask, compression="residual",
                             residual_bits=2)
        for c in (0, 128):
            with pytest.raises(ValueError, match="1..127"):
                PackedIndex.pack(e, mask, compression="residual",
                                 n_centroids=c)


class TestBf16:
    """The full config's encoder emits bf16; the index stores it as it
    is, as the reference does."""

    def test_storage_and_bits_match_jax(self):
        jp, tp, _, _ = _both(5, bf16=True)
        assert tp.storage() == jp.storage()
        for tb, jb in zip(tp.buckets, jp.buckets):
            assert tb.embs.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tb.embs.view(torch.int16).numpy(),
                np.asarray(jb.embs).view(np.int16))
        assert (tp.storage()["bytes_stored"]
                < PackedIndex.pack(*(torch.tensor(x) for x in _case(5)[:3])
                                   ).storage()["bytes_stored"])

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_served_ids_match_jax(self, backend):
        jp, tp, (jq, jqm), (tq, tqm) = _both(5, bf16=True)
        want = j_ret.topk_search(jp, jq, k=8, q_masks=jqm,
                                 backend="reference")
        got = retrieval.topk_search(tp, tq, k=8, q_masks=tqm,
                                    backend=backend)
        _assert_topk(got, want)
        want = j_ret.search(jp, jq, k=5, n_first=12, q_masks=jqm,
                            backend="reference", return_full=False)
        got = retrieval.search(tp, tq, k=5, n_first=12, q_masks=tqm,
                               backend=backend, return_full=False)
        _assert_topk(got, want)

    @pytest.mark.parametrize("n_first", [12, 64])
    def test_bf16_smoke_corpus_matches_jax(self, n_first):
        """The reference's encoder at a bf16 variant of the smoke config
        makes the corpus; both packages pack and serve the same bf16
        embeddings (and the same fp32 queries)."""
        jcfg = dataclasses.replace(J_SMOKE, param_dtype=jnp.bfloat16,
                                   compute_dtype=jnp.bfloat16)
        params = j_colbert.init_params(jax.random.PRNGKey(0), jcfg)
        corpus = j_synth.token_corpus(2, n_docs=64, n_q=6, vocab=jcfg.vocab,
                                      m=jcfg.doc_len, l=jcfg.query_len)
        d_emb, d_mask = j_colbert.encode_docs(params, jcfg,
                                              jnp.asarray(corpus.doc_ids))
        q_emb, _ = j_colbert.encode_queries(params, jcfg,
                                            jnp.asarray(corpus.q_ids))
        assert d_emb.dtype == jnp.bfloat16
        keep = np.random.default_rng(2).random(d_mask.shape) < 0.5
        jp = JPackedIndex.pack(d_emb, d_mask, jnp.asarray(keep))
        tp = PackedIndex.pack(
            torch.from_numpy(np.array(d_emb).view(np.int16)).view(
                torch.bfloat16),
            torch.from_numpy(np.array(d_mask)), torch.from_numpy(keep))
        assert tp.storage() == jp.storage()
        jq = q_emb.astype(jnp.float32)
        tq = torch.from_numpy(np.array(jq))
        want = j_ret.search(jp, jq, k=5, n_first=n_first,
                            backend="reference", return_full=False)
        for backend in ("reference", "fused"):
            got = retrieval.search(tp, tq, k=5, n_first=n_first,
                                   backend=backend, return_full=False)
            _assert_topk(got, want)

    def test_pooled_matches_jax(self):
        """Both packages pool a bf16 bucket in bf16 (sum, then divide);
        on this fixture the pooled vectors are equal bit for bit."""
        jp, tp, _, _ = _both(5, bf16=True)
        _eq(tp.pooled(), jp.pooled())


def _residual_inputs(seed, lead, m, dim, bits, C):
    """Codes, packed residuals, scales and codebook of tokens drawn near
    a random codebook, through the reference's own codec."""
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(C, dim)).astype(np.float32)
    codes = rng.integers(0, C, size=lead + (m,)).astype(np.int8)
    d = cb[codes.astype(int)] + 0.3 * rng.normal(size=lead + (m, dim))
    r = jnp.asarray(d.astype(np.float32)) - jnp.asarray(cb)[codes.astype(int)]
    resq, scale = jc.quantize_residual(r, bits)
    return codes, np.asarray(resq), np.asarray(scale), cb


class TestResidualKernelsPlain:
    """The port's plain B5/B6 against the reference's Pallas kernels in
    interpret mode (the JAX package's own CPU route)."""

    @pytest.mark.parametrize("bits", [2, 4])
    @pytest.mark.parametrize("C", [1, 8, 127])
    def test_multi_matches_jax_kernel(self, bits, C):
        n_q, l, n_docs, m, dim = 3, 6, 11, 9, 16
        codes, resq, scale, cb = _residual_inputs(bits + C, (n_docs,), m,
                                                  dim, bits, C)
        rng = np.random.default_rng(C)
        q = _unit(rng, n_q, l, dim)
        dm = rng.random((n_docs, m)) < 0.7
        dm[4] = False                                  # empty doc
        qm = np.ones((n_q, l), bool)
        qm[1, 3:] = False
        want = np.asarray(j_res_multi(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(resq),
            jnp.asarray(scale), jnp.asarray(cb), jnp.asarray(dm),
            jnp.asarray(qm), bits=bits, interpret=True))
        got = cm.colbert_maxsim_residual_multi_op(
            *(torch.tensor(x) for x in (q, codes, resq, scale, cb, dm, qm)),
            bits=bits).numpy()
        real = want > -1e29
        np.testing.assert_allclose(got[real], want[real], atol=ATOL)
        np.testing.assert_allclose(got[~real], want[~real], rtol=1e-6)
        assert np.isfinite(got).all() and (~real).any()

    @pytest.mark.parametrize("bits", [2, 4])
    def test_rerank_matches_jax_kernel(self, bits):
        """Each candidate decodes against its own bucket's codebook: the
        port passes the table and ``bucket_of``, the reference the
        gathered (n_q, n_cand, C, dim) codebooks."""
        n_q, n_cand, l, m, dim, C, n_b = 3, 7, 5, 8, 16, 6, 4
        codes, resq, scale, _ = _residual_inputs(bits, (n_q, n_cand), m,
                                                 dim, bits, C)
        rng = np.random.default_rng(bits + 1)
        table = rng.normal(size=(n_b, C, dim)).astype(np.float32)
        bucket_of = rng.integers(0, n_b, (n_q, n_cand)).astype(np.int32)
        q = _unit(rng, n_q, l, dim)
        dm = rng.random((n_q, n_cand, m)) < 0.7
        dm[0, 2] = False
        qm = np.ones((n_q, l), bool)
        qm[:, -1] = False
        want = np.asarray(j_res_rerank(
            jnp.asarray(q), jnp.asarray(codes), jnp.asarray(resq),
            jnp.asarray(scale), jnp.asarray(table[bucket_of]),
            jnp.asarray(dm), jnp.asarray(qm), bits=bits))
        got = cm.colbert_maxsim_residual_rerank_op(
            *(torch.tensor(x) for x in (q, codes, resq, scale, table,
                                        bucket_of, dm, qm)),
            bits=bits).numpy()
        real = want > -1e29
        np.testing.assert_allclose(got[real], want[real], atol=ATOL)
        np.testing.assert_allclose(got[~real], want[~real], rtol=1e-6)


class TestCompressedServing:
    @pytest.mark.parametrize("compression", ["int8", "residual"])
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_topk_search_matches_jax(self, jax_init, compression, backend):
        jp, tp, (jq, jqm), (tq, tqm) = _both(6, compression=compression)
        want = j_ret.topk_search(jp, jq, k=8, q_masks=jqm,
                                 backend="reference")
        got = retrieval.topk_search(tp, tq, k=8, q_masks=tqm,
                                    backend=backend, chunk_docs=7)
        _assert_topk(got, want)

    @pytest.mark.parametrize("compression", ["int8", "residual"])
    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_two_stage_matches_jax(self, jax_init, compression, backend):
        jp, tp, (jq, jqm), (tq, tqm) = _both(7, compression=compression,
                                             residual_bits=2)
        want = j_ret.search(jp, jq, k=5, n_first=12, q_masks=jqm,
                            backend="reference", return_full=False)
        got = retrieval.search(tp, tq, k=5, n_first=12, q_masks=tqm,
                               backend=backend, return_full=False)
        _assert_topk(got, want)

    def test_server_matches_jax(self, jax_init):
        jp, tp, (jq, _), (tq, _) = _both(8, compression="residual")
        for n_first in (12, tp.n_docs):
            want = j_ret.RetrievalServer(jp, k=6, n_first=n_first,
                                         backend="reference"
                                         ).query_batch(jq)
            got = retrieval.RetrievalServer(tp, k=6, n_first=n_first,
                                            backend="fused").query_batch(tq)
            _assert_topk(got, want)


class TestServeSlice:
    @pytest.mark.parametrize("compress,bits,pool", [("int8", 4, 0.0),
                                                    ("residual", 2, 0.95)])
    def test_serve_retrieval_matches_jax(self, jax_init, compress, bits,
                                         pool):
        """encode -> prune -> pool -> pack compressed -> two-stage serve,
        with the reference's weights and sphere samples carried across
        and the reference's Lloyd's init injected."""
        ji, js = j_serve_retrieval(n_queries=8, compress=compress,
                                   residual_bits=bits, pool_threshold=pool)
        _, model = _port(J_SMOKE, colbert_base.SMOKE)
        samples = torch.from_numpy(np.array(j_sample_sphere(
            jax.random.PRNGKey(1), 2048, J_SMOKE.out_dim)))
        res = serve_retrieval(colbert_base.SMOKE, n_queries=8, device="cpu",
                              model=model, samples=samples,
                              compress=compress, residual_bits=bits,
                              pool_threshold=pool)
        np.testing.assert_array_equal(res.idx, np.asarray(ji))
        np.testing.assert_allclose(res.scores, np.asarray(js), atol=ATOL)
        assert res.packed.compression == compress
