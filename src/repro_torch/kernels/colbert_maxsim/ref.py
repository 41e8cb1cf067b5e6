"""Plain PyTorch versions of the ColBERT MaxSim kernels.

Counterpart of ``repro.kernels.colbert_maxsim.ref``; each materializes
the score tensor the kernels exist to avoid, and the residual versions
also the decoded fp32 docs (``train.compress`` decode, then the dense
version).

The query-batch versions take one product a query, as the kernels do
(each query's scores read only its own row), so a query's scores are
the same bits alone or among any batchmates — the serving loop's
contract.  Each query's product runs over zero-padded blocks of a fixed
``DOC_BLOCK`` docs, so a doc's (l, m) token scores are the same bits
whichever docs share the call and wherever it sits among them — the
sharded serving contract (a doc's score does not depend on its shard or
slab).  Products over a whole query batch or over all docs at once are
neither: their blocking depends on the batch, and on the CPU (MKL) a
score can differ in the last bit (an AVX-512 host at 8 threads gave a
doc of l 8, m 20 other bits alone than among 37 under one batched
product; ``tests/test_torch_maxsim_ref_invariance.py`` holds a doc alone
to the doc in a batch, ``tests/test_torch_serve_loop.py`` the loop's
answers to the query served alone, ``tests/test_torch_sharded_serving.py``
sharded answers to the single-device one).
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import NEG_INF
from repro_torch.train.compress import dequantize_residual, residual_values

DOC_BLOCK = 64   # docs a batched product; a fixed count (module docstring)


def _reduce(s, d_masks, q_masks):
    """Mask doc tokens to NEG_INF, max over them, zero masked query
    tokens, sum over query tokens.  s (..., l, m)."""
    s = torch.where(d_masks[..., None, :], s, NEG_INF)
    best = s.amax(-1)
    if q_masks is not None:
        best = torch.where(q_masks, best, 0.0)
    return best.sum(-1)


def colbert_maxsim_ref(q_emb, d_embs, d_masks, q_mask=None):
    """q_emb (l, dim); d_embs (n_docs, m, dim); d_masks (n_docs, m) ->
    (n_docs,) ColBERT scores (Eq. 1)."""
    s = _doc_batched(q_emb.float(), d_embs.float())
    return _reduce(s, d_masks, None if q_mask is None else q_mask[None, :])


def _doc_batched(q, d):
    """(n_docs, l, m) token scores of one query q (l, dim) against d
    (n_docs, m, dim): one batched product a block of ``DOC_BLOCK`` docs,
    the last block zero-padded, so a doc's scores do not depend on the
    docs beside it (module docstring)."""
    n = d.shape[0]
    if not n:
        return q.new_zeros((0, q.shape[0], d.shape[1]))
    pad = (-n) % DOC_BLOCK
    if pad:
        d = torch.cat([d, d.new_zeros((pad,) + d.shape[1:])])
    q = q[None]
    return torch.cat([torch.matmul(q, d[c:c + DOC_BLOCK].transpose(1, 2))
                      for c in range(0, n + pad, DOC_BLOCK)])[:n]


def _per_query(q_embs, d_blocks):
    """(n_q, n_docs, l, m) token scores of query i against ``d_blocks[i]``
    (n_docs, m, dim), one product a query (module docstring)."""
    q_embs = q_embs.float()
    if not q_embs.shape[0]:
        return torch.einsum("qld,qnmd->qnlm", q_embs, d_blocks.float())
    return torch.stack([_doc_batched(q, d.float())
                        for q, d in zip(q_embs, d_blocks)])


def colbert_maxsim_multi_ref(q_embs, d_embs, d_masks, q_masks=None):
    """q_embs (n_q, l, dim); d_embs (n_docs, m, dim) -> (n_q, n_docs)."""
    d = d_embs.float()
    s = _per_query(q_embs, d.expand((q_embs.shape[0],) + d.shape))
    return _reduce(s, d_masks[None],
                   None if q_masks is None else q_masks[:, None, :])


def colbert_maxsim_rerank_ref(q_embs, d_subs, m_subs, q_masks=None):
    """Query i vs its own candidates: q_embs (n_q, l, dim);
    d_subs (n_q, n_cand, m, dim); m_subs (n_q, n_cand, m) ->
    (n_q, n_cand)."""
    s = _per_query(q_embs, d_subs)
    return _reduce(s, m_subs,
                   None if q_masks is None else q_masks[:, None, :])


def colbert_maxsim_residual_multi_ref(q_embs, codes, resq, rscale, codebook,
                                      d_masks, q_masks=None, *, bits: int):
    """A query batch vs one residual bucket: codes (n_docs, m) int8,
    resq (n_docs, m, dim*bits//8) uint8, rscale (n_docs, m, 1) f32,
    codebook (C, dim) f32 -> (n_q, n_docs)."""
    d = dequantize_residual(resq, rscale, codes, codebook, bits)
    return colbert_maxsim_multi_ref(q_embs, d, d_masks, q_masks)


def colbert_maxsim_residual_rerank_ref(q_embs, code_subs, resq_subs,
                                       scale_subs, codebooks, bucket_of,
                                       m_subs, q_masks=None, *, bits: int):
    """Query i vs its own residual candidates, candidate (i, j) decoding
    against codebook ``bucket_of[i, j]`` of the (n_buckets, C, dim)
    table: code_subs (n_q, n_cand, m); resq_subs (n_q, n_cand, m, pb);
    scale_subs (n_q, n_cand, m, 1) -> (n_q, n_cand)."""
    cent = codebooks[bucket_of.long()[..., None], code_subs.long()]
    d = cent + residual_values(resq_subs, scale_subs, bits)
    return colbert_maxsim_rerank_ref(q_embs, d, m_subs, q_masks)
