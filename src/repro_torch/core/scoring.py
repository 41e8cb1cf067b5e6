"""Late-interaction (ColBERT) scoring oracles — Eq. 1 of the paper.

Counterpart of ``repro.core.scoring``.  A document is a padded
(m, dim) matrix plus a bool mask (m,); batches stack on the leading
axis.  ``NEG_INF`` is the large-but-finite masked-score sentinel, so
masked maxes never produce NaNs.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def maxsim(q_emb, d_emb, d_mask=None, q_mask=None):
    """ColBERT(Q, D) = sum_q max_d q.d for one (query, doc) pair."""
    scores = q_emb @ d_emb.T                          # (l, m)
    if d_mask is not None:
        scores = torch.where(d_mask[None, :], scores, NEG_INF)
    best = scores.amax(-1)
    if q_mask is not None:
        best = torch.where(q_mask, best, 0.0)
    return best.sum()


def maxsim_batch_docs(q_emb, d_embs, d_masks=None, q_mask=None):
    """One query against a batch of docs: (n_docs,)."""
    s = torch.einsum("ld,nmd->nlm", q_emb, d_embs)
    if d_masks is not None:
        s = torch.where(d_masks[:, None, :], s, NEG_INF)
    best = s.amax(-1)
    if q_mask is not None:
        best = torch.where(q_mask[None, :], best, 0.0)
    return best.sum(-1)


def maxsim_pairs(q_embs, d_embs, d_masks=None, q_masks=None):
    """Paired scoring: query i vs doc i -> (batch,)."""
    s = torch.einsum("bld,bmd->blm", q_embs, d_embs)
    if d_masks is not None:
        s = torch.where(d_masks[:, None, :], s, NEG_INF)
    best = s.amax(-1)
    if q_masks is not None:
        best = torch.where(q_masks, best, 0.0)
    return best.sum(-1)


def maxsim_matrix(q_embs, d_embs, d_masks=None, q_masks=None):
    """All-pairs scoring: (n_q, n_d), through the 4-D einsum tensor."""
    s = torch.einsum("aid,bjd->abij", q_embs, d_embs)
    if d_masks is not None:
        s = torch.where(d_masks[None, :, None, :], s, NEG_INF)
    best = s.amax(-1)
    if q_masks is not None:
        best = torch.where(q_masks[:, None, :], best, 0.0)
    return best.sum(-1)


def top2_from_scores(scores, alive):
    """(best, second, argbest, argsecond) of a (..., N, m) score tensor
    over ``alive`` (..., m) tokens: dead tokens score ``NEG_INF``; the
    second is the argmax of the row with its best slot reset to
    ``NEG_INF`` — both argmaxes take the lowest index on ties (torch's
    ``argmax`` returns the first maximal index)."""
    s = torch.where(alive[..., None, :], scores, NEG_INF)
    bi = s.argmax(-1)
    best = s.gather(-1, bi[..., None])[..., 0]
    s2 = s.scatter(-1, bi[..., None], NEG_INF)
    si = s2.argmax(-1)
    second = s2.gather(-1, si[..., None])[..., 0]
    return best, second, bi.to(torch.int32), si.to(torch.int32)


def doc_scores(samples, d_emb):
    """samples @ d_emb.T for each doc: samples (N, dim), ``d_emb``
    (..., m, dim) -> (..., N, m), one product a doc.  A product over a
    batch of docs — ``samples @ batch.mT`` folds the batch into the rows
    of one GEMM, a batched product picks its blocking by the batch
    count — gives a doc other bits beside other batchmates (MKL at
    several threads, and at one thread once the folded rows change;
    cuBLAS picks kernels by shape), so pruning would depend on a doc's
    bucket or data shard.  A doc's own product is the same call
    whatever shares its batch."""
    if d_emb.dim() == 2:
        return samples @ d_emb.T
    lead, (m, dim) = d_emb.shape[:-2], d_emb.shape[-2:]
    flat = d_emb.reshape(-1, m, dim)
    if not flat.shape[0]:
        return samples.new_zeros(lead + (samples.shape[0], m))
    return torch.stack([samples @ d.T for d in flat]).reshape(
        lead + (samples.shape[0], m))


def top2_scores(samples, d_emb, d_mask):
    """Per-sample (best, second, argbest, argsecond) of samples @ d_emb.T
    — the oracle for the ``maxsim_top2`` kernel.  ``d_emb`` (m, dim) or a
    batch (B, m, dim) with ``d_mask`` (B, m)."""
    return top2_from_scores(doc_scores(samples, d_emb), d_mask)
