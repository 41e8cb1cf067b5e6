"""Plain PyTorch versions of the ColBERT MaxSim kernels.

Counterpart of ``repro.kernels.colbert_maxsim.ref``; each materializes
the score tensor the kernels exist to avoid.
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import NEG_INF


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
    s = torch.einsum("ld,nmd->nlm", q_emb.float(), d_embs.float())
    return _reduce(s, d_masks, None if q_mask is None else q_mask[None, :])


def colbert_maxsim_multi_ref(q_embs, d_embs, d_masks, q_masks=None):
    """q_embs (n_q, l, dim); d_embs (n_docs, m, dim) -> (n_q, n_docs)."""
    s = torch.einsum("qld,nmd->qnlm", q_embs.float(), d_embs.float())
    return _reduce(s, d_masks[None],
                   None if q_masks is None else q_masks[:, None, :])


def colbert_maxsim_rerank_ref(q_embs, d_subs, m_subs, q_masks=None):
    """Query i vs its own candidates: q_embs (n_q, l, dim);
    d_subs (n_q, n_cand, m, dim); m_subs (n_q, n_cand, m) ->
    (n_q, n_cand)."""
    s = torch.einsum("qld,qnmd->qnlm", q_embs.float(), d_subs.float())
    return _reduce(s, m_subs,
                   None if q_masks is None else q_masks[:, None, :])
