"""Fine-tuning regularizers from [27], used by the paper (§5.1, Eq. 9-10).

Counterpart of ``repro.core.regularizers``.  Both operate on the padded
document token embeddings of one document and average over the batch.
They are added to the contrastive ColBERT loss as ``loss + alpha * reg``
with the paper's alpha grid {0.01, 0.1, 0.8}.
"""

from __future__ import annotations

import torch


def l1_reg(d_embs, d_mask):
    """Eq. 9: L^(L1) = (1/n) sum_d ||d||_1 per document, batch-averaged."""
    l1 = torch.where(d_mask, d_embs.abs().sum(-1), 0.0)
    n = d_mask.sum(-1).clamp_min(1)
    return (l1.sum(-1) / n).mean()


def doc_sim_reg(d_embs, d_mask, eps: float = 0.01):
    """Eq. 10: L^(sim) = -1/(n(n-1)) sum_d (1-||d||_2)
                          sum_{d' != d} [d.d']_+ / (||d||_2 + eps).

    Pushes redundant tokens (high positive similarity to siblings) toward
    the center of the ball so Norm/LP pruning can discard them.
    """
    norms = torch.linalg.vector_norm(d_embs, dim=-1)        # (B, m)
    dots = torch.einsum("bid,bjd->bij", d_embs, d_embs)     # (B, m, m)
    pos = dots.clamp_min(0.0)
    m = d_mask.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=d_mask.device)
    pair_mask = d_mask[:, :, None] & d_mask[:, None, :] & ~eye[None]
    sim_sum = torch.where(pair_mask, pos, 0.0).sum(-1)      # (B, m)
    per_tok = (1.0 - norms) * sim_sum / (norms + eps)
    per_tok = torch.where(d_mask, per_tok, 0.0)
    n = d_mask.sum(-1).clamp_min(2)
    return -(per_tok.sum(-1) / (n * (n - 1))).mean()


def ball_projection(raw):
    """[27]'s projection controlling ||d|| in (0, 1): instead of the usual
    L2 normalization *onto* the sphere, map embeddings *into* the ball via
    x -> x * tanh(||x||)(1 - 1e-3) / ||x|| (norms strictly inside the
    unit ball)."""
    n = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    scale = torch.tanh(n) * (1.0 - 1e-3)
    return raw * torch.where(n > 0, scale / n.clamp_min(1e-9), 0.0)
