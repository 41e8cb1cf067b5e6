"""Per-family training losses.

Counterpart of ``repro.train.losses``, differentiated by
``torch.autograd``.  Only :func:`colbert_contrastive` is on a ported
training path; the others are the reference's arithmetic for the
families still to port.
"""

from __future__ import annotations

import torch

from repro_torch.core import regularizers
from repro_torch.core.scoring import maxsim_matrix


def softmax_xent(logits, labels, mask=None):
    """Token-level cross entropy; logits (..., V), labels (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def lm_loss(logits, tokens, loss_mask=None):
    """Next-token CE: logits (B, S, V) predicts tokens shifted by one."""
    m = None if loss_mask is None else loss_mask[:, 1:]
    return softmax_xent(logits[:, :-1], tokens[:, 1:], m)


def bce_logits(logits, labels):
    lg = logits.float()
    return (lg.clamp_min(0) - lg * labels
            + torch.log1p(torch.exp(-lg.abs()))).mean()


def colbert_contrastive(q_embs, d_embs, d_masks, q_masks=None, *,
                        reg: str | None = None, alpha: float = 0.0):
    """In-batch contrastive: query i's positive is doc i; all-pairs MaxSim
    scores -> softmax CE.  Optional [27] regularizer (Eq. 9/10).
    Returns (loss, scores (B, B))."""
    scores = maxsim_matrix(q_embs, d_embs, d_masks, q_masks)
    labels = torch.arange(scores.shape[0], device=scores.device)
    loss = softmax_xent(scores, labels)
    if reg == "l1":
        loss = loss + alpha * regularizers.l1_reg(d_embs, d_masks)
    elif reg == "sim":
        loss = loss + alpha * regularizers.doc_sim_reg(d_embs, d_masks)
    return loss, scores


def masked_item_loss(logits, labels, mask_positions):
    """BERT4Rec: CE at masked positions only."""
    return softmax_xent(logits, labels, mask_positions.float())
