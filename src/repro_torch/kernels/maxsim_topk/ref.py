"""Plain PyTorch version of the ``maxsim_topk`` kernel.

Counterpart of ``repro.kernels.maxsim_topk.ref``: each sample's k best
scores of the masked samples @ tokens.T and their token indices, sorted
descending with ties to the lowest index — ``lax.top_k``'s contract,
reproduced with a stable descending sort (``torch.topk`` promises no
order among ties).
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import NEG_INF, doc_scores


def topk_lowest_index(scores, k: int):
    """(values, int32 indices) of the k largest entries of the last axis,
    descending, ties to the lowest index."""
    vals, idxs = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k].to(torch.int32)


def maxsim_topk_ref(samples, tokens, alive, k: int, *, block_docs=None):
    """samples (N, dim); tokens (..., m, dim); alive (..., m) ->
    values (..., N, k) f32 and indices (..., N, k) int32.  ``block_docs``
    (the kernel's doc block) changes nothing here."""
    scores = doc_scores(samples.float(), tokens.float())
    scores = torch.where(alive[..., None, :], scores, NEG_INF)
    return topk_lowest_index(scores, k)
