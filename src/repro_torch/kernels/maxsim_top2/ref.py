"""Plain PyTorch version of the ``maxsim_top2`` kernel.

Counterpart of ``repro.kernels.maxsim_top2.ref``: per (document,
sample), (best, second, argbest, argsecond) of samples @ tokens.T over
alive tokens, through the materialized score tensor.  The CPU path of
the wrapper and the oracle the kernel is held against on the card.
"""

from __future__ import annotations

from repro_torch.core.scoring import top2_from_scores


def maxsim_top2_ref(samples, tokens, alive):
    """samples (N, dim); tokens (..., m, dim); alive (..., m) bool ->
    best, second (..., N) f32 and argbest, argsecond (..., N) int32."""
    scores = samples.float() @ tokens.float().transpose(-1, -2)
    return top2_from_scores(scores, alive)
