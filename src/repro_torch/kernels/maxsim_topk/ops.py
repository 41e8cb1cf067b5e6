"""Wrapper of the ``maxsim_topk`` CUDA kernel (``csrc/maxsim_topk.cu``).

Counterpart of ``repro.kernels.maxsim_topk.ops``: the rescan primitive
of the ``shortlist_topk`` pruning path.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the kernel, one launch per
rescan for a whole bucket (``maxsim_topk_op.launches`` counts them).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref

K_MAX = 32   # the kernel's per-thread list length (csrc KMAX)


def _launch(samples, tokens, alive, k):
    B, m, dim = tokens.shape
    N = samples.shape[0]
    dev = tokens.device
    build.require(samples, "samples", torch.float32, (N, dim), dev)
    build.require(tokens, "tokens", torch.float32, (B, m, dim), dev)
    build.require(alive, "alive", torch.bool, (B, m), dev)
    if k > K_MAX:
        raise ValueError(f"k={k} exceeds the kernel's limit {K_MAX}")
    vals = torch.empty((B, N, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    lib = build.library("maxsim_topk")
    build.check("maxsim_topk", lib.maxsim_topk_launch(
        samples.data_ptr(), tokens.data_ptr(), alive.data_ptr(), B, N, m,
        dim, k, vals.data_ptr(), idxs.data_ptr(), build.stream_ptr(tokens)))
    maxsim_topk_op.launches += 1
    return vals, idxs


def maxsim_topk_op(samples, tokens, alive, *, k: int):
    """samples (N, dim); tokens (m, dim) or (B, m, dim); alive (m,) or
    (B, m); k <= m -> (values (..., N, k) f32 sorted descending,
    indices (..., N, k) int32), equal to ``lax.top_k`` of the masked
    score matrix, ties to the lowest index."""
    m = tokens.shape[-2]
    if k > m:
        raise ValueError(f"k={k} exceeds token count m={m}")
    if tokens.device.type == "cpu":
        return maxsim_topk_ref(samples, tokens, alive, k)
    if tokens.device.type != "cuda":
        raise ValueError(f"maxsim_topk runs on cpu or cuda, not "
                         f"{tokens.device}")
    if tokens.dim() == 2:
        return tuple(o[0] for o in _launch(samples, tokens[None],
                                           alive[None], k))
    return _launch(samples, tokens, alive, k)


maxsim_topk_op.launches = 0
