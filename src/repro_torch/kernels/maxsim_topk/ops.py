"""Wrapper of the ``maxsim_topk`` CUDA kernel (``csrc/maxsim_topk.cu``).

Counterpart of ``repro.kernels.maxsim_topk.ops``: the rescan primitive
of the ``shortlist_topk`` pruning path.  A CPU tensor runs the plain
version (``ref.py``); a CUDA tensor launches the kernel, one launch per
rescan for a whole bucket (``maxsim_topk_op.launches`` counts them).
The launch splits samples and tokens into three bf16 planes first (a
pre-pass in the same C entry) into scratch allocated here; the kernel
takes dim <= 128.  ``block_docs`` is the number of documents a CUDA
block takes (the tuner's ``KernelConfig.block_docs``;
:func:`default_block_docs` where not given); the result does not depend
on it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref

K_MAX = 32   # the kernel's longest register list (csrc KMAX)
DIM_MAX = 128   # the bf16 planes' row length (csrc PLANE_DP)
ROWS = 128   # samples a block (csrc maxsim_sm90::ROWS), B1's too
TILE = 64    # tokens a tile (csrc maxsim_sm90::TILE)


def default_block_docs(n_samples: int, n_docs: int, device) -> int:
    """B1's and B2's doc block for ``n_docs`` documents against
    ``n_samples`` samples on ``device``'s card: about four blocks an SM
    over the ceil(N / 128) sample blocks (``build.docs_per_block``)."""
    return build.docs_per_block(n_docs, 1, -(-n_samples // ROWS),
                                build.sm_count(device))


def _launch(samples, tokens, alive, k, block_docs):
    B, m, dim = tokens.shape
    N = samples.shape[0]
    dev = tokens.device
    build.require(samples, "samples", torch.float32, (N, dim), dev)
    build.require(tokens, "tokens", torch.float32, (B, m, dim), dev)
    build.require(alive, "alive", torch.bool, (B, m), dev)
    if k > K_MAX:
        raise ValueError(f"k={k} exceeds the kernel's limit {K_MAX}")
    if dim > DIM_MAX:
        raise ValueError(f"dim={dim} exceeds the kernel's limit {DIM_MAX}")
    vals = torch.empty((B, N, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    s_planes = torch.empty((3, N, DIM_MAX), dtype=torch.bfloat16, device=dev)
    s_flags = torch.empty((-(-N // 64),), dtype=torch.int32, device=dev)
    t_planes = torch.empty((3, B * m, DIM_MAX), dtype=torch.bfloat16,
                           device=dev)
    t_flags = torch.empty((B,), dtype=torch.int32, device=dev)
    if block_docs is None:
        block_docs = default_block_docs(N, B, dev)
    build.launch(
        "maxsim_topk", "maxsim_topk_launch", dev, samples.data_ptr(),
        tokens.data_ptr(), alive.data_ptr(), B, N, m, dim, k,
        s_planes.data_ptr(), s_flags.data_ptr(), t_planes.data_ptr(),
        t_flags.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
        int(block_docs), build.stream_ptr(tokens))
    maxsim_topk_op.launches += 1
    return vals, idxs


def maxsim_topk_op(samples, tokens, alive, *, k: int,
                   block_docs: int | None = None):
    """samples (N, dim); tokens (m, dim) or (B, m, dim); alive (m,) or
    (B, m); k <= m -> (values (..., N, k) f32 sorted descending,
    indices (..., N, k) int32), equal to ``lax.top_k`` of the masked
    score matrix, ties to the lowest index."""
    m = tokens.shape[-2]
    if k > m:
        raise ValueError(f"k={k} exceeds token count m={m}")
    if build.plain(tokens):
        return maxsim_topk_ref(samples, tokens, alive, k,
                               block_docs=block_docs)
    if tokens.device.type != "cuda":
        raise ValueError(f"maxsim_topk runs on cpu or cuda, not "
                         f"{tokens.device}")
    if tokens.dim() == 2:
        return tuple(o[0] for o in _launch(samples, tokens[None],
                                           alive[None], k, block_docs))
    return _launch(samples, tokens, alive, k, block_docs)


maxsim_topk_op.launches = 0
