"""Wrappers of the ``maxsim_top2`` CUDA kernel (``csrc/maxsim_top2.cu``).

Counterpart of ``repro.kernels.maxsim_top2.ops``.  The kernel takes a
whole bucket of documents, so one launch serves one greedy step of
Alg. 1 for every document of the bucket.

* :func:`maxsim_top2_op` — (best, second, argbest, argsecond); a CPU
  tensor runs the plain version (``ref.py``), a CUDA tensor launches
  the kernel (``maxsim_top2_op.launches`` counts the launches).
* :func:`maxsim_top2_update_op` — cell reassignment after an
  alive-mask shrink: rescan, then keep the old state for every sample
  whose best and second both survived (the reference's
  ``skip_unaffected=False`` path, which its batch entry uses).
* :func:`voronoi_errors_fused` — Eq. 8 per-token errors from one
  kernel pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref


def _launch(samples, tokens, alive):
    B, m, dim = tokens.shape
    N = samples.shape[0]
    dev = tokens.device
    build.require(samples, "samples", torch.float32, (N, dim), dev)
    build.require(tokens, "tokens", torch.float32, (B, m, dim), dev)
    build.require(alive, "alive", torch.bool, (B, m), dev)
    best = torch.empty((B, N), dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    bi = torch.empty((B, N), dtype=torch.int32, device=dev)
    si = torch.empty_like(bi)
    lib = build.library("maxsim_top2")
    build.check("maxsim_top2", lib.maxsim_top2_launch(
        samples.data_ptr(), tokens.data_ptr(), alive.data_ptr(), B, N, m,
        dim, best.data_ptr(), second.data_ptr(), bi.data_ptr(),
        si.data_ptr(), build.stream_ptr(tokens)))
    maxsim_top2_op.launches += 1
    return best, second, bi, si


def maxsim_top2_op(samples, tokens, alive):
    """samples (N, dim); tokens (m, dim) or (B, m, dim); alive (m,) or
    (B, m) bool -> (best, second, argbest, argsecond), each (N,) or
    (B, N); f32, f32, int32, int32."""
    if tokens.device.type == "cpu":
        return maxsim_top2_ref(samples, tokens, alive)
    if tokens.device.type != "cuda":
        raise ValueError(f"maxsim_top2 runs on cpu or cuda, not "
                         f"{tokens.device}")
    if tokens.dim() == 2:
        return tuple(o[0] for o in _launch(samples, tokens[None],
                                           alive[None]))
    return _launch(samples, tokens, alive)


maxsim_top2_op.launches = 0


def maxsim_top2_update_op(samples, tokens, alive, prev):
    """Cell state under the shrunk ``alive`` mask from ``prev`` (the
    (best, second, argbest, argsecond) tuple under a superset mask):
    a full rescan, kept only for samples whose best or second died.
    Returns ``(new_state, affected)``."""
    p_best, p_second, p_bi, p_si = prev
    affected = (~alive.gather(-1, p_bi.long())
                | ~alive.gather(-1, p_si.long()))
    fresh = maxsim_top2_op(samples, tokens, alive)
    new = tuple(torch.where(affected, f, p)
                for f, p in zip(fresh, prev))
    return new, affected


def voronoi_errors_fused(samples, tokens, alive):
    """Eq. 8 per-token errors via the kernel (never materializes the
    (N, m) score matrix); dead tokens get +inf."""
    from repro_torch.core.voronoi import token_errors
    state = maxsim_top2_op(samples, tokens, alive)
    return token_errors(state, alive, samples.shape[0])
