"""Wrappers of the ``maxsim_top2`` CUDA kernel (``csrc/maxsim_top2.cu``).

Counterpart of ``repro.kernels.maxsim_top2.ops``.  The kernel takes a
whole bucket of documents, so one launch serves one greedy step of
Alg. 1 for every document of the bucket.  The launch splits samples
and tokens into three bf16 planes first (a pre-pass in the same C
entry) into scratch allocated here; the kernel takes dim <= 128.

* :func:`maxsim_top2_op` — (best, second, argbest, argsecond); a CPU
  tensor runs the plain version (``ref.py``), a CUDA tensor launches
  the kernel (``maxsim_top2_op.launches`` counts the launches).
* :func:`maxsim_top2_update_op` — cell reassignment after an
  alive-mask shrink: rescan, then keep the old state for every sample
  whose best and second both survived (the reference's
  ``skip_unaffected=False`` path, which its batch entry uses).
* :func:`voronoi_errors_fused` — Eq. 8 per-token errors from one
  kernel pass.
* :func:`maxsim_top2_rows_op` — the same top-2 over every row of one
  large table (Voronoi table pruning): the rows in chunks launched as
  the documents of one launch, merged on the device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.maxsim_top2.ref import (maxsim_top2_ref,
                                                 maxsim_top2_rows_ref,
                                                 merge_chunk_top2)
from repro_torch.kernels.maxsim_topk.ops import DIM_MAX


def _launch(samples, tokens, alive):
    B, m, dim = tokens.shape
    N = samples.shape[0]
    dev = tokens.device
    build.require(samples, "samples", torch.float32, (N, dim), dev)
    build.require(tokens, "tokens", torch.float32, (B, m, dim), dev)
    build.require(alive, "alive", torch.bool, (B, m), dev)
    if dim > DIM_MAX:
        raise ValueError(f"dim={dim} exceeds the kernel's limit {DIM_MAX}")
    best = torch.empty((B, N), dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    bi = torch.empty((B, N), dtype=torch.int32, device=dev)
    si = torch.empty_like(bi)
    s_planes = torch.empty((3, N, DIM_MAX), dtype=torch.bfloat16, device=dev)
    s_flags = torch.empty((-(-N // 64),), dtype=torch.int32, device=dev)
    t_planes = torch.empty((3, B * m, DIM_MAX), dtype=torch.bfloat16,
                           device=dev)
    t_flags = torch.empty((B,), dtype=torch.int32, device=dev)
    build.launch(
        "maxsim_top2", "maxsim_top2_launch", dev, samples.data_ptr(),
        tokens.data_ptr(), alive.data_ptr(), B, N, m, dim,
        s_planes.data_ptr(), s_flags.data_ptr(), t_planes.data_ptr(),
        t_flags.data_ptr(), best.data_ptr(), second.data_ptr(),
        bi.data_ptr(), si.data_ptr(), build.stream_ptr(tokens))
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


def maxsim_top2_rows_op(samples, table, chunk: int = 4096):
    """samples (N, dim); table (V, dim) -> (best, second, argbest,
    argsecond) over every row, each (N,); f32, f32, int32, int32.

    One B1 launch takes the table as ceil(V / chunk) documents of
    ``chunk`` rows (the last padded with dead zero rows), so a table of
    a million rows fills the card's grid and the split pre-pass runs a
    block a chunk, where one document of V rows would run 64 blocks and
    one pre-pass block; :func:`~.ref.merge_chunk_top2` then merges the
    chunks' (C, N) results on the device.  A CPU tensor runs
    :func:`~.ref.maxsim_top2_rows_ref`.  Counts one launch."""
    if table.device.type == "cpu":
        return maxsim_top2_rows_ref(samples, table, chunk)
    if table.device.type != "cuda":
        raise ValueError(f"maxsim_top2 runs on cpu or cuda, not "
                         f"{table.device}")
    V, dim = table.shape
    if V < 1 or chunk < 1:
        raise ValueError(f"need a table of >= 1 row and chunk >= 1, got "
                         f"{V} rows and chunk {chunk}")
    C = -(-V // chunk)
    pad = C * chunk - V
    rows = table if not pad else torch.cat([table,
                                            table.new_zeros((pad, dim))])
    alive = torch.ones(C * chunk, dtype=torch.bool, device=table.device)
    alive[V:] = False
    out = _launch(samples, rows.view(C, chunk, dim), alive.view(C, chunk))
    starts = torch.arange(C, device=table.device) * chunk
    return merge_chunk_top2(*out, starts=starts)
