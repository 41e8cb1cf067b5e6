"""Voronoi pruning — the paper's core contribution (§4, Alg. 1).

Counterpart of ``repro.core.voronoi``:

* ``V_i = {q : d_i = argmax_d q.d}`` (Eq. 5) — the cell of token i;
* ``Error(d_i) = E_{q in V_i}[q.d_i - second_best(q)]`` (Eq. 6-8),
  estimated over N unit-sphere samples;
* greedy removal with incremental cell reassignment (Alg. 1);
* corpus-level pruning by merging per-document orders (§4.2);
* the ablation variants of §6.2: step size > 1, beam search, the
  single-pass and bf16 reference reductions, and the Mean Error of a
  pruned document (§6.4).

Batching: the reference runs ``m - 1`` greedy steps as a ``lax.scan``
vmapped over documents.  Here the document axis is a batch dimension
written out: every function below takes a bucket (B, m, dim) and runs a
Python loop over steps in which each step is a few launches for the
whole bucket — never one launch per document, and no host sync inside
the loop.

Determinism and batch invariance: a doc's (ranks, errs, orders) are the
same bits whatever docs share its batch, bucket or data shard.  Score
products take one product a doc (``scoring.doc_scores``).  The Eq. 8
accumulation (a segment sum of gaps by cell) is, on the card, a one-hot
batched product in fixed-size doc chunks, as the reference's shortlist
path writes it (``voronoi.py:418-419``), not ``index_add_``: atomics sum
in an order that changes from run to run, and the greedy argmin over
errors would then flip on near-ties from one run to the next.  On the
CPU it is ``scatter_add_``, which sums each doc's gaps in sample order
(MKL's batched product gives a doc other bits at another position in
its chunk).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.scoring import (NEG_INF, doc_scores,
                                     top2_from_scores, top2_scores)
from repro_torch.kernels.maxsim_top2.ops import (maxsim_top2_op,
                                                 maxsim_top2_update_op)
from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.sharding.specs import data_mesh_for

__all__ = [
    "CellState",
    "assign_cells",
    "beam_pruning_order",
    "estimate_errors",
    "global_keep_masks",
    "keep_mask_from_order",
    "mean_error",
    "mean_error_batch",
    "prune_to_size",
    "pruning_order",
    "pruning_order_batch",
    "pruning_order_shortlist",
    "resolve_pruning_backend",
    "token_errors",
]


class CellState(NamedTuple):
    """Per-sample Voronoi bookkeeping under the current alive-token set;
    each field (..., N)."""

    best: torch.Tensor     # best dot product
    second: torch.Tensor   # second-best dot product
    bi: torch.Tensor       # index of the best token (cell membership)
    si: torch.Tensor       # index of the second-best token


# Elements of the transient (docs, N, m) one-hot per accumulation chunk,
# and the most docs a chunk takes.
_ONEHOT_BUDGET = 1 << 28
_CELL_DOCS = 64


def _cell_sums(gap, bi, m: int):
    """sum_n gap[b, n] * [bi[b, n] == t] -> (B, m), deterministic and
    the same bits whichever docs share a doc's bucket or data shard (see
    module docstring).  On the CPU, ``scatter_add_`` in sample order; on
    the card, a one-hot batched product in chunks of a fixed number of
    docs that depends on (N, m) only, the last chunk zero-padded (a
    batched product's blocking depends on its batch count)."""
    B, n = gap.shape
    if gap.device.type == "cpu":
        return gap.new_zeros((B, m)).scatter_add_(1, bi, gap)
    tok = torch.arange(m, device=gap.device, dtype=bi.dtype)
    step = max(1, min(_CELL_DOCS, _ONEHOT_BUDGET // max(n * m, 1)))
    pad = (-B) % step
    if pad:
        gap = torch.cat([gap, gap.new_zeros((pad, n))])
        bi = torch.cat([bi, bi.new_zeros((pad, n))])
    out = []
    for c in range(0, B + pad, step):
        onehot = (bi[c:c + step, :, None] == tok).to(gap.dtype)
        out.append(torch.bmm(gap[c:c + step, None, :], onehot)[:, 0])
    return torch.cat(out)[:B] if out else gap.new_zeros((0, m))


def token_errors(state, alive, n_samples: int):
    """Eq. 8: err[t] = (1/N) * sum over samples in t's cell of
    (best - second); dead tokens +inf, empty cells exactly 0.
    ``state`` = (best, second, argbest, argsecond), each (..., N);
    ``alive`` (..., m)."""
    best, second, bi, _ = state
    lead = alive.shape[:-1]
    m = alive.shape[-1]
    gap = (best - second).reshape(-1, best.shape[-1])
    err = _cell_sums(gap, bi.reshape(gap.shape).long(), m) / n_samples
    return torch.where(alive, err.reshape(*lead, m), torch.inf)


def assign_cells(d_emb, d_mask, samples) -> CellState:
    """Initial cell assignment of every sample (Eq. 5); ``d_emb`` (m, dim)
    or a batch (B, m, dim)."""
    return CellState(*top2_scores(samples, d_emb, d_mask))


def estimate_errors(d_emb, d_mask, samples):
    """One-shot (non-iterative) Monte-Carlo error estimate per token."""
    state = assign_cells(d_emb, d_mask, samples)
    return token_errors(state, d_mask, samples.shape[0])


def _top2_single_pass(scores, alive) -> CellState:
    """The reference's single-pass top-2 (``fast``/``single_pass``): one
    fp32 top-2 reduction over the row, exact up to the order of exactly
    equal scores (the reference's variadic reduce breaks those in its
    own order)."""
    s = torch.where(alive[..., None, :], scores, NEG_INF).float()
    vals, idx = s.topk(2, dim=-1)
    return CellState(vals[..., 0], vals[..., 1], idx[..., 0].to(torch.int32),
                     idx[..., 1].to(torch.int32))


def _select_removals(err, alive, step_size: int):
    """One Alg. 1 removal step over a bucket: the ``step_size`` cheapest
    alive tokens of each doc (never its last survivor), lowest index on
    ties (a stable ascending sort — ``lax.top_k(-err)``'s order).
    Returns (new_alive, sel_idx, sel_err, removed_any)."""
    B, m = err.shape
    if step_size > m:
        raise ValueError(f"step_size={step_size} exceeds m={m}")
    k_want = (alive.sum(-1) - 1).clamp(0, step_size)
    vals, idxs = torch.sort(err, dim=-1, stable=True)
    vals, idxs = vals[:, :step_size], idxs[:, :step_size]
    take = (torch.arange(step_size, device=err.device)[None, :]
            < k_want[:, None])
    sel_idx = torch.where(take, idxs, -1)
    sel_err = torch.where(take, vals, torch.inf)
    buf = torch.cat([alive, alive.new_zeros((B, 1))], dim=1)
    buf.scatter_(1, torch.where(take, idxs, m), False)
    return buf[:, :m].contiguous(), sel_idx, sel_err, k_want > 0


def _order_to_rank(order, errs, m: int):
    """Per-step removal records (B, S) -> (rank, err_at_removal, order);
    tokens never removed keep rank m and err +inf."""
    B, S = order.shape
    valid = order >= 0
    safe = torch.where(valid, order, m)
    pos = torch.arange(S, device=order.device, dtype=torch.int32)
    rank = torch.full((B, m + 1), m, dtype=torch.int32, device=order.device)
    rank.scatter_reduce_(1, safe, torch.where(valid, pos, m).expand(B, S),
                         reduce="amin")
    err_at = torch.full((B, m + 1), torch.inf, dtype=errs.dtype,
                        device=order.device)
    err_at.scatter_reduce_(1, safe, torch.where(valid, errs, torch.inf),
                           reduce="amin")
    return rank[:, :m], err_at[:, :m], order.to(torch.int32)


def _greedy_loop(state, alive, n, step_size, rescan):
    """The Alg. 1 scan shared by the reference and fused paths:
    ``rescan(new_alive, state, removed_any)`` returns the reassigned
    cell state after each removal."""
    m = alive.shape[-1]
    n_steps = -(-(m - 1) // step_size)
    orders, errs = [], []
    for _ in range(n_steps):
        err = token_errors(state, alive, n)
        alive, sel_idx, sel_err, removed_any = _select_removals(
            err, alive, step_size)
        state = rescan(alive, state, removed_any)
        orders.append(sel_idx)
        errs.append(sel_err)
    B = alive.shape[0]
    order = (torch.cat(orders, dim=1) if orders
             else alive.new_zeros((B, 0), dtype=torch.long))
    err = (torch.cat(errs, dim=1) if errs
           else torch.zeros((B, 0), device=alive.device))
    return _order_to_rank(order, err, m)


def _pruning_order_reference(d_embs, d_masks, samples, *, step_size,
                             single_pass=False, bf16_scores=False):
    """Materializing path: the (B, N, m) score tensor is computed once;
    each step re-reduces it under the new alive mask and keeps the old
    cell state for samples whose best and second survived.
    ``bf16_scores`` caches the masked scores in bf16, so every reduction
    and the errors run in bf16 as in the reference; ``single_pass``
    reduces each row once (:func:`_top2_single_pass`)."""
    scores = doc_scores(samples, d_embs)
    scores = torch.where(d_masks[:, None, :], scores, NEG_INF)
    if bf16_scores:
        scores = scores.bfloat16()
    top2 = _top2_single_pass if single_pass else top2_from_scores

    def rescan(alive, state, removed_any):
        fresh = top2(scores, alive)
        affected = ((~alive.gather(-1, state[2].long())
                     | ~alive.gather(-1, state[3].long()))
                    & removed_any[:, None])
        return tuple(torch.where(affected, f, s)
                     for f, s in zip(fresh, state))

    state = top2(scores, d_masks)
    return _greedy_loop(state, d_masks, samples.shape[0], step_size, rescan)


def _pruning_order_fused(d_embs, d_masks, samples, *, step_size):
    """Kernel path: each step's top-2 reassignment is one
    ``maxsim_top2`` launch over the whole bucket; no (N, m) score matrix
    is ever resident."""
    def rescan(alive, state, _):
        return maxsim_top2_update_op(samples, d_embs, alive, state)[0]

    state = maxsim_top2_op(samples, d_embs, d_masks)
    return _greedy_loop(state, d_masks, samples.shape[0], step_size, rescan)


def _pruning_order_shortlist(d_embs, d_masks, samples, *, shortlist,
                             rescan_every, rescan, bf16_scores=False):
    """Exact top-K shortlist pruning over a bucket.  Each sample keeps
    its top-K alive tokens from the last rescan; between rescans at most
    ``rescan_every - 1`` tokens die, so the true top-2 of the alive set
    stays inside the shortlist (K >= R + 1).  ``rescan="dense"`` caches
    the (B, N, m) score tensor (in bf16 with ``bf16_scores``) and
    rescans it with a stable sort in fp32; ``rescan="topk"`` rescans
    through the ``maxsim_topk`` kernel."""
    B, m = d_masks.shape
    n = samples.shape[0]
    K, R = min(shortlist, m), rescan_every
    dev = d_embs.device
    if rescan == "dense":
        scores = torch.where(d_masks[:, None, :],
                             doc_scores(samples, d_embs), NEG_INF)
        if bf16_scores:
            scores = scores.bfloat16()

        def rescan_fn(alive):
            return topk_lowest_index(
                torch.where(alive[:, None, :], scores, NEG_INF).float(), K)
    else:
        def rescan_fn(alive):
            return maxsim_topk_op(samples, d_embs, alive, k=K)

    n_steps = m - 1
    kcol = torch.arange(K, device=dev)
    tok = torch.arange(m, device=dev)
    alive = d_masks.clone()
    rank = torch.full((B, m), m, dtype=torch.int32, device=dev)
    err_at = torch.full((B, m), torch.inf, device=dev)
    orders = []
    pos = 0
    while pos < n_steps:
        vals, idxs = rescan_fn(alive)                 # (B, N, K)
        valid = torch.ones((B, n, K), dtype=torch.bool, device=dev)
        for _ in range(min(R, n_steps - pos)):
            v = torch.where(valid, vals, NEG_INF)
            b1, a1 = v.max(-1)                        # first max on ties
            bi = idxs.gather(-1, a1[..., None])[..., 0]
            b2 = torch.where(kcol == a1[..., None], NEG_INF, v).amax(-1)
            e = _cell_sums(b1 - b2, bi.long(), m) / n
            e = torch.where(alive, e, torch.inf)
            j = e.argmin(-1)                          # first min on ties
            do = alive.sum(-1) > 1
            kill = do[:, None] & (tok == j[:, None])
            alive = alive & ~kill
            rank = torch.where(kill, pos, rank)
            err_at = torch.where(kill, e.gather(-1, j[:, None]), err_at)
            valid = valid & ~(do[:, None, None] & (idxs == j[:, None, None]))
            orders.append(torch.where(do, j, -1))
            pos += 1
    order = (torch.stack(orders, dim=1).to(torch.int32) if orders
             else torch.zeros((B, 0), dtype=torch.int32, device=dev))
    return rank, err_at, order


def _resolve_shortlist_knobs(shortlist, rescan_every, *, m):
    """Fill ``None`` shortlist knobs from the fixed K ~ sqrt(m) schedule
    (``backend.shortlist_knobs``); validate the exactness bound."""
    k, r = backend_lib.shortlist_knobs(m)
    if shortlist is None:
        shortlist = k if rescan_every is None else max(k, rescan_every + 1)
    if rescan_every is None:
        rescan_every = min(r, max(shortlist - 1, 1))
    if rescan_every > shortlist - 1:
        raise ValueError("need shortlist >= rescan_every + 1 for exactness")
    return shortlist, rescan_every


def resolve_pruning_backend(backend: str | None, *, shortlist: bool = False,
                            fast: bool = False, bf16_scores: bool = False,
                            step_size: int = 1, device="cuda") -> str:
    """The batch entry's backend policy, as the reference's:
    ``backend="shortlist"`` is an alias of ``shortlist=True``;
    ``shortlist`` with no backend selects ``shortlist`` at step 1;
    ``fast`` or ``bf16_scores`` with no backend selects ``reference``;
    then the per-``step_size`` allow set (shortlist paths remove one
    token per step) and the platform default of ``device``."""
    if backend == backend_lib.SHORTLIST:
        backend, shortlist = None, True
    if backend is None and shortlist and step_size == 1:
        backend = backend_lib.SHORTLIST
    elif backend is None and (fast or bf16_scores):
        backend = backend_lib.REFERENCE
    allow = (backend_lib.PRUNING if step_size == 1
             else (backend_lib.REFERENCE, backend_lib.FUSED))
    return backend_lib.resolve_backend(backend, allow=allow, device=device)


def _check_bucket(d_embs, d_masks, samples):
    if d_embs.dim() != 3 or d_masks.shape != d_embs.shape[:2]:
        raise ValueError("d_embs must be (B, m, dim) with d_masks (B, m)")
    if samples.device != d_embs.device:
        raise ValueError(f"samples on {samples.device}, docs on "
                         f"{d_embs.device}")


def pruning_order_batch(d_embs, d_masks, samples, *, step_size: int = 1,
                        fast: bool = False, bf16_scores: bool = False,
                        shortlist: bool = False, backend: str | None = None,
                        bucketed: bool = False):
    """Alg. 1 over a document batch: ``(ranks, errs, orders)``, (B, m),
    (B, m), (B, n_steps * step_size).  ``rank[i]`` is token i's removal
    step (m for never removed), ``err[i]`` its Eq. 8 error when removed
    (+inf otherwise), ``order[s]`` the token removed at step s (-1 for
    none).  ``fast`` takes the single-pass top-2 and ``bf16_scores`` a
    bf16 score cache (reference-path knobs; ``bf16_scores`` also on the
    dense ``shortlist``); ``shortlist=True`` selects the dense shortlist
    path (:func:`resolve_pruning_backend`).  ``bucketed=True`` routes
    through the length-bucketed pipeline (``core.pruning_pipeline``):
    the same ranks and orders, errors equal to fp32 rounding."""
    if bucketed:
        from repro_torch.core import pruning_pipeline
        return pruning_pipeline.pruning_order_bucketed(
            d_embs, d_masks, samples, step_size=step_size, fast=fast,
            bf16_scores=bf16_scores, shortlist=shortlist, backend=backend)
    _check_bucket(d_embs, d_masks, samples)
    backend = resolve_pruning_backend(backend, shortlist=shortlist,
                                      fast=fast, bf16_scores=bf16_scores,
                                      step_size=step_size,
                                      device=d_embs.device)
    if backend in (backend_lib.FUSED, backend_lib.SHORTLIST_TOPK) and (
            fast or bf16_scores):
        raise ValueError(
            "fast/bf16_scores are materializing-path knobs with no "
            f"{backend}-kernel equivalent; drop them or choose "
            "backend='reference'/'shortlist'")
    if backend in (backend_lib.SHORTLIST, backend_lib.SHORTLIST_TOPK):
        K, R = _resolve_shortlist_knobs(None, None, m=d_masks.shape[1])
        return _pruning_order_shortlist(
            d_embs, d_masks, samples, shortlist=K, rescan_every=R,
            rescan="topk" if backend == backend_lib.SHORTLIST_TOPK
            else "dense", bf16_scores=bf16_scores)
    if backend == backend_lib.FUSED:
        return _pruning_order_fused(d_embs, d_masks, samples,
                                    step_size=step_size)
    return _pruning_order_reference(d_embs, d_masks, samples,
                                    step_size=step_size, single_pass=fast,
                                    bf16_scores=bf16_scores)


def pruning_order_shortlist(d_emb, d_mask, samples, *,
                            shortlist: int | None = None,
                            rescan_every: int | None = None,
                            bf16_scores: bool = False,
                            rescan: str = "dense"):
    """The exact shortlist path for ONE document, with pinnable knobs."""
    if rescan not in ("dense", "topk"):
        raise ValueError(f"rescan={rescan!r}: one of ('dense', 'topk')")
    if rescan == "topk" and bf16_scores:
        raise ValueError(
            "bf16_scores caches a bf16 dense score matrix and has no "
            "topk-kernel equivalent; drop it or use rescan='dense'")
    K, R = _resolve_shortlist_knobs(shortlist, rescan_every,
                                    m=d_emb.shape[0])
    out = _pruning_order_shortlist(d_emb[None], d_mask[None], samples,
                                   shortlist=K, rescan_every=R,
                                   rescan=rescan, bf16_scores=bf16_scores)
    return tuple(o[0] for o in out)


def pruning_order(d_emb, d_mask, samples, *, step_size: int = 1,
                  single_pass: bool = False, bf16_scores: bool = False,
                  backend: str | None = None,
                  shortlist: int | None = None,
                  rescan_every: int | None = None):
    """Alg. 1 for ONE document (m, dim): ``(rank, err_at_removal,
    order)``; see :func:`pruning_order_batch`.  ``single_pass`` and
    ``bf16_scores`` name reference-path variants (with no ``backend``
    they select ``reference``; ``fused`` raises on them).  ``shortlist``
    / ``rescan_every`` pin the shortlist schedule on the shortlist
    backends."""
    if backend is None and (single_pass or bf16_scores):
        backend = backend_lib.REFERENCE
    allow = (backend_lib.PRUNING if step_size == 1
             else (backend_lib.REFERENCE, backend_lib.FUSED))
    backend = backend_lib.resolve_backend(backend, allow=allow,
                                          device=d_emb.device)
    if backend in (backend_lib.SHORTLIST, backend_lib.SHORTLIST_TOPK):
        return pruning_order_shortlist(
            d_emb, d_mask, samples, shortlist=shortlist,
            rescan_every=rescan_every, bf16_scores=bf16_scores,
            rescan="topk" if backend == backend_lib.SHORTLIST_TOPK
            else "dense")
    if backend == backend_lib.FUSED and (single_pass or bf16_scores):
        raise ValueError(
            "single_pass/bf16_scores are reference-path knobs and have no "
            "fused-kernel equivalent; drop them or pass "
            "backend='reference'")
    out = pruning_order_batch(d_emb[None], d_mask[None], samples,
                              step_size=step_size, fast=single_pass,
                              bf16_scores=bf16_scores, backend=backend)
    return tuple(o[0] for o in out)


def keep_mask_from_order(rank, d_mask, n_keep):
    """Keep the ``n_keep`` last-removed real tokens of each document
    (``n_keep`` an int or one count per document)."""
    if torch.is_tensor(n_keep) and n_keep.dim():
        n_keep = n_keep[..., None]
    n_prune = (d_mask.sum(-1, keepdim=True) - n_keep).clamp_min(0)
    return d_mask & (rank >= n_prune)


def prune_to_size(d_emb, d_mask, samples, target: int, *,
                  step_size: int = 1, backend: str | None = None):
    """Alg. 1 entry point: the keep mask of exactly min(target, n_real)
    tokens of one document."""
    rank, _, _ = pruning_order(d_emb, d_mask, samples, step_size=step_size,
                               backend=backend)
    return keep_mask_from_order(rank, d_mask, target)


def _monotone_merge_errs(ranks, errs, d_masks):
    """Per-document merge keys for global pruning (§4.2): each doc's
    err-at-removal sequence is running-maxed along its own removal
    order; dead and surviving slots get +inf."""
    n_docs, m = ranks.shape
    finite = torch.isfinite(errs)
    safe_rank = ranks.clamp(max=m).long()
    step_err = torch.full((n_docs, m + 1), torch.inf, dtype=errs.dtype,
                          device=errs.device)
    step_err.scatter_(1, safe_rank, torch.where(finite, errs, torch.inf))
    step_err = torch.cummax(step_err, dim=1).values
    mono = step_err.gather(1, safe_rank)
    return torch.where(d_masks & finite, mono, torch.inf)


def _prune_budget(n_total: int, keep_fraction: float) -> int:
    """Tokens to prune: ``n_total - ceil(keep_fraction * n_total)``, the
    product and ceil in fp32 as the reference computes them."""
    n_keep = int(np.ceil(np.float32(keep_fraction) * np.float32(n_total)))
    return max(n_total - n_keep, 0)


_F32_INF_BITS = 0x7F800000   # +inf: the top of the nonnegative bit order


def _order_keys(mono):
    """int64 keys that order as the fp32 merge keys do: a nonnegative
    float's IEEE bits (-0.0 taken as +0.0, +inf on top), a negative
    float below every nonnegative one in its own order."""
    b = torch.where(mono == 0, 0.0, mono).view(torch.int32).long()
    return torch.where(b < 0, -(b & 0x7FFFFFFF) - 1, b)


def _global_keep_masks_sharded(ranks, errs, d_masks, keep_fraction, *,
                               devices):
    """§4.2 over contiguous doc shards on ``devices`` (the reference's
    ``shard_map`` merge): each shard monotonizes its docs' keys on its
    device; the budget cut is the n_prune-th smallest key, found by a
    bitwise binary search over the keys' integer order, each step one
    count a shard summed over shards (the reference's scalar psum);
    ties at the threshold prune in global flat order, each shard taking
    its first ``clip(r - ties before it, 0, its ties)``.  Equal to
    :func:`global_keep_masks`' flat sort bit for bit."""
    n_docs = ranks.shape[0]
    per = -(-n_docs // len(devices))
    bounds = [(a, min(a + per, n_docs)) for a in range(0, n_docs, per)]
    keys, masks = [], []
    for (a, b), dev in zip(bounds, devices):
        dm = d_masks[a:b].to(dev)
        mono = _monotone_merge_errs(ranks[a:b].to(dev), errs[a:b].to(dev),
                                    dm)
        keys.append(_order_keys(mono.float()).reshape(-1))
        masks.append(dm)

    def total(counts):          # launched on every device, then summed
        return sum(int(c) for c in counts)

    n_prune = _prune_budget(total(m.sum() for m in masks), keep_fraction)
    lo, hi = -2 ** 31, _F32_INF_BITS
    while lo < hi:
        mid = (lo + hi) // 2
        if total([(k <= mid).sum() for k in keys]) >= n_prune:
            hi = mid
        else:
            lo = mid + 1
    r = n_prune - total([(k < lo).sum() for k in keys])  # ties to prune
    eq = [k == lo for k in keys]
    ties = [int(e.sum()) for e in eq]
    out, before = [], 0
    for k, e, dm, n_eq in zip(keys, eq, masks, ties):
        take = min(max(r - before, 0), n_eq)
        before += n_eq
        pruned = (k < lo) | (e & (torch.cumsum(e, 0) <= take))
        out.append((dm & ~pruned.reshape(dm.shape)).to(d_masks.device))
    return torch.cat(out)


def global_keep_masks(ranks, errs, d_masks, keep_fraction: float, *,
                      sharded: bool | None = None):
    """Corpus-level pruning (§4.2 "Global Pruning"): the corpus's
    cheapest removals, by monotone merge key, are applied until the
    token budget ``ceil(keep_fraction * n_total)`` is met; equal keys
    prune in flat (doc, token) order, as the reference's stable argsort
    does.  Every document keeps >= 1 token.  (n_docs, m) -> keep masks.

    ``sharded`` selects the distributed merge over the ``data`` axis of
    the active rules' mesh (:func:`_global_keep_masks_sharded`; the
    policy of ``sharding.data_mesh_for``): ``None`` shards where such a
    mesh is active, ``True`` requires one; the masks are equal bit for
    bit either way."""
    mesh = data_mesh_for(sharded, who="global_keep_masks")
    if mesh is not None:
        return _global_keep_masks_sharded(
            ranks, errs, d_masks, keep_fraction,
            devices=mesh.devices_along(("data",)))
    n_docs, m = ranks.shape
    mono = _monotone_merge_errs(ranks, errs, d_masks)
    n_prune = _prune_budget(int(d_masks.sum()), keep_fraction)
    flat = mono.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    pruned = torch.zeros_like(flat, dtype=torch.bool)
    pruned[order[:n_prune]] = True
    return d_masks & ~pruned.reshape(n_docs, m)


def mean_error(d_emb, d_mask, keep_mask, samples, *,
               ball_normalized: bool = False):
    """ME of a pruned document: E_q[max_D q.d - max_keep q.d] over the
    sphere sample set (Eq. 8 aggregated over the pruned set); with
    ``ball_normalized`` the Eq. 7 factor 1/2 converts it to the ball
    measure.  ``d_emb`` (m, dim) or a batch (B, m, dim): one ME per
    document."""
    s = doc_scores(samples, d_emb)
    s_all = torch.where(d_mask[..., None, :], s, NEG_INF)
    s_keep = torch.where((d_mask & keep_mask)[..., None, :], s, NEG_INF)
    me = (s_all.amax(-1) - s_keep.amax(-1)).mean(-1)
    return 0.5 * me if ball_normalized else me


def mean_error_batch(d_embs, d_masks, keep_masks, samples, **kw):
    """:func:`mean_error` of every document of a batch: (B,)."""
    return mean_error(d_embs, d_masks, keep_masks, samples, **kw)


# Elements of the transient (docs, beam, N, m) score tensor per doc chunk
# of the beam search.
_BEAM_BUDGET = 1 << 28


def beam_pruning_order(d_emb, d_mask, samples, *, beam: int = 3,
                       target: int = 1):
    """Beam search over removal sequences (§6.2, ablation only): the
    (keep_mask, total_err) of the best beam at |D'| = target.  Each step
    expands every beam by each alive token's Eq. 8 error and keeps the
    ``beam`` cheapest (beam, token) pairs, lowest flat index first on
    ties (``lax.top_k``'s order).  ``d_emb`` (m, dim), or a batch
    (B, m, dim) searched doc by doc in one loop of steps."""
    if d_emb.dim() == 2:
        keep, err = beam_pruning_order(d_emb[None], d_mask[None], samples,
                                       beam=beam, target=target)
        return keep[0], err[0]
    B, m, _ = d_emb.shape
    step = max(1, _BEAM_BUDGET // max(beam * samples.shape[0] * m, 1))
    out = [_beam_chunk(d_emb[c:c + step], d_mask[c:c + step], samples,
                       beam, target) for c in range(0, B, step)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def _beam_chunk(d_emb, d_mask, samples, beam, target):
    B, m, _ = d_emb.shape
    n = samples.shape[0]
    dev = d_emb.device
    scores = torch.where(d_mask[:, None, :],
                         doc_scores(samples, d_emb), NEG_INF)
    alive = d_mask[:, None, :].expand(B, beam, m).clone()
    cum = torch.full((B, beam), torch.inf, device=dev)
    cum[:, 0] = 0.0                    # only beam 0 is live at the start
    rows = torch.arange(B, device=dev)[:, None]
    for _ in range(m - max(target, 1)):
        errs = token_errors(top2_from_scores(scores[:, None], alive), alive,
                            n)                                # (B, beam, m)
        n_alive = alive.sum(-1, keepdim=True)
        cand = torch.where((n_alive > target) & alive, errs, torch.inf)
        flat = (cum[..., None] + cand).reshape(B, beam * m)
        vals, flat_ix = torch.sort(flat, dim=-1, stable=True)
        vals, flat_ix = vals[:, :beam], flat_ix[:, :beam]
        new_alive = alive[rows, flat_ix // m]                 # (B, beam, m)
        new_alive.scatter_(-1, (flat_ix % m)[..., None], False)
        # no finite candidate (already at target): keep the old beam
        live = torch.isfinite(vals)
        alive = torch.where(live[..., None], new_alive, alive)
        cum = torch.where(live, vals, cum)
    best = cum.argmin(-1)
    return alive[rows[:, 0], best], cum[rows[:, 0], best]
