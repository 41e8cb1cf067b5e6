"""Voronoi pruning — the paper's core contribution (§4, Alg. 1).

Counterpart of ``repro.core.voronoi``:

* ``V_i = {q : d_i = argmax_d q.d}`` (Eq. 5) — the cell of token i;
* ``Error(d_i) = E_{q in V_i}[q.d_i - second_best(q)]`` (Eq. 6-8),
  estimated over N unit-sphere samples;
* greedy removal with incremental cell reassignment (Alg. 1);
* corpus-level pruning by merging per-document orders (§4.2).

Batching: the reference runs ``m - 1`` greedy steps as a ``lax.scan``
vmapped over documents.  Here the document axis is a batch dimension
written out: every function below takes a bucket (B, m, dim) and runs a
Python loop over steps in which each step is a few launches for the
whole bucket — never one launch per document, and no host sync inside
the loop.

Determinism: the Eq. 8 accumulation (a segment sum of gaps by cell) is
a one-hot batched product, as the reference's shortlist path writes it
(``voronoi.py:418-419``), not ``index_add_``: atomics sum in an order
that changes from run to run on the card, and the greedy argmin over
errors would then flip on near-ties from one run to the next.
"""

from __future__ import annotations

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.scoring import NEG_INF, top2_from_scores
from repro_torch.kernels.maxsim_top2.ops import (maxsim_top2_op,
                                                 maxsim_top2_update_op)
from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index

__all__ = [
    "estimate_errors",
    "global_keep_masks",
    "keep_mask_from_order",
    "pruning_order",
    "pruning_order_batch",
    "pruning_order_shortlist",
    "resolve_pruning_backend",
    "token_errors",
]

# Elements of the transient (docs, N, m) one-hot per accumulation chunk.
_ONEHOT_BUDGET = 1 << 28


def _cell_sums(gap, bi, m: int):
    """sum_n gap[b, n] * [bi[b, n] == t] -> (B, m), as a one-hot batched
    product in doc chunks (deterministic; see module docstring)."""
    B, n = gap.shape
    tok = torch.arange(m, device=gap.device, dtype=bi.dtype)
    step = max(1, _ONEHOT_BUDGET // max(n * m, 1))
    out = []
    for c in range(0, B, step):
        onehot = (bi[c:c + step, :, None] == tok).to(gap.dtype)
        out.append(torch.bmm(gap[c:c + step, None, :], onehot)[:, 0])
    return torch.cat(out) if out else gap.new_zeros((0, m))


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


def estimate_errors(d_emb, d_mask, samples):
    """One-shot (non-iterative) Monte-Carlo error estimate per token."""
    state = top2_from_scores(samples @ d_emb.transpose(-1, -2), d_mask)
    return token_errors(state, d_mask, samples.shape[0])


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


def _pruning_order_reference(d_embs, d_masks, samples, *, step_size):
    """Materializing path: the (B, N, m) score tensor is computed once;
    each step re-reduces it under the new alive mask and keeps the old
    cell state for samples whose best and second survived."""
    scores = samples @ d_embs.transpose(-1, -2)
    scores = torch.where(d_masks[:, None, :], scores, NEG_INF)

    def rescan(alive, state, removed_any):
        fresh = top2_from_scores(scores, alive)
        affected = ((~alive.gather(-1, state[2].long())
                     | ~alive.gather(-1, state[3].long()))
                    & removed_any[:, None])
        return tuple(torch.where(affected, f, s)
                     for f, s in zip(fresh, state))

    state = top2_from_scores(scores, d_masks)
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
                             rescan_every, rescan):
    """Exact top-K shortlist pruning over a bucket.  Each sample keeps
    its top-K alive tokens from the last rescan; between rescans at most
    ``rescan_every - 1`` tokens die, so the true top-2 of the alive set
    stays inside the shortlist (K >= R + 1).  ``rescan="dense"`` caches
    the (B, N, m) score tensor and rescans it with a stable sort;
    ``rescan="topk"`` rescans through the ``maxsim_topk`` kernel."""
    B, m = d_masks.shape
    n = samples.shape[0]
    K, R = min(shortlist, m), rescan_every
    dev = d_embs.device
    if rescan == "dense":
        scores = torch.where(d_masks[:, None, :],
                             samples @ d_embs.transpose(-1, -2), NEG_INF)

        def rescan_fn(alive):
            return topk_lowest_index(
                torch.where(alive[:, None, :], scores, NEG_INF), K)
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


def resolve_pruning_backend(backend: str | None, *, step_size: int = 1,
                            device="cuda") -> str:
    """The batch entry's backend policy: the per-``step_size`` allow set
    (shortlist paths remove one token per step), then the platform
    default of ``device``."""
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
                        backend: str | None = None, bucketed: bool = False):
    """Alg. 1 over a document batch: ``(ranks, errs, orders)``, (B, m),
    (B, m), (B, n_steps * step_size).  ``rank[i]`` is token i's removal
    step (m for never removed), ``err[i]`` its Eq. 8 error when removed
    (+inf otherwise), ``order[s]`` the token removed at step s (-1 for
    none).  ``bucketed=True`` routes through the length-bucketed
    pipeline (``core.pruning_pipeline``): the same ranks and orders,
    errors equal to fp32 rounding."""
    if bucketed:
        from repro_torch.core import pruning_pipeline
        return pruning_pipeline.pruning_order_bucketed(
            d_embs, d_masks, samples, step_size=step_size, backend=backend)
    _check_bucket(d_embs, d_masks, samples)
    backend = resolve_pruning_backend(backend, step_size=step_size,
                                      device=d_embs.device)
    if backend in (backend_lib.SHORTLIST, backend_lib.SHORTLIST_TOPK):
        K, R = _resolve_shortlist_knobs(None, None, m=d_masks.shape[1])
        return _pruning_order_shortlist(
            d_embs, d_masks, samples, shortlist=K, rescan_every=R,
            rescan="topk" if backend == backend_lib.SHORTLIST_TOPK
            else "dense")
    if backend == backend_lib.FUSED:
        return _pruning_order_fused(d_embs, d_masks, samples,
                                    step_size=step_size)
    return _pruning_order_reference(d_embs, d_masks, samples,
                                    step_size=step_size)


def pruning_order_shortlist(d_emb, d_mask, samples, *,
                            shortlist: int | None = None,
                            rescan_every: int | None = None,
                            rescan: str = "dense"):
    """The exact shortlist path for ONE document, with pinnable knobs."""
    if rescan not in ("dense", "topk"):
        raise ValueError(f"rescan={rescan!r}: one of ('dense', 'topk')")
    K, R = _resolve_shortlist_knobs(shortlist, rescan_every,
                                    m=d_emb.shape[0])
    out = _pruning_order_shortlist(d_emb[None], d_mask[None], samples,
                                   shortlist=K, rescan_every=R,
                                   rescan=rescan)
    return tuple(o[0] for o in out)


def pruning_order(d_emb, d_mask, samples, *, step_size: int = 1,
                  backend: str | None = None,
                  shortlist: int | None = None,
                  rescan_every: int | None = None):
    """Alg. 1 for ONE document (m, dim): ``(rank, err_at_removal,
    order)``; see :func:`pruning_order_batch`.  ``shortlist`` /
    ``rescan_every`` pin the shortlist schedule on the shortlist
    backends."""
    backend = resolve_pruning_backend(backend, step_size=step_size,
                                      device=d_emb.device)
    if backend in (backend_lib.SHORTLIST, backend_lib.SHORTLIST_TOPK):
        return pruning_order_shortlist(
            d_emb, d_mask, samples, shortlist=shortlist,
            rescan_every=rescan_every,
            rescan="topk" if backend == backend_lib.SHORTLIST_TOPK
            else "dense")
    out = pruning_order_batch(d_emb[None], d_mask[None], samples,
                              step_size=step_size, backend=backend)
    return tuple(o[0] for o in out)


def keep_mask_from_order(rank, d_mask, n_keep):
    """Keep the ``n_keep`` last-removed real tokens of each document."""
    n_prune = (d_mask.sum(-1, keepdim=True) - n_keep).clamp_min(0)
    return d_mask & (rank >= n_prune)


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


def global_keep_masks(ranks, errs, d_masks, keep_fraction: float):
    """Corpus-level pruning (§4.2 "Global Pruning"): the corpus's
    cheapest removals, by monotone merge key, are applied until the
    token budget ``ceil(keep_fraction * n_total)`` is met; equal keys
    prune in flat (doc, token) order, as the reference's stable argsort
    does.  Every document keeps >= 1 token.  (n_docs, m) -> keep masks."""
    n_docs, m = ranks.shape
    mono = _monotone_merge_errs(ranks, errs, d_masks)
    n_total = d_masks.sum().to(torch.int32)
    # ceil in fp32, as the reference computes keep_fraction * n_total
    n_keep = torch.ceil(torch.tensor(keep_fraction, dtype=torch.float32,
                                     device=ranks.device)
                        * n_total.to(torch.float32)).to(torch.int32)
    n_prune = int((n_total - n_keep).clamp_min(0))
    flat = mono.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    pruned = torch.zeros_like(flat, dtype=torch.bool)
    pruned[order[:n_prune]] = True
    return d_masks & ~pruned.reshape(n_docs, m)
