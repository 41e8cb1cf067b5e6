"""Length-bucketed corpus pruning pipeline (offline Alg. 1 at scale).

Counterpart of ``repro.core.pruning_pipeline`` (single device).
Documents are grouped by effective length into a few padded power-of-two
width buckets (:func:`bucket_plan`, host-side: the plan is
data-dependent); each bucket runs the selected pruning backend at its
own width, as one batch, so a 32-token document pays for 31 steps over
32-token rows instead of ``m - 1`` steps over ``m``-token rows.  A
document's order depends only on its own real tokens, so the assembled
ranks and orders equal the unbucketed ``pruning_order_batch``'s; errors
agree to fp32 rounding (the Eq. 8 one-hot product's summation order
depends on the bucket width).
Buckets are enqueued back to back; nothing syncs the host between them.
Under a mesh with a ``data`` axis (``sharded=``), each bucket's docs
split over its devices (:func:`_bucket_order_sharded`).
:func:`pool_tokens` (near-duplicate token pooling after pruning) runs on
the host in numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import voronoi
from repro_torch.core.tuning import _pow2_at_least
from repro_torch.sharding.specs import data_mesh_for

__all__ = [
    "Bucket",
    "bucket_plan",
    "effective_lengths",
    "pool_tokens",
    "prune_corpus",
    "pruning_order_bucketed",
]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One padded shape bucket: ``indices`` into the corpus doc axis,
    all with real length <= ``width``."""

    width: int
    indices: np.ndarray

    def __repr__(self):
        return f"Bucket(width={self.width}, n_docs={len(self.indices)})"


def effective_lengths(d_masks) -> np.ndarray:
    """Per-document last alive position + 1 (0 when fully masked) — what
    bucket widths must cover, for prefix or scattered masks alike."""
    masks = (d_masks.cpu().numpy() if isinstance(d_masks, torch.Tensor)
             else np.asarray(d_masks))
    m = masks.shape[1]
    last = m - np.argmax(masks[:, ::-1], axis=1)
    return np.where(masks.any(axis=1), last, 0).astype(np.int64)


def bucket_plan(n_real, m: int, *, granularity: int | str = "pow2",
                min_width: int = 8) -> list[Bucket]:
    """Group documents into padded width buckets: each length rounds up
    to the next power of two (``"pow2"``) or multiple of an int, clamped
    to [min_width, m]; buckets ascend by width and every document lands
    in exactly one."""
    n_real = np.asarray(n_real)
    if n_real.ndim != 1:
        raise ValueError(f"n_real must be 1-D, got shape {n_real.shape}")
    if granularity == "pow2":
        width_of = _pow2_at_least
    elif isinstance(granularity, int) and granularity >= 1:
        width_of = lambda x: -(-x // granularity) * granularity
    else:
        raise ValueError(f"granularity={granularity!r}: 'pow2' or int >= 1")
    widths = np.array([min(m, max(min_width, width_of(max(int(x), 1))))
                       for x in n_real], np.int64)
    return [Bucket(width=int(w), indices=np.flatnonzero(widths == w))
            for w in np.unique(widths)]


def _order_len(width: int, step_size: int) -> int:
    return -(-(width - 1) // step_size) * step_size


def _bucket_order_sharded(e, k, samples, devices, **kw):
    """One bucket's pruning orders over contiguous doc shards on
    ``devices`` (the reference's ``shard_map`` over ``data``): every
    shard runs the normal batch path on its slice on its device (all
    launched before any result is read back), and the outputs return to
    ``e``'s device.  Per-document pruning touches no other document, so
    this equals the unsharded batch bit for bit.  The tuner is warmed
    for every shard's shape first, so a measured race never runs while
    other shards' work is in flight."""
    n_b = e.shape[0]
    per = -(-n_b // len(devices))
    if voronoi.resolve_pruning_backend(
            kw["backend"], shortlist=kw["shortlist"], fast=kw["fast"],
            bf16_scores=kw["bf16_scores"], step_size=kw["step_size"],
            device=devices[0]) != backend_lib.REFERENCE:
        for a, dev in zip(range(0, n_b, per), devices):
            backend_lib.tuned("pruning", device=dev,
                              n_samples=samples.shape[0], m=e.shape[1],
                              dim=e.shape[-1], n_docs=min(per, n_b - a))
    outs = []
    for a, dev in zip(range(0, n_b, per), devices):
        outs.append(voronoi.pruning_order_batch(
            e[a:a + per].to(dev), k[a:a + per].to(dev),
            samples.to(dev), **kw))
    return tuple(torch.cat([o[i].to(e.device) for o in outs])
                 for i in range(3))


def pruning_order_bucketed(d_embs, d_masks, samples, *, step_size: int = 1,
                           fast: bool = False, bf16_scores: bool = False,
                           shortlist: bool = False,
                           backend: str | None = None,
                           granularity: int | str = "pow2",
                           min_width: int = 8,
                           sharded: bool | None = None):
    """Length-bucketed equivalent of ``voronoi.pruning_order_batch``
    (the same backend knobs): the same (ranks, errs, orders), with
    bucket-local "never removed" sentinels (rank == width) translated to
    the corpus-global ``m``.  ``sharded`` splits each bucket's docs over
    the ``data`` axis of the active rules' mesh
    (``sharding.data_mesh_for``'s policy: ``None`` where one is active,
    ``True`` requires one); the result is the same bit for bit."""
    n_docs, m = d_masks.shape
    dev = d_embs.device
    ranks = torch.full((n_docs, m), m, dtype=torch.int32, device=dev)
    errs = torch.full((n_docs, m), torch.inf, device=dev)
    orders = torch.full((n_docs, _order_len(m, step_size)), -1,
                        dtype=torch.int32, device=dev)
    if n_docs == 0:
        return ranks, errs, orders
    mesh = data_mesh_for(sharded, who="pruning_order_bucketed")
    plan = bucket_plan(effective_lengths(d_masks), m,
                       granularity=granularity, min_width=min_width)
    kw = dict(step_size=step_size, fast=fast, bf16_scores=bf16_scores,
              shortlist=shortlist, backend=backend)
    for bucket in plan:
        w = bucket.width
        idx = torch.as_tensor(bucket.indices, device=dev)
        e = d_embs[idx, :w].contiguous()
        k = d_masks[idx, :w].contiguous()
        if mesh is not None:
            r, er, o = _bucket_order_sharded(
                e, k, samples, mesh.devices_along(("data",)), **kw)
        else:
            r, er, o = voronoi.pruning_order_batch(e, k, samples, **kw)
        ranks[idx, :w] = torch.where(r >= w, m, r).to(torch.int32)
        errs[idx, :w] = er
        orders[idx, :o.shape[1]] = o
    return ranks, errs, orders


def pool_tokens(d_embs, keep, threshold: float):
    """Greedy within-document token pooling (Clavie-style): each
    unclaimed kept token, in original order, opens a pool, absorbs every
    later unclaimed kept token whose cosine similarity to it reaches
    ``threshold``, and its slot takes the pool mean; absorbed slots
    leave ``keep``.  Host-side (which tokens merge is data-dependent).
    Takes numpy arrays or tensors; returns ``(pooled_embs (n_docs, m,
    dim) f32, new_keep (n_docs, m) bool)`` as numpy, with slots outside
    ``new_keep`` zeroed."""
    if not 0.0 < threshold <= 1.0:
        raise ValueError(f"threshold must be in (0, 1], got {threshold}")
    if isinstance(d_embs, torch.Tensor):
        d_embs = d_embs.detach().float().cpu().numpy()
    if isinstance(keep, torch.Tensor):
        keep = keep.cpu().numpy()
    embs = np.array(d_embs, np.float32)
    kp = np.array(keep, bool)
    for i in range(kp.shape[0]):
        idx = np.flatnonzero(kp[i])
        if idx.size < 2:
            continue
        e = embs[i, idx]
        nrm = np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)
        cos = (e / nrm) @ (e / nrm).T
        claimed = np.zeros(idx.size, bool)
        for a in range(idx.size):
            if claimed[a]:
                continue
            absorbed = np.flatnonzero(~claimed & (cos[a] >= threshold))
            absorbed = absorbed[absorbed > a]   # the seed joins regardless
            pool = np.concatenate([[a], absorbed])
            claimed[pool] = True
            embs[i, idx[a]] = e[pool].mean(0)
            kp[i, idx[absorbed]] = False
    embs[~kp] = 0.0
    return embs, kp


def prune_corpus(d_embs, d_masks, samples, keep_fraction: float, *,
                 backend: str | None = None, step_size: int = 1,
                 granularity: int | str = "pow2", min_width: int = 8,
                 sharded: bool | None = None):
    """Corpus-level pruning end to end: bucketed per-doc orders merged
    into global keep masks (§4.2) under a corpus-wide token budget.
    Returns (keep_masks (n_docs, m), ranks, errs).  ``sharded``
    distributes both halves over the ``data`` mesh axis with one policy
    (see :func:`pruning_order_bucketed`); the result is the same bit for
    bit."""
    ranks, errs, _ = pruning_order_bucketed(
        d_embs, d_masks, samples, backend=backend, step_size=step_size,
        granularity=granularity, min_width=min_width, sharded=sharded)
    keep = voronoi.global_keep_masks(ranks, errs, d_masks, keep_fraction,
                                     sharded=sharded)
    return keep, ranks, errs
