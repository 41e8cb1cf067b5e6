"""Voronoi-as-IVF candidate routing: centroid-scored bucket pruning.

Counterpart of ``repro.serve.routing`` on one device.  Each
:class:`~repro_torch.serve.index.PackedIndex` capacity bucket is
summarized by ``n_centroids`` Lloyd's centroids of its kept tokens plus
its max residual norm ``r_b = max_x ||x - c(x)||``.  The table is laid
out as one doc-array shape — ``(n_buckets, n_centroids, dim)`` plus a
centroid mask — so :func:`centroid_scores` scores it through the
ordinary serving scorer (the ``colbert_maxsim_multi`` kernel on
``fused``) in one pass.  Two routed modes consume it
(``topk_search(route=...)``):

* ``"nprobe"`` keeps each query's ``n_probe`` best centroid-scoring
  buckets (optionally trimmed by a score gap ``threshold``);
* ``"bounded"`` scores seed buckets exactly, takes each query's k-th
  seed score as the bar ``tau`` and keeps every bucket whose
  Cauchy-Schwarz upper bound ``U_b = S_b + r_b * sum_t ||q_t||`` can
  still reach it — the routed top-k equals the exhaustive one.

The same Lloyd's run is the residual codec's codebook
(:func:`bucket_codebook`).  Its init draws seeded priorities from a
``torch.Generator`` (:func:`_init_indices`); the reference draws them
from ``jax.random``, which torch cannot reproduce, so the two packages
agree on everything after the init (the parity tests inject the
reference's init points).  A table persists as a sidecar beside the
index epoch it was built from (``serve.index_io.save_routing``) through
:meth:`RoutingIndex.body_tree`, :meth:`~RoutingIndex.meta` and
:meth:`~RoutingIndex.from_parts`, in the reference's layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.tuning import _pow2_at_least
from repro_torch.serve.index import PackedIndex
from repro_torch.serve.retrieval import _score_block

__all__ = ["BOUND_SLACK", "ROUTES", "RoutingIndex", "bucket_codebook",
           "centroid_scores", "check_route", "select_bounded",
           "select_nprobe"]

ROUTES = ("exhaustive", "bounded", "nprobe")

# Relative fp slack on the bounded route's U >= tau: the centroid pass
# and the document pass may round differently, and the slack only ever
# adds buckets.
BOUND_SLACK = 1e-4

# Elements of the (points, centroids, dim) difference tensor held at
# once while computing squared distances.
_DIST_CHUNK = 1 << 26


def _init_indices(mask: torch.Tensor, k: int, seed: int,
                  bucket_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's init: ``k`` distinct valid points chosen by seeded
    priorities (invalid points at -inf), highest priority first, ties
    to the lowest index.  Returns (indices (k,) int64, centroid
    validity (k,) bool: False where fewer than ``k`` points are
    valid)."""
    gen = torch.Generator(device="cpu").manual_seed(
        seed * 1_000_003 + bucket_index)
    pri = torch.rand(mask.shape, generator=gen).to(mask.device)
    pri = torch.where(mask, pri, -torch.inf)
    order = torch.sort(pri, descending=True, stable=True).indices[:k]
    return order, pri[order] > -torch.inf


def _dist2(points: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """(P, dim) x (k, dim) -> (P, k) squared distances as the reference
    writes them, ``((p - c) ** 2).sum(-1)`` (the expanded form rounds
    differently and flips near-ties), in chunks of points."""
    rows = max(1, _DIST_CHUNK // max(cent.numel(), 1))
    return torch.cat([((points[a:a + rows, None, :] - cent[None]) ** 2)
                      .sum(-1) for a in range(0, points.shape[0], rows)]
                     or [points.new_zeros((0, cent.shape[0]))])


def _lloyd(points, mask, k: int, iters: int, seed: int, bucket_index: int):
    """One bucket's k-means split of ``points`` (P, dim) with validity
    ``mask`` (P,): pad rows take part in no statistic; an empty cluster
    keeps its centroid; surplus centroids (fewer valid points than
    ``k``) are invalid.  Returns (centroids (k, dim), centroid mask
    (k,), max residual norm to the nearest valid centroid over valid
    points — 0 for an empty bucket)."""
    init_idx, cmask = _init_indices(mask, k, seed, bucket_index)
    cent = points[init_idx]
    ids = torch.arange(k, device=points.device)

    def d2(c):
        return torch.where(cmask[None, :], _dist2(points, c), torch.inf)

    for _ in range(iters):
        assign = d2(cent).argmin(dim=1)
        onehot = (assign[:, None] == ids[None, :]) & mask[:, None]
        counts = onehot.sum(0)
        sums = onehot.to(points.dtype).T @ points
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp_min(1)[:, None], cent)
    nearest = torch.where(mask, d2(cent).amin(dim=1), 0.0)
    nearest = torch.where(torch.isfinite(nearest), nearest, 0.0)
    radius = nearest.max().clamp_min(0.0).sqrt()
    return cent, cmask, radius


def _bucket_lloyd(embs, mask, n_centroids: int, iters: int, seed: int,
                  bucket_index: int):
    """Lloyd's over one bucket's kept tokens, padded to a power of two
    as the reference pads them (the init draws over the padded
    shape)."""
    dim = embs.shape[-1]
    embs = embs.reshape(-1, dim).float()
    mask = mask.reshape(-1).bool()
    kept = int(mask.sum())
    pad = max(_pow2_at_least(max(kept, n_centroids, 1)), n_centroids)
    pts = embs.new_zeros((pad, dim))
    pm = torch.zeros((pad,), dtype=torch.bool, device=embs.device)
    if kept:
        pts[:kept] = embs[mask]
        pm[:kept] = True
    return _lloyd(pts, pm, n_centroids, iters, seed, bucket_index)


def bucket_codebook(embs, mask, n_centroids: int, *, iters: int = 8,
                    seed: int = 0, bucket_index: int = 0):
    """One bucket's Lloyd's centroids, the seeded split
    :meth:`RoutingIndex.build` runs, reused as the residual codec's
    codebook.  ``embs`` (n_slots, dim) with validity ``mask``.  Returns
    ``(centroids (k, dim) f32, validity (k,) bool)`` on ``embs``'
    device; invalid rows are zero."""
    c, cm, _ = _bucket_lloyd(embs, mask, n_centroids, iters, seed,
                             bucket_index)
    return torch.where(cm[:, None], c, 0.0), cm


@dataclasses.dataclass(frozen=True)
class RoutingIndex:
    """Per-bucket centroid tables and residual radii for one
    :class:`PackedIndex` epoch: ``centroids`` (n_buckets, n_centroids,
    dim) and ``cmask`` (n_buckets, n_centroids) form one doc-array
    shape; ``radius`` (n_buckets,) feeds the bounded route's bound.
    ``epoch`` pins the table to the index epoch it was built from."""

    n_centroids: int
    iters: int
    seed: int
    epoch: int
    centroids: torch.Tensor
    cmask: torch.Tensor
    radius: torch.Tensor

    @property
    def n_buckets(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[-1]

    @classmethod
    def build(cls, index: PackedIndex, *, n_centroids: int = 4,
              iters: int = 8, seed: int = 0) -> "RoutingIndex":
        """K-means-split every capacity bucket's kept tokens (decoded
        for a compressed index), on the index's device."""
        if not isinstance(index, PackedIndex):
            raise TypeError(
                "RoutingIndex.build needs a PackedIndex (candidate "
                "routing prunes capacity buckets; pack the corpus "
                "first)")
        if n_centroids < 1:
            raise ValueError(f"n_centroids must be >= 1, got {n_centroids}")
        out = [_bucket_lloyd(b.dense_embs(index.dim), b.masks, n_centroids,
                             iters, seed, bi)
               for bi, b in enumerate(index.buckets)]
        dev = index.device
        if out:
            centroids, cmask, radius = (torch.stack(t) for t in zip(*out))
        else:
            centroids = torch.zeros((0, n_centroids, index.dim), device=dev)
            cmask = torch.zeros((0, n_centroids), dtype=torch.bool,
                                device=dev)
            radius = torch.zeros((0,), device=dev)
        return cls(n_centroids=n_centroids, iters=iters, seed=seed,
                   epoch=index.epoch, centroids=centroids.contiguous(),
                   cmask=cmask.contiguous(), radius=radius)

    def validate_for(self, index) -> "RoutingIndex":
        """Refuse to route an index this table was not built for."""
        if not isinstance(index, PackedIndex):
            raise ValueError(
                "candidate routing needs a PackedIndex (the dense "
                "TokenIndex has no capacity buckets to prune)")
        if self.n_buckets != len(index.buckets):
            raise ValueError(
                f"routing table covers {self.n_buckets} buckets, the "
                f"index has {len(index.buckets)} — rebuild the table "
                "(RoutingIndex.build) for this index")
        if self.epoch != index.epoch:
            raise ValueError(
                f"routing table was built for epoch {self.epoch}, the "
                f"index is at epoch {index.epoch} — a stale table "
                "could hide live documents; rebuild it (the Compactor "
                "rebuilds the sidecar per epoch)")
        return self

    # -- persistence glue (serve.index_io sidecar) ---------------------

    def body_tree(self) -> dict:
        """The tree the checkpoint layer serializes."""
        return {"centroids": self.centroids, "cmask": self.cmask,
                "radius": self.radius}

    def meta(self) -> dict:
        return {"n_centroids": self.n_centroids, "iters": self.iters,
                "seed": self.seed, "epoch": self.epoch,
                "n_buckets": self.n_buckets, "dim": self.dim}

    @classmethod
    def from_parts(cls, meta: dict, tree: dict,
                   device=None) -> "RoutingIndex":
        """A table from a sidecar's manifest and restored tree, its
        tensors on ``device`` (where they are, when None)."""
        return cls(n_centroids=int(meta["n_centroids"]),
                   iters=int(meta["iters"]), seed=int(meta["seed"]),
                   epoch=int(meta["epoch"]),
                   centroids=tree["centroids"].to(
                       device=device, dtype=torch.float32).contiguous(),
                   cmask=tree["cmask"].to(
                       device=device, dtype=torch.bool).contiguous(),
                   radius=tree["radius"].to(device=device,
                                            dtype=torch.float32))


def check_route(route: str, routing, index, n_probe) -> None:
    """Raise unless ``route`` can serve ``index``: a known route, and
    for a routed one a table built for this index epoch and ``n_probe``
    None or >= 1."""
    if route not in ROUTES:
        raise ValueError(f"route={route!r} not in {ROUTES}")
    if route == "exhaustive":
        return
    if routing is None:
        raise ValueError(f"route={route!r} needs a routing table — build "
                         "one with serve.routing.RoutingIndex.build(index)")
    routing.validate_for(index)
    if n_probe is not None and n_probe < 1:
        raise ValueError(f"n_probe must be >= 1, got {n_probe}")


def centroid_scores(routing: RoutingIndex, q_embs, q_masks=None, *,
                    backend: str | None = None,
                    block_docs: int | None = None):
    """``(S, U)``, each (n_q, n_buckets): ``S`` the centroid MaxSim (the
    table scored like any bucket, one ``colbert_maxsim_multi`` launch
    on ``fused``, its doc block from the routing-keyed tuner entry
    unless given), ``U = S + radius * sum_t ||q_t||`` the bounded
    route's upper bound (masked query tokens add 0 to both)."""
    backend = backend_lib.resolve_backend(backend, allow=backend_lib.SERVING,
                                          device=q_embs.device)
    if backend == backend_lib.FUSED:
        block_docs = backend_lib.tuned_routing_blocks(
            q_embs.shape[0], routing.n_buckets, routing.n_centroids,
            q_embs.shape[1], routing.dim, block_docs=block_docs,
            device=q_embs.device)
    s = _score_block(routing.centroids, routing.cmask, q_embs, q_masks,
                     backend=backend, block_docs=block_docs)
    qn = torch.linalg.vector_norm(q_embs, dim=-1)
    if q_masks is not None:
        qn = torch.where(q_masks, qn, 0.0)
    return s, s + qn.sum(-1, keepdim=True) * routing.radius[None, :]


def select_nprobe(scores, n_probe: int, threshold: float | None = None):
    """Each query's ``n_probe`` best buckets from host centroid scores
    (n_q, n_buckets), ties to the lowest bucket; ``threshold`` also
    drops buckets more than that gap below the query's best.  Returns
    (ascending tuple of the union's bucket ids, per-query keep mask)."""
    scores = np.asarray(scores)
    n_q, n_buckets = scores.shape
    if n_probe < 1:
        raise ValueError(f"n_probe must be >= 1, got {n_probe}")
    n_probe = min(n_probe, n_buckets)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :n_probe]
    keep = np.zeros_like(scores, bool)
    np.put_along_axis(keep, order, True, axis=1)
    if threshold is not None:
        best = scores.max(axis=1, keepdims=True)
        keep &= scores >= best - float(threshold)
    return tuple(int(b) for b in np.flatnonzero(keep.any(axis=0))), keep


def select_bounded(bounds, tau, seeds=()):
    """Every bucket whose upper bound can still reach some query's k-th
    best seed score ``tau`` (-inf: the seeds held fewer than k docs),
    plus the ``seeds``; the fp slack only widens the set."""
    bounds = np.asarray(bounds)
    tau = np.asarray(tau).reshape(-1, 1)
    slack = np.where(np.isfinite(tau), BOUND_SLACK * (1.0 + np.abs(tau)),
                     0.0)
    bar = np.where(np.isfinite(tau), tau - slack, tau)
    keep = (bounds >= bar).any(axis=0)
    return tuple(sorted(set(int(b) for b in np.flatnonzero(keep))
                        | set(seeds)))
