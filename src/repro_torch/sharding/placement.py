"""Multi-host bucket placement for the packed serving index.

Counterpart of ``repro.sharding.placement``, copied as it is: plain
Python with ``dataclasses``, no tensors.  :class:`PlacementPlan` pins
each capacity bucket of a ``repro_torch.serve.index.PackedIndex`` to
one or more **host groups**.  In this package it is the layout contract
of the persisted artifact (``repro_torch.serve.index_io``): the
manifest records the plan, each group's buckets persist under their own
sub-manifest and body, so a group restores only the buckets placed on
it, and ``serve.mutation.Compactor`` re-splits a compacted epoch with
:meth:`PlacementPlan.rebalance_repack`.  Serving over a grid of host
groups (the reference's ``topk_search_group`` and the per-group merge
tier) is not ported yet; a placed artifact loads whole or by
``group=g`` on one device.

**Replication** (``replicas=r``): each bucket is pinned to ``r``
*distinct* groups — a replica chain, primary first.  ``rebalance``
re-places the replicas stranded on lost groups over the survivors,
preserving surviving assignments and group ids.

The plan is host-side metadata (like ``bucket_plan``) and serializes
to/from the packed-index manifest.  Replicated plans serialize as
placement format ``2`` (nested replica chains); readers refuse *newer*
formats loudly instead of misreading them — the same contract as
``index_io``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PlacementPlan", "PLACEMENT_FORMAT", "bucket_weights"]

# Manifest schema version this module writes/reads.  Format 1 is the
# flat layout ({"n_groups", "groups": [int]}); format 2 adds
# {"replicas", "groups": [[int, ...], ...]}.  Flat plans keep writing
# format-1 manifests, so readers of the flat layout keep loading them.
PLACEMENT_FORMAT = 2


def bucket_weights(index) -> list[int]:
    """Per-bucket placement weights: stored bytes for a packed index
    (duck-typed on ``buckets`` so this module never imports the serve
    layer), one unit bucket for the dense ``TokenIndex`` view."""
    buckets = getattr(index, "buckets", None)
    if buckets is None:
        return [1]
    return [max(int(b.nbytes()), 1) for b in buckets]



@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Bucket -> host-group assignment for a packed index.

    With ``replicas == 1`` (the default), ``groups[i]`` is the host
    group that owns bucket ``i`` (the i-th entry of
    ``PackedIndex.buckets``; a dense ``TokenIndex`` counts as one
    bucket).  With ``replicas == r > 1``, ``groups[i]`` is the bucket's
    replica chain — a tuple of ``r`` distinct groups, primary first.
    A group may own no buckets — the serving merge emits an
    all-sentinel candidate block for it (tested: a corpus pinned to a
    single group of a 2-group grid).
    """

    n_groups: int
    groups: tuple
    replicas: int = 1

    def __post_init__(self):
        if self.n_groups < 1:
            raise ValueError(f"n_groups={self.n_groups} < 1")
        if not 1 <= self.replicas <= self.n_groups:
            raise ValueError(
                f"replicas={self.replicas} outside [1, n_groups="
                f"{self.n_groups}] — replicas must land on distinct groups")
        if self.replicas == 1:
            # Flat layout: entries are ints (accepts length-1 chains).
            flat = []
            for g in self.groups:
                if isinstance(g, (tuple, list)):
                    if len(g) != 1:
                        raise ValueError(
                            f"replica chain {tuple(g)} has {len(g)} entries "
                            f"but replicas=1")
                    g = g[0]
                flat.append(int(g))
            object.__setattr__(self, "groups", tuple(flat))
            bad = [g for g in self.groups if not 0 <= g < self.n_groups]
            if bad:
                raise ValueError(
                    f"bucket groups {bad} outside [0, {self.n_groups})")
            return
        chains = []
        for i, gs in enumerate(self.groups):
            if not isinstance(gs, (tuple, list)):
                raise ValueError(
                    f"bucket {i}: expected a replica chain of "
                    f"{self.replicas} groups, got {gs!r}")
            chain = tuple(int(g) for g in gs)
            if len(chain) != self.replicas:
                raise ValueError(
                    f"bucket {i}: chain {chain} has {len(chain)} entries, "
                    f"plan declares replicas={self.replicas}")
            if len(set(chain)) != len(chain):
                raise ValueError(
                    f"bucket {i}: replica chain {chain} repeats a group — "
                    f"replicas must never share a group")
            bad = [g for g in chain if not 0 <= g < self.n_groups]
            if bad:
                raise ValueError(
                    f"bucket {i}: groups {bad} outside [0, {self.n_groups})")
            chains.append(chain)
        object.__setattr__(self, "groups", tuple(chains))

    # -- construction ----------------------------------------------------

    @classmethod
    def balanced(cls, weights, n_groups: int,
                 replicas: int = 1) -> "PlacementPlan":
        """Greedy LPT balance: buckets descend by weight onto the
        lightest group (ties: lowest group id; equal weights keep
        bucket order) — deterministic, so every host derives the same
        plan from the same manifest.  With ``replicas=r`` the pass runs
        ``r`` times; each pass lands every bucket on its lightest group
        *not already in the bucket's chain*, so replicas stay distinct
        and every replica level is independently bytes-balanced."""
        if not 1 <= replicas <= n_groups:
            raise ValueError(
                f"replicas={replicas} outside [1, n_groups={n_groups}]")
        order = sorted(range(len(weights)),
                       key=lambda i: (-int(weights[i]), i))
        load = [0] * n_groups
        chains: list[list[int]] = [[] for _ in weights]
        for _ in range(replicas):
            for i in order:
                g = min((j for j in range(n_groups) if j not in chains[i]),
                        key=lambda j: (load[j], j))
                chains[i].append(g)
                load[g] += int(weights[i])
        if replicas == 1:
            return cls(n_groups=n_groups,
                       groups=tuple(c[0] for c in chains))
        return cls(n_groups=n_groups, groups=tuple(map(tuple, chains)),
                   replicas=replicas)

    @classmethod
    def for_index(cls, index, n_groups: int,
                  replicas: int = 1) -> "PlacementPlan":
        """The default plan for an index: buckets balanced over groups
        by stored bytes (so host HBM/disk loads even out, not just
        bucket counts)."""
        return cls.balanced(bucket_weights(index), n_groups,
                            replicas=replicas)

    @classmethod
    def round_robin(cls, n_buckets: int, n_groups: int,
                    replicas: int = 1) -> "PlacementPlan":
        if replicas == 1:
            return cls(n_groups=n_groups,
                       groups=tuple(i % n_groups for i in range(n_buckets)))
        return cls(
            n_groups=n_groups,
            groups=tuple(tuple((i + r) % n_groups for r in range(replicas))
                         for i in range(n_buckets)),
            replicas=replicas)

    @classmethod
    def pinned(cls, n_buckets: int, n_groups: int, group: int = 0,
               replicas: int = 1) -> "PlacementPlan":
        """Every bucket on one group (the degenerate placement the
        differential harness sweeps: other groups serve pure sentinel
        candidates).  With replication the chain continues on the
        cyclically-next groups."""
        if replicas == 1:
            return cls(n_groups=n_groups, groups=(group,) * n_buckets)
        chain = tuple((group + r) % n_groups for r in range(replicas))
        return cls(n_groups=n_groups, groups=(chain,) * n_buckets,
                   replicas=replicas)

    # -- queries ---------------------------------------------------------

    @property
    def n_buckets(self) -> int:
        return len(self.groups)

    def replicas_of(self, bucket: int) -> tuple[int, ...]:
        """Bucket ``bucket``'s replica chain (primary first); length-1
        for unreplicated plans."""
        g = self.groups[bucket]
        return (g,) if isinstance(g, int) else g

    def group_of(self, bucket: int) -> int:
        """The bucket's primary group — the replica that serves it when
        the fleet is healthy."""
        return self.replicas_of(bucket)[0]

    def buckets_of(self, group: int) -> tuple[int, ...]:
        """Original bucket indices stored on ``group`` — any replica
        slot counts (ascending: the order group sub-indexes and
        sub-manifests list them in)."""
        if not 0 <= group < self.n_groups:
            raise ValueError(f"group {group} outside [0, {self.n_groups})")
        return tuple(i for i in range(self.n_buckets)
                     if group in self.replicas_of(i))

    def used_groups(self) -> frozenset:
        """Every group id that stores at least one bucket replica."""
        return frozenset(g for i in range(self.n_buckets)
                         for g in self.replicas_of(i))

    def validate(self, n_buckets: int) -> "PlacementPlan":
        """Check the plan covers exactly the index it is applied to —
        the audit ``topk_search`` and ``index_io`` run before trusting
        a plan that traveled via manifest or caller."""
        if len(self.groups) != n_buckets:
            raise ValueError(
                f"placement covers {len(self.groups)} buckets, index has "
                f"{n_buckets}")
        return self

    # -- failure response ------------------------------------------------

    def rebalance(self, lost_groups,
                  weights=None) -> "PlacementPlan":
        """Re-placement after losing ``lost_groups``: surviving replica
        assignments are preserved (no data movement for them), replicas
        stranded on lost groups are re-placed greedy-LPT over the
        survivors.  Group ids and ``n_groups`` are preserved so the
        plan still addresses the same sub-manifests; the replica degree
        drops to ``min(replicas, n_survivors)`` when too few groups
        remain to keep chains distinct."""
        lost = frozenset(int(g) for g in lost_groups)
        survivors = [g for g in range(self.n_groups) if g not in lost]
        if not survivors:
            raise ValueError(
                f"rebalance impossible: all {self.n_groups} groups lost")
        if weights is None:
            weights = [1] * self.n_buckets
        if len(weights) != self.n_buckets:
            raise ValueError(
                f"{len(weights)} weights for {self.n_buckets} buckets")
        new_r = min(self.replicas, len(survivors))
        load = [0] * self.n_groups
        chains: list[list[int]] = [[] for _ in range(self.n_buckets)]
        for i in range(self.n_buckets):
            kept = [g for g in self.replicas_of(i) if g not in lost][:new_r]
            chains[i] = list(kept)
            for g in kept:
                load[g] += int(weights[i])
        # Refill orphaned slots heaviest-bucket-first (LPT), lightest
        # surviving group not already in the chain — deterministic.
        order = sorted(range(self.n_buckets),
                       key=lambda i: (-int(weights[i]), i))
        for _ in range(new_r):
            for i in order:
                if len(chains[i]) >= new_r:
                    continue
                g = min((j for j in survivors if j not in chains[i]),
                        key=lambda j: (load[j], j))
                chains[i].append(g)
                load[g] += int(weights[i])
        if new_r == 1:
            return PlacementPlan(n_groups=self.n_groups,
                                 groups=tuple(c[0] for c in chains))
        return PlacementPlan(n_groups=self.n_groups,
                             groups=tuple(map(tuple, chains)),
                             replicas=new_r)

    def rebalance_repack(self, weights) -> "PlacementPlan":
        """Re-placement after a *compaction* re-pack
        (``serve.mutation.Compactor``): the bucket set itself changed
        (deltas folded in, tombstoned docs dropped, widths re-planned),
        so unlike :meth:`rebalance` there is no surviving assignment to
        preserve — the new buckets place greedy-LPT from scratch over
        the same groups at the same replica degree.  Deterministic, so
        every host derives the identical next-epoch plan from the
        manifest."""
        return PlacementPlan.balanced(
            weights, self.n_groups,
            replicas=min(self.replicas, self.n_groups))

    # -- manifest round-trip ---------------------------------------------

    def to_manifest(self) -> dict:
        if self.replicas == 1:
            # Format 1 implicitly, so old readers keep loading flat
            # plans.
            return {"n_groups": self.n_groups, "groups": list(self.groups)}
        return {"format": PLACEMENT_FORMAT, "n_groups": self.n_groups,
                "replicas": self.replicas,
                "groups": [list(c) for c in self.groups]}

    @classmethod
    def from_manifest(cls, d: dict) -> "PlacementPlan":
        fmt = int(d.get("format", 1))
        if fmt > PLACEMENT_FORMAT:
            raise IOError(
                f"placement manifest format {fmt} is newer than this "
                f"reader (supports <= {PLACEMENT_FORMAT}); refusing to "
                f"misread the plan — upgrade the serving binary")
        replicas = int(d.get("replicas", 1))
        if replicas == 1:
            return cls(n_groups=int(d["n_groups"]),
                       groups=tuple(int(g) for g in d["groups"]))
        return cls(n_groups=int(d["n_groups"]),
                   groups=tuple(tuple(int(g) for g in c)
                                for c in d["groups"]),
                   replicas=replicas)
