"""Crash-consistent live index mutation: delta buckets, tombstones,
background compaction.

Counterpart of ``repro.serve.mutation``, on an ``index_io`` artifact
directory that either package may have written:

* :class:`DeltaLog` — the in-memory mutable state: the packed base
  epoch plus an ordered op list of absorbed upsert batches (each packed
  into its own small capacity-bucketed :class:`PackedIndex` by the
  machinery the base uses — delta buckets the unmodified
  ``colbert_maxsim`` kernels score directly) and tombstone sets for
  deletes.  ``view()`` produces the ``retrieval.MutationView`` that
  ``topk_search`` merges as extra leaves, stale and tombstoned ids
  masked to -inf before each slab's reduction — bit-identical to
  re-packing the mutated corpus from scratch.
* :func:`append_upsert` / :func:`append_delete` — the durable ops.
  Each appends a checksummed WAL intent record (``index_io.wal_append``)
  BEFORE touching any artifact file, writes its artifacts through
  atomic temp-then-rename primitives only, then appends a commit
  record.  ``index_io.recover(path)`` rolls interrupted ops forward or
  back, so ``kill -9`` at any point yields the pre- or post-mutation
  state, never a torn hybrid.
* :class:`Compactor` — re-packs base + deltas − tombstones into fresh
  capacity buckets (re-placed by ``PlacementPlan.rebalance_repack``
  under a placement), writes the next epoch's self-contained artifact
  BESIDE the live one (``epoch_NNNNNN/``), and commits with one atomic
  root-manifest swap.  ``RetrievalServer.swap_index`` serves it.

Compaction goes through :func:`materialize`, which widens every doc to
fp32 as the reference does: a bf16 base compacts to an fp32 epoch
(twice the embedding bytes), and int8 and residual bases re-quantize.
Only an fp32 ``"none"`` base serves the same result bit for bit after
compaction.

Crash injection: every durability point accepts a
``serve.health.CrashPlan`` that SIGKILLs the process the moment the
named point is passed; ``CRASH_POINTS`` enumerates them.

Single writer: mutation ops and the compactor serialize through the
WAL's append order — one mutator per artifact directory at a time
(queries keep flowing; they never write).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.serve import index_io
from repro_torch.serve.index import PackedIndex
from repro_torch.serve.retrieval import MutationView
from repro_torch.train import checkpoint

__all__ = ["CRASH_POINTS", "Compactor", "DeltaLog", "append_delete",
           "append_upsert", "compact_index", "load_state", "materialize"]

# Every named durability point of the mutation paths, in execution
# order per op.  Each point sits immediately AFTER one durable
# transition (a WAL fsync or an atomic rename); a kill at the point
# tests recovery from "this transition landed, the next one never
# started".  Every write between two points is temp-then-rename atomic,
# so a mid-write kill is equivalent to the preceding point.
CRASH_POINTS = (
    "upsert-intent",      # WAL intent fsync'd; no artifact touched yet
    "upsert-body",        # delta checkpoint body renamed in
    "upsert-manifest",    # delta sub-manifest renamed in
    "upsert-commit",      # WAL commit fsync'd
    "delete-intent",      # WAL intent fsync'd
    "delete-tombstones",  # tombstone set atomically replaced
    "delete-commit",      # WAL commit fsync'd
    "compact-intent",     # WAL intent fsync'd
    "compact-body",       # next epoch's artifact fully written beside
    "compact-swap",       # root manifest atomically swapped to it
    "compact-clean",      # commit + consumed deltas/tombstones dropped
)


def _crash(crash, point: str) -> None:
    if crash is not None:
        crash.check(point)


def _delta_compression(compression: str) -> str:
    """Codec for freshly absorbed delta buckets.  Residual encoding
    needs a trained codebook per bucket; delta batches are small and
    short-lived (the next compaction re-encodes them with the epoch), so
    residual bases absorb deltas uncompressed, in the dtype given — the
    kernels score mixed leaf codecs, and delta sub-manifests stay at
    format 4."""
    return "none" if compression == "residual" else compression


def _host_ids(doc_ids) -> np.ndarray:
    if isinstance(doc_ids, torch.Tensor):
        doc_ids = doc_ids.cpu().numpy()
    return np.asarray(doc_ids, np.int64)


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is (its dtype and device; a bf16
    batch never passes through numpy, which has no bf16), an array
    through ``torch.from_numpy``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _pack_with_ids(embs, masks, doc_ids, n_total: int, *,
                   compression: str, granularity, min_width: int,
                   tokens_total: int | None = None,
                   epoch: int = 0, residual_bits: int = 4,
                   n_centroids: int = 8) -> PackedIndex:
    """Pack a batch of docs carrying explicit corpus-global ids, on the
    embeddings' device and in their dtype.

    ``PackedIndex.pack`` assigns row-local doc ids; here the rows are
    sorted by global id first (the streaming merge's tie rule needs ids
    ascending within every bucket) and each bucket's ids are remapped to
    the global space after packing.  ``n_docs`` becomes the
    corpus-global total so the result drops into the same merge as the
    base index."""
    embs = _tensor(embs)
    masks = _tensor(masks).to(device=embs.device, dtype=torch.bool)
    ids = _host_ids(doc_ids)
    if ids.ndim != 1 or ids.shape[0] != masks.shape[0]:
        raise ValueError(f"doc_ids shape {ids.shape} does not match "
                         f"{masks.shape[0]} docs")
    if len(np.unique(ids)) != len(ids):
        raise ValueError("duplicate doc ids within one batch")
    if len(ids) and ids.min() < 0:
        raise ValueError("doc ids must be >= 0")
    order = np.argsort(ids, kind="stable")
    rows = torch.as_tensor(order, device=embs.device)
    packed = PackedIndex.pack(embs[rows], masks[rows],
                              compression=compression,
                              granularity=granularity, min_width=min_width,
                              residual_bits=residual_bits,
                              n_centroids=n_centroids)
    gids = torch.as_tensor(ids[order], dtype=torch.int32, device=embs.device)
    for b in packed.buckets:
        b.doc_ids = gids[b.doc_ids.long()]
    packed.n_docs = int(n_total)
    packed.epoch = int(epoch)
    if tokens_total is not None:
        packed.tokens_total = int(tokens_total)
    return packed


def _leaf_ids(index: PackedIndex) -> np.ndarray:
    if not index.buckets:
        return np.zeros(0, np.int64)
    return torch.cat([b.doc_ids for b in index.buckets]).cpu().numpy(
    ).astype(np.int64)


@dataclasses.dataclass
class DeltaLog:
    """The live mutable state over a packed base epoch: an ordered op
    list of ``("upsert", PackedIndex)`` delta buckets and
    ``("delete", frozenset)`` tombstone sets.  Order matters — an upsert
    after a delete resurrects the doc; a later upsert shadows an earlier
    version — and :meth:`owner_map` replays it to find the single live
    leaf per doc id.

    Mutators stay single-writer, but a writer's ``upsert``/``delete``
    may race reader snapshots (``view()``/``owner_map()`` from query
    threads), so the op list is guarded by a reentrant lock: a view is
    computed over a consistent prefix of the op list."""

    base: PackedIndex
    ops: list = dataclasses.field(default_factory=list)
    epoch: int = 0
    _lock: threading.RLock = dataclasses.field(
        default_factory=threading.RLock, init=False, repr=False,
        compare=False)

    @property
    def deltas(self) -> list[PackedIndex]:
        with self._lock:
            return [p for op, p in self.ops if op == "upsert"]

    @property
    def n_total(self) -> int:
        with self._lock:
            n = self.base.n_docs
            for op, p in self.ops:
                if op == "upsert":
                    ids = _leaf_ids(p)
                    if len(ids):
                        n = max(n, int(ids.max()) + 1)
                elif p:
                    n = max(n, max(p) + 1)
            return n

    def upsert(self, d_embs, d_masks, doc_ids, *, granularity="pow2",
               min_width: int = 8) -> PackedIndex:
        """Absorb a batch of new/updated docs into a fresh delta bucket
        set (in memory; :func:`append_upsert` is the durable twin)."""
        ids = _host_ids(doc_ids)
        with self._lock:
            n_total = max(self.n_total,
                          int(ids.max()) + 1 if len(ids) else 0)
            delta = _pack_with_ids(
                d_embs, d_masks, ids, n_total,
                compression=_delta_compression(self.base.compression),
                granularity=granularity, min_width=min_width)
            self.ops.append(("upsert", delta))
            return delta

    def delete(self, doc_ids) -> frozenset:
        """Tombstone a set of doc ids (in memory; :func:`append_delete`
        is the durable twin)."""
        tomb = frozenset(int(d) for d in doc_ids)
        with self._lock:
            self.ops.append(("delete", tomb))
        return tomb

    def owner_map(self) -> np.ndarray:
        """(n_total,) int32 leaf owning each doc id's live version — 0
        for the base, ``i + 1`` for delta ``i``, ``-1`` for tombstoned or
        absent — by replaying the op list in order."""
        with self._lock:
            owner = np.full(self.n_total, -1, np.int32)
            base_ids = _leaf_ids(self.base)
            if len(base_ids):
                owner[base_ids] = 0
            leaf = 0
            for op, p in self.ops:
                if op == "upsert":
                    leaf += 1
                    ids = _leaf_ids(p)
                    if len(ids):
                        owner[ids] = leaf
                elif p:
                    owner[np.asarray(sorted(p), np.int64)] = -1
            return owner

    @property
    def n_live(self) -> int:
        return int((self.owner_map() >= 0).sum())

    @property
    def tombstones(self) -> frozenset:
        """Doc ids dead at the end of the op list (a later upsert
        resurrects; the *net* set, not the union)."""
        with self._lock:
            owner = self.owner_map()
            ever = np.zeros(self.n_total, bool)
            for ix in [self.base] + self.deltas:
                ids = _leaf_ids(ix)
                if len(ids):
                    ever[ids] = True
        return frozenset(np.flatnonzero(ever & (owner < 0)).tolist())

    @property
    def device(self) -> torch.device:
        """The device of the log's first leaf that holds buckets."""
        with self._lock:
            return next((ix.device for ix in [self.base] + self.deltas
                         if ix.buckets), self.base.device)

    def view(self) -> MutationView:
        """The serving view ``topk_search(..., mutation=...)`` merges as
        extra leaves, taken atomically: the deltas and the owner map
        come from the same op-list prefix."""
        with self._lock:
            owner = self.owner_map()
            return MutationView(
                deltas=tuple(self.deltas),
                owner=torch.as_tensor(owner, device=self.device),
                n_live=int((owner >= 0).sum()))


def materialize(log: DeltaLog):
    """Densify the log's live docs: ``(embs (n_live, m, dim) fp32, masks
    (n_live, m) bool, doc_ids (n_live,) int64)`` on the log's device,
    each doc's kept tokens front-packed, rows ascending by global id
    (the ids are a host array).  Both the compactor's input and the
    differential oracle's (re-pack from scratch): compacting and
    re-packing the same materialization is what makes the two
    bit-identical.  Every codec widens to fp32 here, as in the
    reference (a bf16 value widens exactly)."""
    with log._lock:
        leaves = [log.base] + log.deltas
        owner = log.owner_map()
    live = np.flatnonzero(owner >= 0)
    row_of = np.full(len(owner), -1, np.int64)
    row_of[live] = np.arange(len(live))
    dim, dev = log.base.dim, log.device
    m_out = max(max((ix.m for ix in leaves), default=1), 1)
    embs = torch.zeros((len(live), m_out, dim), dtype=torch.float32,
                       device=dev)
    masks = torch.zeros((len(live), m_out), dtype=torch.bool, device=dev)
    for leaf, ix in enumerate(leaves):
        for b in ix.buckets:
            ids = b.doc_ids.cpu().numpy().astype(np.int64)
            sel = np.flatnonzero(owner[ids] == leaf)
            if not len(sel):
                continue
            rows = torch.as_tensor(row_of[ids[sel]], device=dev)
            src = torch.as_tensor(sel, device=dev)
            embs[rows, :b.cap] = b.dense_embs(dim)[src].float()
            masks[rows, :b.cap] = b.masks[src]
    return embs, masks, live.astype(np.int64)


def compact_index(log: DeltaLog, *, granularity="pow2",
                  min_width: int = 8) -> PackedIndex:
    """Fold deltas + tombstones into a fresh capacity-bucketed epoch:
    live docs only, global doc ids preserved, epoch bumped, in fp32 (see
    :func:`materialize`).  Residual bases re-encode the whole epoch with
    fresh per-bucket codebooks at the base's bit width and codebook
    size, so post-compact residual scores match the delta view only
    approximately; ``"none"`` and int8 re-pack the same values."""
    embs, masks, ids = materialize(log)
    return _pack_with_ids(
        embs, masks, ids, log.n_total,
        compression=log.base.compression, granularity=granularity,
        min_width=min_width, tokens_total=int(masks.sum()),
        epoch=log.epoch + 1,
        residual_bits=log.base.residual_bits or 4,
        n_centroids=log.base.n_centroids or 8)


# ----------------------------------------------------------------------
# Durable mutation ops.  Protocol per op: WAL intent (checksummed,
# fsync'd) -> atomic artifact writes -> WAL commit.  index_io.recover
# rolls an interrupted op forward iff every artifact write landed, back
# otherwise.
# ----------------------------------------------------------------------


def _next_seq(records) -> int:
    return max((int(r["seq"]) for r in records), default=-1) + 1


def _next_delta(records) -> int:
    return max((int(r["delta"]) for r in records
                if r.get("op") == "upsert"), default=-1) + 1


def append_upsert(path: str, d_embs, d_masks, doc_ids, *,
                  granularity="pow2", min_width: int = 8,
                  crash=None) -> int:
    """Durably absorb an upsert batch into a new delta bucket set under
    the artifact at ``path``, packed on the batch's device in its dtype.
    Returns the delta id."""
    manifest = index_io._read_manifest(path, index_io.MANIFEST)
    records = index_io.wal_read(path)
    seq, delta_id = _next_seq(records), _next_delta(records)
    ids = _host_ids(doc_ids)
    n_total = max(int(manifest["n_docs"]),
                  int(ids.max()) + 1 if len(ids) else 0)
    index_io.wal_append(path, {
        "op": "upsert", "seq": seq, "delta": delta_id,
        "doc_ids": [int(d) for d in ids]})
    _crash(crash, "upsert-intent")
    delta = _pack_with_ids(
        d_embs, d_masks, ids, n_total,
        compression=_delta_compression(manifest["compression"]),
        granularity=granularity, min_width=min_width)
    checkpoint.save(index_io._delta_dir(path, delta_id), 0,
                    index_io._body_tree(delta), keep=1)
    _crash(crash, "upsert-body")
    sub = index_io._meta(delta) | {
        "kind": "packed_index_delta",
        # Deltas are never residual (see _delta_compression), so their
        # sub-manifests stay at the mutable-artifact format.
        "format": index_io._format_for(None, 1, delta.compression),
        "delta": delta_id,
        "buckets": index_io._bucket_metas(delta.buckets),
    }
    checkpoint.atomic_json_dump(
        os.path.join(path, index_io._delta_manifest(delta_id)), sub)
    _crash(crash, "upsert-manifest")
    index_io.wal_append(path, {"op": "commit", "seq": seq})
    _crash(crash, "upsert-commit")
    return delta_id


def append_delete(path: str, doc_ids, *, crash=None) -> None:
    """Durably tombstone a batch of doc ids under the artifact at
    ``path``."""
    records = index_io.wal_read(path)
    seq = _next_seq(records)
    ids = sorted(int(d) for d in doc_ids)
    index_io.wal_append(path, {"op": "delete", "seq": seq,
                               "doc_ids": ids})
    _crash(crash, "delete-intent")
    merged = sorted(index_io.load_tombstones(path) | set(ids))
    checkpoint.atomic_json_dump(
        os.path.join(path, index_io.TOMBSTONES),
        {"kind": "tombstones", "format": 1, "doc_ids": merged})
    _crash(crash, "delete-tombstones")
    index_io.wal_append(path, {"op": "commit", "seq": seq})
    _crash(crash, "delete-commit")


def load_state(path: str, *, device=None) -> DeltaLog:
    """Reconstruct the live :class:`DeltaLog` from the artifact at
    ``path`` on ``device`` (``cuda`` unless the caller names another):
    the current epoch's base index plus every committed, un-compacted
    mutation op in WAL order, each leaf in its stored dtype.
    Uncommitted (crashed) intents are skipped — run ``index_io.recover``
    first to resolve them and sweep their partial files."""
    device = backend_lib.resolve_device(device)
    base = index_io.load_index(path, device=device)
    records = index_io.wal_read(path)
    committed = {r["seq"] for r in records if r["op"] == "commit"}
    last_compact = max((r["seq"] for r in records
                        if r["op"] == "compact"
                        and r["seq"] in committed), default=-1)
    ops = []
    for rec in records:
        if rec["op"] not in ("upsert", "delete"):
            continue
        if rec["seq"] not in committed or rec["seq"] <= last_compact:
            continue
        if rec["op"] == "upsert":
            d = int(rec["delta"])
            sub = index_io._read_manifest(path,
                                          index_io._delta_manifest(d))
            buckets = (index_io._restore_buckets(
                index_io._delta_dir(path, d), sub, device)
                if sub["buckets"] else [])
            ops.append(("upsert", index_io._index_of(sub, buckets)))
        else:
            ops.append(("delete",
                        frozenset(int(x) for x in rec["doc_ids"])))
    return DeltaLog(base=base, ops=ops, epoch=base.epoch)


class Compactor:
    """Compaction over an artifact directory: fold the committed delta
    log into a fresh packed epoch written BESIDE the live one, then
    commit with one atomic root-manifest swap.  Queries served from the
    old epoch stay valid throughout; a ``RetrievalServer`` picks up the
    new epoch via ``swap_index``.  A placed artifact is re-split under
    ``PlacementPlan.rebalance_repack`` (the bucket set is new), and a
    routed one gets its routing sidecar rebuilt inside the new epoch.
    The log is loaded and compacted on ``device`` (``cuda`` unless the
    caller names another)."""

    def __init__(self, path: str, *, granularity="pow2",
                 min_width: int = 8, crash=None, device=None):
        self.path = path
        self.granularity = granularity
        self.min_width = min_width
        self.crash = crash
        self.device = backend_lib.resolve_device(device)

    def run(self) -> PackedIndex | None:
        """One compaction cycle.  Returns the new epoch's index, or
        ``None`` when there was nothing to compact."""
        path = self.path
        log = load_state(path, device=self.device)
        if not log.ops:
            return None
        records = index_io.wal_read(path)
        seq = _next_seq(records)
        new_epoch = log.epoch + 1
        _, live_deltas, _ = index_io._wal_state(records)
        consumed = sorted(int(d) for d in live_deltas)
        rec = {"op": "compact", "seq": seq, "epoch": new_epoch,
               "deltas": consumed}
        index_io.wal_append(path, rec)
        _crash(self.crash, "compact-intent")
        new_index = compact_index(log, granularity=self.granularity,
                                  min_width=self.min_width)
        placement = index_io.load_placement(path)
        if placement is not None:
            placement = placement.rebalance_repack(
                [b.nbytes() for b in new_index.buckets])
        edirname = index_io._epoch_dirname(new_epoch)
        epoch_path = os.path.join(path, edirname)
        index_io.save_index(epoch_path, new_index, placement=placement)
        if index_io.has_routing(path):
            # The live epoch serves routed: rebuild the sidecar for the
            # compacted bucket set with the same build parameters,
            # INSIDE the new epoch dir — the compact intent's rollback
            # (removing the epoch dir) covers it, and the swap below
            # publishes index and routing together.
            from repro_torch.serve.routing import RoutingIndex
            old = index_io.load_routing(path, device=self.device)
            index_io.save_routing(
                epoch_path,
                RoutingIndex.build(new_index, n_centroids=old.n_centroids,
                                   iters=old.iters, seed=old.seed))
        _crash(self.crash, "compact-body")
        with open(os.path.join(epoch_path, index_io.MANIFEST)) as f:
            inner = json.load(f)
        checkpoint.atomic_json_dump(
            os.path.join(path, index_io.MANIFEST),
            inner | {"epoch_dir": edirname,
                     "format": max(int(inner.get("format", 1)),
                                   index_io._format_for(None, new_epoch))})
        _crash(self.crash, "compact-swap")
        index_io.finish_compact(path, rec)
        _crash(self.crash, "compact-clean")
        return new_index
