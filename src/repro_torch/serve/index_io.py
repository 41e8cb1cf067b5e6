"""Packed-index persistence: versioned manifest + checkpoint-layer body.

Counterpart of ``repro.serve.index_io``, in its on-disk format: an
artifact written by either package loads in the other.  The artifact a
pruning job hands to serving:

    <dir>/packed_index.json            versioned manifest (layout metadata)
    <dir>/step_000000000/{...}         bucket arrays via train/checkpoint

With a :class:`~repro_torch.sharding.PlacementPlan`
(``save_index(..., placement=...)``) the body splits by host group, so
each group restores ONLY the buckets placed on it:

    <dir>/packed_index.json            manifest + the placement plan
    <dir>/packed_index.group0.json     group 0's self-describing sub-manifest
    <dir>/group_0000/step_.../{...}    group 0's bucket arrays
    ...

``load_index(dir)`` reassembles the full index from every group;
``load_index(dir, group=g)`` reads only group ``g``'s sub-manifest and
body.  Group sub-indexes keep corpus-global ``n_docs`` and doc ids.

The body rides ``repro_torch.train.checkpoint`` (the reference's leaf
format): atomic rename commit, per-leaf crc32 verification on load, and
the async save path (host copy now, disk write on a daemon thread —
``save_index(..., async_save=True)``; ``checkpoint.wait_pending()``
joins it).  The manifest records the *layout* (bucket capacities and
sizes, compression, dims, placement) that the flat leaf list cannot
express; ``load_index`` rebuilds the leaf tree from it before the
checkpoint layer fills it.  Manifest writes are tmp+fsync+rename
atomic like the body.  A restored index lives on ``device`` (``cuda``
unless the caller names another), each leaf in its stored dtype (bool,
int8, uint8, bf16 and fp32 alike).

``FORMAT`` is bumped on any layout change; readers refuse newer-format
manifests.  Each artifact is stamped with the lowest format that can
describe it (:func:`_format_for`), so old layouts stay loadable by old
readers.

The second half of the module is the mutation WAL and crash recovery
(see the section comment below) and the candidate-routing sidecar.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib

from repro_torch.core import backend as backend_lib
from repro_torch.serve.index import COMPRESSIONS, PackedBucket, PackedIndex
from repro_torch.sharding import PlacementPlan
from repro_torch.train import checkpoint

__all__ = ["FORMAT", "MANIFEST", "ROUTING", "WAL", "has_index",
           "has_routing", "list_orphans", "live_epoch_dir", "load_epoch",
           "load_index", "load_placement", "load_routing", "recover",
           "save_index", "save_routing", "wal_append", "wal_read"]

# 2: the manifest grew "placement" and the body may split into
# per-host-group sub-manifests + bodies.
# 3: replicated placements — a bucket's body appears in EVERY group of
# its replica chain, and the placement manifest nests replica chains.
# 4: mutable artifacts — the manifest carries an "epoch" field and,
# once a compaction has committed, an "epoch_dir" pointing at the
# subdirectory holding the live epoch's self-contained artifact; delta
# sub-manifests ("packed_index_delta") and the mutation WAL ride
# beside it.
# 5: the residual codec — residual buckets store {codes, resq, rscale,
# codebook} leaves instead of {embs}, and the manifest carries
# "residual_bits".  Only residual artifacts stamp 5 (delta bodies are
# never residual, so mutable fp/int8 artifacts stay at 4).
FORMAT = 5
MANIFEST = "packed_index.json"
WAL = "mutation.wal"
TOMBSTONES = "tombstones.json"
# Candidate-routing sidecar (serve/routing.py): its own manifest and
# checkpoint body beside the index it was built from, its own format
# ladder (the index manifest does not change shape when a table
# appears).
ROUTING = "routing.json"
ROUTING_DIR = "routing"
ROUTING_FORMAT = 1

_LEAF_KEYS = {"int8": ("doc_ids", "masks", "q8", "scales"),
              "residual": ("doc_ids", "masks", "codes", "resq", "rscale",
                           "codebook")}


def _format_for(placement: PlacementPlan | None, epoch: int = 0,
                compression: str = "none") -> int:
    if compression == "residual":
        return 5
    if epoch:
        return 4
    if placement is None:
        return 1
    return 2 if placement.replicas == 1 else 3


def _group_manifest(g: int) -> str:
    return f"packed_index.group{g}.json"


def _group_dir(path: str, g: int) -> str:
    return os.path.join(path, f"group_{g:04d}")


def _delta_manifest(d: int) -> str:
    return f"packed_index.delta{d}.json"


def _delta_dir(path: str, d: int) -> str:
    return os.path.join(path, f"delta_{d:06d}")


def _epoch_dirname(epoch: int) -> str:
    return f"epoch_{epoch:06d}"


def _bucket_leaf(index: PackedIndex, b: PackedBucket) -> dict:
    keys = _LEAF_KEYS.get(index.compression, ("doc_ids", "masks", "embs"))
    return {k: getattr(b, k) for k in keys}


def _body_tree(index: PackedIndex, buckets=None) -> dict:
    """The tree the checkpoint layer serializes.  Key sets differ by
    compression; the manifest records which, so load rebuilds the same
    structure.  ``buckets`` narrows to a host group's subset."""
    buckets = index.buckets if buckets is None else buckets
    return {"buckets": [_bucket_leaf(index, b) for b in buckets]}


def _meta(index: PackedIndex) -> dict:
    meta = {
        "kind": "packed_index",
        "n_docs": int(index.n_docs),
        "m": int(index.m),
        "dim": int(index.dim),
        "tokens_total": int(index.tokens_total),
        "compression": index.compression,
    }
    if index.epoch:
        meta["epoch"] = int(index.epoch)
    if index.compression == "residual":
        meta["residual_bits"] = int(index.residual_bits)
    return meta


def _bucket_metas(buckets) -> list[dict]:
    return [{"cap": int(b.cap), "n_docs": int(b.n_docs)} for b in buckets]


def save_index(path: str, index: PackedIndex, *,
               placement: PlacementPlan | None = None,
               async_save: bool = False) -> str:
    """Persist ``index`` under ``path``.  Returns the manifest path.

    ``placement`` splits the body by host group (one sub-manifest +
    checkpoint body per non-empty group); the plan itself rides in the
    main manifest and every sub-manifest.  ``async_save`` copies to
    host memory now and writes on a daemon thread (join with
    ``checkpoint.wait_pending()`` before handing the directory to
    another job)."""
    os.makedirs(path, exist_ok=True)
    saver = checkpoint.save_async if async_save else checkpoint.save
    fmt = _format_for(placement, index.epoch, index.compression)
    manifest = _meta(index) | {"format": fmt,
                               "buckets": _bucket_metas(index.buckets)}
    if placement is not None:
        placement.validate(len(index.buckets))
        manifest["placement"] = placement.to_manifest()
        for g in range(placement.n_groups):
            # A bucket persists in every group of its replica chain, so
            # any surviving replica can restore and serve it alone.
            picked = placement.buckets_of(g)
            sub = _meta(index) | {
                "format": fmt,
                "kind": "packed_index_group",
                "group": g,
                "placement": placement.to_manifest(),
                "buckets": [m | {"index": i} for i, m in zip(
                    picked, _bucket_metas(index.buckets[i] for i in picked))],
            }
            checkpoint.atomic_json_dump(
                os.path.join(path, _group_manifest(g)), sub)
            if picked:
                saver(_group_dir(path, g), 0,
                      _body_tree(index, [index.buckets[i] for i in picked]),
                      keep=1)
    else:
        saver(path, 0, _body_tree(index), keep=1)
    final = os.path.join(path, MANIFEST)
    checkpoint.atomic_json_dump(final, manifest)
    return final


def _read_manifest(path: str, name: str) -> dict:
    with open(os.path.join(path, name)) as f:
        manifest = json.load(f)
    if manifest.get("kind") not in ("packed_index", "packed_index_group",
                                    "packed_index_delta"):
        raise IOError(f"{path}/{name}: manifest is not a packed index")
    if manifest.get("format", 0) > FORMAT:
        raise IOError(f"{path}/{name}: manifest format "
                      f"{manifest['format']} is newer than this reader "
                      f"(format {FORMAT})")
    if manifest["compression"] not in COMPRESSIONS:
        raise IOError(f"{path}/{name}: unknown compression "
                      f"{manifest['compression']!r}")
    return manifest


def _read_group_manifest(path: str, g: int) -> dict:
    """Group sub-manifest read that turns a torn artifact into an
    actionable error naming the bad group and pointing at
    :func:`recover`."""
    name = _group_manifest(g)
    try:
        return _read_manifest(path, name)
    except FileNotFoundError as e:
        raise IOError(
            f"{path}: host group {g} sub-manifest {name} is missing — "
            "the artifact is torn (interrupted save or mutation); run "
            "repro_torch.serve.index_io.recover(path) to roll it back to "
            "a consistent epoch") from e
    except json.JSONDecodeError as e:
        raise IOError(
            f"{path}: host group {g} sub-manifest {name} is truncated "
            f"or corrupt ({e}) — the artifact is torn; run "
            "repro_torch.serve.index_io.recover(path) to roll it back to "
            "a consistent epoch") from e


def has_index(path: str) -> bool:
    """True when ``path`` holds a loadable artifact (manifest + a
    committed checkpoint step for the body — every non-empty group's
    body under a placement)."""
    if not os.path.exists(os.path.join(path, MANIFEST)):
        return False
    try:
        manifest = _read_manifest(path, MANIFEST)
    except (IOError, json.JSONDecodeError, KeyError):
        return False
    if manifest.get("epoch_dir"):
        return has_index(os.path.join(path, manifest["epoch_dir"]))
    placement = manifest.get("placement")
    if placement is None:
        return bool(checkpoint.list_steps(path))
    try:
        groups = PlacementPlan.from_manifest(placement).used_groups()
    except (IOError, ValueError, KeyError):
        return False
    return all(bool(checkpoint.list_steps(_group_dir(path, g)))
               for g in groups)


def load_placement(path: str) -> PlacementPlan | None:
    """The placement plan a saved artifact was split by (None for
    placement-less artifacts)."""
    manifest = _read_manifest(path, MANIFEST)
    if manifest.get("epoch_dir"):
        return load_placement(os.path.join(path, manifest["epoch_dir"]))
    plc = manifest.get("placement")
    return None if plc is None else PlacementPlan.from_manifest(plc)


def load_epoch(path: str) -> int:
    """The live mutation epoch of the artifact at ``path`` (0 for any
    pre-mutation artifact)."""
    return int(_read_manifest(path, MANIFEST).get("epoch", 0))


def _restore_buckets(root: str, manifest: dict,
                     device) -> list[PackedBucket]:
    """Restore one checkpoint body's bucket list as its manifest's
    ``buckets`` entries describe it, on ``device`` in the stored dtypes
    (crc-verified by the checkpoint layer; raises ``IOError`` when no
    restorable step exists)."""
    metas = manifest["buckets"]
    if not metas:
        return []
    keys = _LEAF_KEYS.get(manifest["compression"],
                          ("doc_ids", "masks", "embs"))
    like = {"buckets": [{k: 0 for k in keys} for _ in metas]}
    _, tree = checkpoint.restore_latest(root, like)
    if tree is None:
        raise IOError(f"{root}: no restorable packed-index body")
    return [PackedBucket(cap=int(meta["cap"]),
                         **{k: v.to(device) for k, v in leaf.items()})
            for meta, leaf in zip(metas, tree["buckets"])]


def _index_of(manifest: dict, buckets: list[PackedBucket]) -> PackedIndex:
    return PackedIndex(n_docs=int(manifest["n_docs"]),
                       m=int(manifest["m"]), dim=int(manifest["dim"]),
                       tokens_total=int(manifest["tokens_total"]),
                       compression=manifest["compression"],
                       buckets=buckets,
                       epoch=int(manifest.get("epoch", 0)),
                       residual_bits=int(manifest.get("residual_bits", 0)))


def load_index(path: str, *, group: int | None = None,
               device=None) -> PackedIndex:
    """Restore a :class:`PackedIndex` saved by :func:`save_index` (by
    either package) on ``device`` (``cuda`` unless the caller names
    another; raises without a GPU).

    ``group=g`` restores ONLY host group ``g``'s buckets via its
    sub-manifest; the returned index keeps corpus-global ``n_docs`` and
    doc ids.  ``group=None`` on a placed artifact reassembles every
    group's buckets into the full index, in the original bucket order
    (a replicated bucket's copies dedupe by original index).

    The checkpoint layer verifies per-leaf crc32s and walks past corrupt
    steps; a directory with no restorable body raises ``IOError``.
    """
    device = backend_lib.resolve_device(device)
    manifest = _read_manifest(path, MANIFEST)
    if manifest.get("epoch_dir"):
        # A committed compaction moved the live epoch into its own
        # self-contained subdirectory; the root manifest is a pointer.
        return load_index(os.path.join(path, manifest["epoch_dir"]),
                          group=group, device=device)
    placement = manifest.get("placement")
    if group is not None:
        if placement is None:
            raise IOError(f"{path}: artifact has no placement; "
                          f"load_index(group={group}) needs one "
                          "(save_index(..., placement=...))")
        sub = _read_group_manifest(path, group)
        buckets = (_restore_buckets(_group_dir(path, group), sub, device)
                   if sub["buckets"] else [])
        return _index_of(sub, buckets)
    if placement is None:
        return _index_of(manifest,
                         _restore_buckets(path, manifest, device))
    plan = PlacementPlan.from_manifest(placement)
    plan.validate(len(manifest["buckets"]))
    by_index: dict[int, PackedBucket] = {}
    for g in range(plan.n_groups):
        sub = _read_group_manifest(path, g)
        restored = (_restore_buckets(_group_dir(path, g), sub, device)
                    if sub["buckets"] else [])
        for meta, bucket in zip(sub["buckets"], restored):
            by_index[int(meta["index"])] = bucket
    buckets = [by_index[i] for i in range(len(manifest["buckets"]))]
    return _index_of(manifest, buckets)


# ----------------------------------------------------------------------
# Candidate-routing sidecar (serve/routing.py): per-bucket centroid
# tables + residual radii persisted BESIDE the index epoch they were
# built from — inside the live epoch_dir for compacted artifacts, so a
# compaction's WAL intent (whose rollback removes the whole epoch dir)
# covers the routing rebuild, and the epoch swap publishes index and
# routing together.
# ----------------------------------------------------------------------


def live_epoch_dir(path: str) -> str:
    """The directory holding the live epoch's files: ``path`` itself for
    never-compacted artifacts, the committed ``epoch_dir`` subdirectory
    otherwise.  Sidecar writers (:func:`save_routing`) target THIS
    directory; ``save_routing`` itself does not follow the pointer —
    the Compactor writes the NEXT epoch's sidecar before the manifest
    swap publishes it."""
    try:
        manifest = _read_manifest(path, MANIFEST)
    except (IOError, OSError, json.JSONDecodeError, KeyError):
        return path
    sub = manifest.get("epoch_dir")
    return os.path.join(path, sub) if sub else path


def save_routing(path: str, routing, *, async_save: bool = False) -> str:
    """Persist a ``serve.routing.RoutingIndex`` sidecar under ``path``
    (the directory holding the index epoch it was built from).  Returns
    the manifest path."""
    os.makedirs(path, exist_ok=True)
    saver = checkpoint.save_async if async_save else checkpoint.save
    saver(os.path.join(path, ROUTING_DIR), 0, routing.body_tree(), keep=1)
    manifest = {"kind": "routing_index", "format": ROUTING_FORMAT}
    manifest.update(routing.meta())
    final = os.path.join(path, ROUTING)
    checkpoint.atomic_json_dump(final, manifest)
    return final


def _read_routing_manifest(path: str) -> dict:
    with open(os.path.join(path, ROUTING)) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "routing_index":
        raise IOError(f"{path}/{ROUTING}: manifest is not a routing table")
    if manifest.get("format", 0) > ROUTING_FORMAT:
        raise IOError(f"{path}/{ROUTING}: routing format "
                      f"{manifest['format']} is newer than this reader "
                      f"(format {ROUTING_FORMAT})")
    return manifest


def has_routing(path: str) -> bool:
    """True when the artifact's LIVE epoch carries a loadable routing
    sidecar (follows the ``epoch_dir`` pointer like :func:`has_index`)."""
    try:
        manifest = _read_manifest(path, MANIFEST)
    except (IOError, OSError, json.JSONDecodeError, KeyError):
        manifest = {}
    if manifest.get("epoch_dir"):
        return has_routing(os.path.join(path, manifest["epoch_dir"]))
    if not os.path.exists(os.path.join(path, ROUTING)):
        return False
    try:
        _read_routing_manifest(path)
    except (IOError, json.JSONDecodeError, KeyError):
        return False
    return bool(checkpoint.list_steps(os.path.join(path, ROUTING_DIR)))


def load_routing(path: str, *, device=None):
    """Restore the live epoch's routing sidecar as a
    ``serve.routing.RoutingIndex`` on ``device`` (``cuda`` unless the
    caller names another), or ``None`` when the artifact has none.
    Follows the root manifest's ``epoch_dir`` pointer like
    :func:`load_index`, so a caller gets the table matching the epoch
    :func:`load_index` returns."""
    from repro_torch.serve.routing import RoutingIndex

    device = backend_lib.resolve_device(device)
    try:
        manifest = _read_manifest(path, MANIFEST)
    except FileNotFoundError:
        manifest = {}
    if manifest.get("epoch_dir"):
        return load_routing(os.path.join(path, manifest["epoch_dir"]),
                            device=device)
    if not os.path.exists(os.path.join(path, ROUTING)):
        return None
    meta = _read_routing_manifest(path)
    like = {"centroids": 0, "cmask": 0, "radius": 0}
    _, tree = checkpoint.restore_latest(os.path.join(path, ROUTING_DIR),
                                        like)
    if tree is None:
        raise IOError(f"{path}/{ROUTING_DIR}: no restorable routing body")
    return RoutingIndex.from_parts(meta, tree, device=device)


# ----------------------------------------------------------------------
# Write-ahead log + crash recovery.  Every mutation of the artifact — an
# upsert batch, a delete batch, a compaction swap — appends a
# checksummed *intent* record to <dir>/mutation.wal (fsync'd) BEFORE
# touching any artifact file, performs its writes exclusively through
# atomic temp-then-rename primitives (checkpoint.save /
# atomic_json_dump), and appends a *commit* record once every write
# landed.  ``recover(path)`` replays the log: an intent whose writes all
# landed is rolled forward (commit appended), anything else rolled back
# (its partial files deleted, an abort record appended), and files no
# committed state references are garbage-collected — so a ``kill -9``
# at ANY point leaves the directory restorable to exactly the pre- or
# post-mutation epoch.  Records hold JSON-native values only, so both
# packages compute the same crc32 over the same bytes.
# ----------------------------------------------------------------------


def _wal_crc(rec: dict) -> int:
    return zlib.crc32(
        json.dumps(rec, sort_keys=True).encode()) & 0xFFFFFFFF


def wal_append(path: str, record: dict) -> dict:
    """Append one checksummed record to the mutation WAL, fsync'd so
    the intent is durable before any artifact write it covers."""
    rec = dict(record)
    rec["crc"] = _wal_crc(record)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, WAL), "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return rec


def wal_read(path: str) -> list[dict]:
    """The WAL's valid prefix: reading stops at the first torn or
    checksum-failing line (an append cut short by a crash); records
    beyond it are unreachable by construction (appends are serialized
    and fsync'd), so the prefix IS the durable history."""
    out: list[dict] = []
    try:
        with open(os.path.join(path, WAL)) as f:
            lines = f.read().split("\n")
    except FileNotFoundError:
        return out
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            break
        crc = rec.pop("crc", None)
        if crc != _wal_crc(rec):
            break
        out.append(rec)
    return out


def _wal_state(records: list[dict]):
    """(pending intents, live delta ids, live tombstone flag) from the
    durable history.  A committed compaction consumes every delta and
    tombstone whose seq precedes it."""
    intents = {r["seq"]: r for r in records
               if r["op"] not in ("commit", "abort")}
    resolved = {r["seq"] for r in records if r["op"] in ("commit", "abort")}
    committed = {r["seq"] for r in records if r["op"] == "commit"}
    pending = [intents[s] for s in sorted(intents) if s not in resolved]
    last_compact = max((r["seq"] for r in records
                        if r["op"] == "compact" and r["seq"] in committed),
                       default=-1)
    live_deltas = {r["delta"] for r in records
                   if r["op"] == "upsert" and r["seq"] in committed
                   and r["seq"] > last_compact}
    live_tombstones = any(r["op"] == "delete" and r["seq"] in committed
                          and r["seq"] > last_compact for r in records)
    return pending, live_deltas, live_tombstones


def load_tombstones(path: str) -> set[int]:
    """The materialized cumulative tombstone set (empty when none)."""
    try:
        with open(os.path.join(path, TOMBSTONES)) as f:
            obj = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return set()
    return set(int(d) for d in obj.get("doc_ids", ()))


def _intent_landed(path: str, rec: dict) -> bool:
    """True when every artifact write the intent covers is durably
    committed — the roll-forward test."""
    op = rec["op"]
    if op == "upsert":
        d = int(rec["delta"])
        try:
            sub = _read_manifest(path, _delta_manifest(d))
        except (IOError, OSError, json.JSONDecodeError, KeyError):
            return False
        try:
            _restore_buckets(_delta_dir(path, d), sub, "cpu")
        except Exception:
            return False
        return True
    if op == "delete":
        return set(int(d) for d in rec["doc_ids"]) <= load_tombstones(path)
    if op == "compact":
        try:
            manifest = _read_manifest(path, MANIFEST)
        except (IOError, OSError, json.JSONDecodeError, KeyError):
            return False
        return int(manifest.get("epoch", 0)) == int(rec["epoch"])
    return False


def _roll_back(path: str, rec: dict) -> list[str]:
    """Delete the partial artifacts of an intent that did not land.
    Every covered write is temp-then-rename atomic, so each named file
    either exists whole (deleted here) or never appeared."""
    removed = []
    op = rec["op"]
    if op == "upsert":
        d = int(rec["delta"])
        for target in (os.path.join(path, _delta_manifest(d)),
                       _delta_dir(path, d)):
            if os.path.isdir(target):
                shutil.rmtree(target)
                removed.append(target)
            elif os.path.exists(target):
                os.remove(target)
                removed.append(target)
    elif op == "compact":
        edir = os.path.join(path, _epoch_dirname(int(rec["epoch"])))
        if os.path.isdir(edir):
            shutil.rmtree(edir)
            removed.append(edir)
    # delete: the tombstone file write is atomic and _intent_landed
    # said it holds the OLD set — nothing partial exists to remove.
    return removed


def finish_compact(path: str, rec: dict) -> None:
    """Commit a landed compaction and drop what it consumed: the delta
    bodies/manifests it folded in, the tombstone file, the previous
    epoch's body.  Idempotent — a crash mid-cleanup leaves orphans the
    next :func:`recover` sweep removes."""
    records = wal_read(path)
    if rec["seq"] not in {r["seq"] for r in records if r["op"] == "commit"}:
        wal_append(path, {"op": "commit", "seq": rec["seq"]})
    for d in rec.get("deltas", ()):
        _roll_back(path, {"op": "upsert", "delta": int(d)})
    tomb = os.path.join(path, TOMBSTONES)
    if os.path.exists(tomb):
        os.remove(tomb)
    for orphan in list_orphans(path):
        _remove_any(orphan)


def _remove_any(target: str) -> None:
    if os.path.isdir(target):
        shutil.rmtree(target, ignore_errors=True)
    elif os.path.exists(target):
        try:
            os.remove(target)
        except OSError:
            pass


def list_orphans(path: str) -> list[str]:
    """Files under ``path`` that no committed state references: stage
    leftovers (``*.tmp.*`` files, ``tmp.*`` checkpoint dirs), delta
    artifacts outside the live set, superseded epoch directories, and
    — once an ``epoch_dir`` pointer is live — the previous epoch's
    root-level body.  ``recover`` deletes exactly this list; an
    artifact is clean when it is empty."""
    if not os.path.isdir(path):
        return []
    try:
        manifest = _read_manifest(path, MANIFEST)
    except (IOError, OSError, json.JSONDecodeError, KeyError):
        manifest = {}
    epoch_dir = manifest.get("epoch_dir")
    pending, live_deltas, live_tombstones = _wal_state(wal_read(path))
    pending_deltas = {int(r["delta"]) for r in pending
                      if r["op"] == "upsert"}
    pending_epochs = {int(r["epoch"]) for r in pending
                      if r["op"] == "compact"}
    orphans = []
    for name in sorted(os.listdir(path)):
        full = os.path.join(path, name)
        if ".tmp." in name or name.startswith("tmp."):
            orphans.append(full)
        elif name.startswith("delta_") or name.startswith(
                "packed_index.delta"):
            try:
                d = int(name.split("delta")[-1].replace("_", "")
                        .split(".")[0])
            except ValueError:
                orphans.append(full)
                continue
            if d not in live_deltas and d not in pending_deltas:
                orphans.append(full)
        elif name.startswith("epoch_"):
            try:
                e = int(name.split("_")[1])
            except (IndexError, ValueError):
                orphans.append(full)
                continue
            if name != epoch_dir and e not in pending_epochs:
                orphans.append(full)
        elif name == TOMBSTONES:
            if not live_tombstones and not any(
                    r["op"] == "delete" for r in pending):
                orphans.append(full)
        elif epoch_dir and (name.startswith("step_")
                            or name.startswith("group_")
                            or name.startswith("packed_index.group")
                            or name in (ROUTING, ROUTING_DIR)):
            # the pre-compaction epoch's body at the root, superseded
            # by the epoch_dir pointer — its routing sidecar included
            # (the live epoch_dir carries its own rebuilt table)
            orphans.append(full)
        elif os.path.isdir(full):
            for sub in sorted(os.listdir(full)):
                if sub.startswith("tmp.") or ".tmp." in sub:
                    orphans.append(os.path.join(full, sub))
    return orphans


def recover(path: str) -> dict:
    """Replay/roll back the mutation WAL after a crash.

    Every pending intent (appended to the WAL but never committed) is
    resolved: rolled FORWARD when all its artifact writes landed, rolled
    BACK otherwise (its partial files deleted and the intent aborted).
    Stage leftovers and unreferenced files are then garbage-collected.
    Idempotent, and safe to crash *during*: re-running converges to the
    same state.  Returns a report dict (``rolled_forward`` /
    ``rolled_back`` seqs, ``removed`` paths)."""
    report = {"rolled_forward": [], "rolled_back": [], "removed": []}
    if not os.path.isdir(path):
        return report
    pending, _, _ = _wal_state(wal_read(path))
    for rec in pending:
        if _intent_landed(path, rec):
            if rec["op"] == "compact":
                finish_compact(path, rec)
            else:
                wal_append(path, {"op": "commit", "seq": rec["seq"]})
            report["rolled_forward"].append(int(rec["seq"]))
        else:
            report["removed"] += _roll_back(path, rec)
            wal_append(path, {"op": "abort", "seq": rec["seq"]})
            report["rolled_back"].append(int(rec["seq"]))
    for orphan in list_orphans(path):
        _remove_any(orphan)
        report["removed"].append(orphan)
    return report
