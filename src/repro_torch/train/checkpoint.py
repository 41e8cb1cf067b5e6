"""Fault-tolerant checkpointing in the reference's on-disk format.

Counterpart of ``repro.train.checkpoint``, with its guarantees:

  * **atomicity** — write to ``<dir>/tmp.<step>.<pid>.<n>``, fsync every
    file, then a single ``os.rename`` to ``step_<n>`` (rename is atomic
    on POSIX);
  * **integrity** — a manifest records per-leaf crc32 + dtype + shape;
    restore verifies before handing anything to the trainer, and falls
    back to the previous checkpoint on corruption;
  * **keep policy** — keep the newest ``keep`` checkpoints + every
    ``keep_period``-th for archival; a step whose writer is still inside
    :func:`save` is never reaped (the in-flight registry);
  * **async** — :func:`save_async` copies every leaf to host memory now
    and writes on a daemon thread, so the train loop is blocked only for
    the copy.  The port updates parameters in place, so the snapshot
    is a copy even of a CPU tensor (``.cpu()`` would alias it).

Layout:   <root>/step_000000123/{manifest.json, leaves.msgpack[.zst]}

The format is the reference's (format 1): the manifest lists each leaf's
name (``jax.tree_util.keystr`` of its path), dtype (numpy's name, e.g.
``"bfloat16"``), shape, crc32 and nbytes, and the body is the leaves'
raw bytes in that order, each one msgpack ``bin`` object.  The port
frames ``bin8/16/32`` itself rather than importing ``msgpack``, and
writes ``compression: "none"``; it reads a ``zstd`` body only where
``zstandard`` imports, and raises as the reference does otherwise.  A
tree is flattened as ``jax.tree_util`` flattens it: dicts by sorted key
(``['k']``), NamedTuples by field (``.f``), lists and tuples by index
(``[i]``); ``None`` holds no leaf.  So a checkpoint written by either
package restores in the other.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

_tmp_counter = itertools.count()

_BODY = {"zstd": "leaves.msgpack.zst", "none": "leaves.msgpack"}

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_DTYPE_NAMES = {t: n for n, t in _DTYPES.items()}

# msgpack bin8 / bin16 / bin32: a type byte, then the length big-endian
_BIN = ((0xC4, 1), (0xC5, 2), (0xC6, 4))


def atomic_json_dump(path: str, obj) -> None:
    """Write ``obj`` as JSON at ``path`` atomically: stage to a
    pid-unique tmp file, fsync, rename over the target (POSIX-atomic).
    Readers see the old file or the new one, never a torn write."""
    tmp = f"{path}.tmp.{os.getpid()}.{next(_tmp_counter)}"
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ------------------------------ trees ------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(keystr name, leaf)] in ``jax.tree_util``'s leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [e for k in sorted(tree)
                for e in tree_flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [e for f, v in zip(tree._fields, tree)
                for e in tree_flatten(v, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree)
                for e in tree_flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _host_tensor(leaf, copy: bool) -> torch.Tensor:
    """``leaf`` (a tensor, numpy array or number) as a contiguous CPU
    tensor; a copy where ``copy`` is set, whatever its device."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
    else:
        t = torch.from_numpy(np.array(leaf, copy=True))
    return t.contiguous()


def _bin_header(n: int) -> bytes:
    for code, width in _BIN:
        if n < 1 << (8 * width):
            return bytes([code]) + n.to_bytes(width, "big")
    raise ValueError(f"a msgpack bin object holds < 2**32 bytes, not {n}")


def _read_bins(body: memoryview, count: int):
    """The first ``count`` msgpack bin objects of ``body``, as memoryview
    slices; raises ``IOError`` on another type or a truncated body."""
    out, off = [], 0
    widths = dict(_BIN)
    while len(out) < count and off < len(body):
        width = widths.get(body[off])
        if width is None:
            raise IOError(f"byte {off} of the body is no msgpack bin object")
        n = int.from_bytes(body[off + 1:off + 1 + width], "big")
        start = off + 1 + width
        if start + n > len(body):
            raise IOError("truncated checkpoint body")
        out.append(body[start:start + n])
        off = start + n
    return out


# Steps with a writer currently inside ``save`` (committed-but-not-
# returned included), keyed by absolute root.  The keep policy must
# never reap a step whose writer is still in flight: a slow async
# writer that just renamed its step could otherwise lose it to a
# concurrent (newer) save's policy pass before its own call returns.
_inflight_lock = threading.Lock()
_inflight: dict[tuple[str, int], int] = {}


def _inflight_steps(root: str) -> set[int]:
    aroot = os.path.abspath(root)
    with _inflight_lock:
        return {s for (r, s), n in _inflight.items() if r == aroot and n > 0}


def save(root: str, step: int, tree, *, keep: int = 3,
         keep_period: int = 0) -> str:
    """Synchronous atomic checkpoint save (an uncompressed body).
    Returns the final directory."""
    os.makedirs(root, exist_ok=True)
    inflight_key = (os.path.abspath(root), step)
    with _inflight_lock:
        _inflight[inflight_key] = _inflight.get(inflight_key, 0) + 1
    try:
        return _save_locked(root, step, tree, keep=keep,
                            keep_period=keep_period)
    finally:
        with _inflight_lock:
            _inflight[inflight_key] -= 1
            if _inflight[inflight_key] <= 0:
                del _inflight[inflight_key]


def _save_locked(root: str, step: int, tree, *, keep: int,
                 keep_period: int) -> str:
    # tmp name unique per CALL (pid + counter): a sync save may race a
    # pending async save of the same step; both must stage independently.
    tmp = os.path.join(root,
                       f"tmp.{step}.{os.getpid()}.{next(_tmp_counter)}")
    final = os.path.join(root, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "format": 1, "compression": "none",
                "leaves": []}
    body_path = os.path.join(tmp, _BODY["none"])
    with open(body_path, "wb") as f:
        for name, leaf in tree_flatten(tree):
            t = _host_tensor(leaf, copy=False)
            buf = t.reshape(-1).view(torch.uint8).numpy()
            manifest["leaves"].append({
                "name": name,
                "dtype": _DTYPE_NAMES[t.dtype],
                "shape": list(t.shape),
                "crc32": zlib.crc32(buf) & 0xFFFFFFFF,
                "nbytes": buf.nbytes,
            })
            f.write(_bin_header(buf.nbytes))
            f.write(buf.data)
        f.flush()
        os.fsync(f.fileno())
    man_path = os.path.join(tmp, "manifest.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    try:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except OSError:
        # a concurrent writer (async save of the same step) won the
        # rename race; its checkpoint is equivalent — discard our stage.
        shutil.rmtree(tmp, ignore_errors=True)
    _apply_keep_policy(root, keep, keep_period)
    return final


_pending: list[threading.Thread] = []


def save_async(root: str, step: int, tree, **kw) -> threading.Thread:
    """Copy every leaf to host memory now; write on a daemon thread.  A
    later in-place update of the tree does not reach the pending save."""
    snapshot = tree_unflatten(tree, [_host_tensor(leaf, copy=True)
                                     for _, leaf in tree_flatten(tree)])
    t = threading.Thread(target=save, args=(root, step, snapshot),
                         kwargs=kw, daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    for t in _pending:
        t.join()
    _pending.clear()


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_"):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def _read_body(path: str, compression: str) -> memoryview:
    if compression == "zstd":
        try:
            import zstandard
        except ImportError:
            raise ImportError(
                f"checkpoint {path} is zstd-compressed but the `zstandard` "
                "package is not installed") from None
        with open(os.path.join(path, _BODY["zstd"]), "rb") as f:
            return memoryview(
                zstandard.ZstdDecompressor().decompressobj().decompress(
                    f.read()))
    with open(os.path.join(path, _BODY[compression]), "rb") as f:
        return memoryview(f.read())


def _verify_and_load(path: str, like_tree):
    """(step, ``like_tree``'s structure holding the checkpoint's leaves as
    CPU tensors); raises on a bad checksum, a truncated body, or leaves
    whose count, names or shapes are not ``like_tree``'s."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    # format-1 checkpoints predate the compression field and are zstd.
    compression = manifest.get("compression", "zstd")
    if compression not in _BODY:
        raise IOError(f"unknown compression {compression!r}")
    metas = manifest["leaves"]
    bufs = _read_bins(_read_body(path, compression), len(metas))
    if len(bufs) != len(metas):
        raise IOError("truncated checkpoint body")
    like = tree_flatten(like_tree)
    if len(like) != len(metas):
        raise IOError(f"leaf count mismatch: tree wants {len(like)}, "
                      f"checkpoint has {len(metas)}")
    leaves = []
    for meta, buf, (name, like_leaf) in zip(metas, bufs, like):
        if (zlib.crc32(buf) & 0xFFFFFFFF) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {meta['name']}")
        if meta["name"] != name:
            raise IOError(f"leaf {meta['name']} where the tree has {name}")
        shape = tuple(meta["shape"])
        if tuple(getattr(like_leaf, "shape", shape)) != shape:
            raise IOError(f"{name}: shape {shape}, the tree wants "
                          f"{tuple(like_leaf.shape)}")
        dtype = _DTYPES[meta["dtype"]]
        if len(buf):
            raw = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
            leaves.append(raw.view(dtype).reshape(shape))
        else:
            leaves.append(torch.empty(shape, dtype=dtype))
    return manifest["step"], tree_unflatten(like_tree, leaves)


def restore_latest(root: str, like_tree):
    """Restore the newest *valid* checkpoint (walks backward past corrupt
    ones — the node-failure recovery path).  Returns (step, tree) with
    CPU tensor leaves, or (None, None) when nothing restorable exists."""
    for step in reversed(list_steps(root)):
        path = os.path.join(root, f"step_{step:09d}")
        try:
            return _verify_and_load(path, like_tree)
        except Exception:
            continue
    return None, None


def _apply_keep_policy(root: str, keep: int, keep_period: int):
    steps = list_steps(root)
    if keep <= 0 or len(steps) <= keep:
        return
    protected = set(steps[-keep:])
    if keep_period:
        protected |= {s for s in steps if s % keep_period == 0}
    # Steps whose writer is still inside ``save`` are untouchable even
    # when outside the keep window — the next policy pass (with every
    # writer returned) reaps them.  ignore_errors also covers two
    # concurrent policy passes racing to delete the same step.
    protected |= _inflight_steps(root)
    for s in steps:
        if s not in protected:
            shutil.rmtree(os.path.join(root, f"step_{s:09d}"),
                          ignore_errors=True)
