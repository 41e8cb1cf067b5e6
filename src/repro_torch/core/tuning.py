"""Shape-keyed autotuner for the kernel-backed hot paths.

Counterpart of ``repro.core.tuning``.  Every tunable knob of the pruning
and serving paths is resolved here from (problem shape, platform, the
card's limits) instead of being fixed at the call sites:

* ``shortlist`` / ``rescan_every`` — the exact shortlist schedule,
  K ~ sqrt(m) with R = K - 1 on every platform (per-step work O(N*K)
  against the amortized O(N*m / R) rescan; the exactness bound
  K >= R + 1 holds by construction);
* ``block_docs`` — on ``cuda`` the documents a CUDA block takes along
  the doc axis of B1 and B2 (``maxsim_top2``/``maxsim_topk``) and of B3
  and B5 (the ``colbert_maxsim`` multi sweeps): the launch argument of
  those kernels, about four blocks an SM (``kernels.build.docs_per_block``)
  by default.  A document's arithmetic does not depend on how documents
  are grouped into blocks, so no output depends on it;
* ``block_s`` / ``block_t`` / ``block_q`` — on ``cuda`` the kernels'
  compile-time tiles, reported and never raced: 128 samples and 64
  tokens (B1, B2), B3's two warpgroups of floor(64 / l) queries;
* ``chunk_docs`` — the doc slab each streaming top-k step scores then
  reduces, 1,024 on every platform (the reference's off-TPU rule sizes
  an interpreter slab that the port's plain scorer, working in 64-doc
  blocks, never builds).

Off the card (``cpu``, and ``meta`` for the dry run) the kernels run
their plain versions, which ignore the tiles; there the heuristic is
the reference's off-TPU rule, field for field except ``chunk_docs``.

* **heuristic mode** (default): pure and deterministic — the same shape
  and card in, the same :class:`KernelConfig` out.
* **measured mode** (``measure=True`` or ``REPRO_AUTOTUNE=measure``): a
  one-shot race of a small candidate grid on seeded synthetic data of
  the key's shape, timed with CUDA events on the card (the plain
  versions on the host clock elsewhere), cached in-process so each
  (kind, platform, shape bucket) pays it once.  A candidate that fails
  to build or launch raises; the race never falls back to the
  heuristic.

The platform is the type of the device the call runs on (``"cuda"`` or
``"cpu"``).  The cache persists as JSON (:func:`dump_cache` /
:func:`load_cache`, the reference's format 2, so files cross between the
two packages), and ``REPRO_AUTOTUNE_CACHE`` automates both: the file
loads before the first :func:`tune` and is re-dumped (atomic
tmp+rename, merged under an ``O_EXCL`` lockfile) after every race.

Shapes are bucketed: powers of two on the sample, doc and query counts,
exact on the per-document axes (m, l, dim) and on float and string
entries (a router threshold, a codec tag).  A bucket's heuristic is
computed from the first shape resolved in it; the doc block it holds
then serves every shape of the bucket (outputs are bit-equal for any
doc block).

Consumers reach this module through the backend seam
(``core.backend.tuned*``): explicit arguments always win; the tuner
fills only ``None``s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.kernels import build
from repro_torch.kernels.colbert_maxsim import ops as cm_ops
from repro_torch.kernels.maxsim_topk import ops as topk_ops

__all__ = [
    "KernelConfig",
    "cache_info",
    "card_limits",
    "clear_cache",
    "dump_cache",
    "heuristic_config",
    "load_cache",
    "race_info",
    "shape_key",
    "tune",
]

_ENV_VAR = "REPRO_AUTOTUNE"
_CACHE_ENV_VAR = "REPRO_AUTOTUNE_CACHE"
# 2: KernelConfig has ``chunk_docs``; format-1 files load (the field
# defaults), format-2 files refuse older readers.
_CACHE_FORMAT = 2

# Off the card the reference's off-TPU working-set budget sizes the
# reported tiles, so the plain heuristic equals the reference's.
WORKING_SET_BUDGET = 64 * 1024 * 1024
# The streaming top-k slab (docs a merge step scores then reduces).
CHUNK_DOCS = 1024
# Timed turns over a race's candidates: a pruning run is a whole greedy
# pruning of a bucket (seconds on the card); a serving sweep takes under
# a millisecond, so the least of five turns keeps one host stall inside
# a candidate's events from deciding the race.
PRUNING_REPS = 1
SERVING_REPS = 5

KINDS = ("pruning", "serving")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Resolved knobs for one hot-path invocation: pruning consumers read
    ``shortlist``/``rescan_every`` and ``block_docs`` (B1, B2); serving
    consumers ``block_docs`` (B3, B5) and, on the streaming top-k,
    ``chunk_docs``.  ``block_s``/``block_t``/``block_q`` report tiles."""

    block_s: int = 256
    block_t: int = 128
    block_docs: int = 8
    block_q: int = 16
    shortlist: int = 8
    rescan_every: int = 7
    chunk_docs: int = CHUNK_DOCS

    def validate(self) -> "KernelConfig":
        if self.shortlist < self.rescan_every + 1:
            raise ValueError(
                f"invalid config: shortlist={self.shortlist} < "
                f"rescan_every={self.rescan_every} + 1 (exactness bound)")
        for f in dataclasses.fields(self):
            if getattr(self, f.name) < 1:
                raise ValueError(f"invalid config: {f.name} < 1")
        return self


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def shape_key(kind: str, shape: dict, *, platform: str,
              measured: bool = False) -> tuple:
    """Canonical cache key: (kind, platform, mode, bucketed shape).
    ``n_samples``, ``n_docs`` and ``n_q`` bucket to powers of two; other
    int entries stay exact, float and str entries pass through."""
    if kind not in KINDS:
        raise ValueError(f"unknown tuning kind {kind!r}; one of {KINDS}")
    bucketed = []
    for name in sorted(shape):
        raw = shape[name]
        v = (raw if isinstance(raw, str)
             else float(raw) if isinstance(raw, float) else int(raw))
        if name in ("n_samples", "n_docs", "n_q"):
            v = _pow2_at_least(max(int(v), 1))
        bucketed.append((name, v))
    return (kind, platform, "measured" if measured else "heuristic",
            tuple(bucketed))


def _shortlist(m: int) -> tuple[int, int]:
    """(K, R): K ~ sqrt(m), a power of two in [4, 32], at most max(m, 2);
    R = K - 1."""
    k = _pow2_at_least(max(int(m ** 0.5), 2))
    k = max(4, min(32, k))
    k = min(k, max(m, 2))
    return k, max(1, k - 1)


def _pruning_heuristic(shape: dict, platform: str, budget: int,
                       sms: int | None) -> KernelConfig:
    n = int(shape.get("n_samples", 2048))
    m = int(shape.get("m", 128))
    dim = int(shape.get("dim", 128))
    k, rescan = _shortlist(m)
    if platform == "cuda":
        n_docs = int(shape.get("n_docs", 1))
        return KernelConfig(
            block_s=topk_ops.ROWS, block_t=topk_ops.TILE,
            block_docs=build.docs_per_block(n_docs, 1,
                                            -(-n // topk_ops.ROWS), sms),
            shortlist=k, rescan_every=rescan).validate()
    # the reference's tiles: token tile lane-aligned, sample tile shrunk
    # until (samples + tokens + scores) f32 tiles fit the budget
    block_t = min(512, max(8, _round_up(min(m, 512), 128)))
    block_s = min(1024, max(8, _round_up(min(n, 256), 8)))
    while block_s > 8 and 4 * (block_s * dim + block_t * dim
                               + block_s * block_t) > budget:
        block_s //= 2
    return KernelConfig(block_s=block_s, block_t=block_t,
                        shortlist=k, rescan_every=rescan).validate()


def _launch_docs(shape: dict) -> int:
    """Docs one multi-sweep launch scores: a streaming key (it carries the
    merge fan-in ``k``) scores one ``chunk_docs`` slab of its shard-local
    slice at a time, any other key the whole doc array."""
    n_docs = int(shape.get("n_docs", 256))
    n_local = -(-n_docs // max(1, int(shape.get("n_shards", 1))))
    return min(CHUNK_DOCS, n_local) if "k" in shape else n_local


def _serving_heuristic(shape: dict, platform: str, budget: int,
                       sms: int | None) -> KernelConfig:
    n_q = int(shape.get("n_q", 16))
    n_docs = int(shape.get("n_docs", 256))
    m = int(shape.get("m", 128))
    l = int(shape.get("l", 32))
    dim = int(shape.get("dim", 128))
    if platform == "cuda":
        bf16 = shape.get("codec") == "bf16"
        return KernelConfig(
            block_s=topk_ops.ROWS, block_t=topk_ops.TILE,
            block_docs=build.docs_per_block(
                _launch_docs(shape), cm_ops.tile_group(m, bf16),
                cm_ops.query_blocks(n_q, l), sms),
            block_q=2 * max(1, cm_ops.L_MAX // l)).validate()
    # the reference's off-TPU rule: the largest power-of-two doc block
    # whose (docs + queries + scores) f32 tiles fit the budget, capped
    # at the shard-local doc count
    n_local = -(-n_docs // max(1, int(shape.get("n_shards", 1))))
    block_q = min(_pow2_at_least(max(n_q, 1)), 32)
    block_docs = 128
    while block_docs > 4 and 4 * (block_docs * m * dim + block_q * l * dim
                                  + block_docs * m * block_q * l) > budget:
        block_docs //= 2
    block_docs = min(block_docs, _pow2_at_least(max(n_local, 1)))
    return KernelConfig(block_docs=max(block_docs, 1),
                        block_q=max(block_q, 1)).validate()


def heuristic_config(kind: str, *, platform: str, sm_count: int | None = None,
                     budget: int | None = None, **shape) -> KernelConfig:
    """Static config for (kind, shape, platform).  Pure.  ``cuda`` needs
    the card's ``sm_count``; off the card ``budget`` (default
    :data:`WORKING_SET_BUDGET`) sizes the reported tiles."""
    if kind not in KINDS:
        raise ValueError(f"unknown tuning kind {kind!r}; one of {KINDS}")
    if platform == "cuda" and not sm_count:
        raise ValueError("the cuda heuristic needs the card's sm_count")
    budget = WORKING_SET_BUDGET if budget is None else budget
    rule = _pruning_heuristic if kind == "pruning" else _serving_heuristic
    return rule(shape, platform, budget, sm_count)


def card_limits(device) -> dict:
    """The card's SM count and the shared memory a block may opt into
    (``torch.cuda.get_device_properties``)."""
    props = torch.cuda.get_device_properties(device)
    return {"sm_count": props.multi_processor_count,
            "smem_optin": props.shared_memory_per_block_optin}


def kernel_smem(kind: str, shape: dict) -> dict:
    """Dynamic shared memory of a block of each kernel ``kind`` launches,
    read from the kernels' sources (builds them on first use)."""
    if kind == "pruning":
        return {"maxsim_topk": build.library("maxsim_topk").maxsim_topk_smem(),
                "maxsim_top2": build.library("maxsim_top2").maxsim_top2_smem()}
    bf16 = int(shape.get("codec") == "bf16")
    return {"colbert_maxsim_multi": build.library(
        "colbert_maxsim").colbert_maxsim_multi_smem(bf16)}


def _cuda_heuristic(kind: str, shape: dict, device) -> KernelConfig:
    """The heuristic on ``device``'s card, after checking that a block of
    each kernel the kind launches fits its opt-in shared memory."""
    limits = card_limits(device)
    for name, smem in kernel_smem(kind, shape).items():
        if smem > limits["smem_optin"]:
            raise ValueError(
                f"{name} needs {smem} bytes of shared memory a block; "
                f"{torch.cuda.get_device_name(device)} allows "
                f"{limits['smem_optin']}")
    return heuristic_config(kind, platform="cuda",
                            sm_count=limits["sm_count"], **shape)


# ----------------------------------------------------------------------
# The in-process cache, its file, and measured mode.
# ----------------------------------------------------------------------

_CACHE: dict[tuple, KernelConfig] = {}
# Each race's candidates and times, by measured key (race_info()).
_RACES: dict[tuple, list] = {}
_env_cache_loaded = False
# One lock for every compound _CACHE mutation (merges, races, loads).
# Races serialize under it by design: two at once would poison each
# other's timings.  Reentrant: a race re-dumps the env cache file.
_CACHE_LOCK = threading.RLock()

# dump_cache's lockfile: a bounded retry, then the lock is presumed
# orphaned by a crashed writer and broken.
_LOCK_RETRIES = 50
_LOCK_RETRY_S = 0.02


@contextlib.contextmanager
def _file_lock(path: str):
    """``O_EXCL`` lockfile ``path + ".lock"`` held across a dump's read,
    merge and rename, so two processes dumping at once cannot drop each
    other's entries.  After ``_LOCK_RETRIES`` x ``_LOCK_RETRY_S`` it is
    presumed orphaned and broken."""
    lock_path = path + ".lock"
    for _ in range(_LOCK_RETRIES):
        try:
            fd = os.open(lock_path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            break
        except FileExistsError:
            time.sleep(_LOCK_RETRY_S)
    else:
        try:
            os.unlink(lock_path)
        except FileNotFoundError:
            pass
        fd = os.open(lock_path, os.O_CREAT | os.O_WRONLY)
    try:
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        yield
    finally:
        try:
            os.unlink(lock_path)
        except FileNotFoundError:
            pass


def _key_to_jsonable(key: tuple) -> dict:
    kind, platform, mode, shape = key
    return {"kind": kind, "platform": platform, "mode": mode,
            "shape": [[n, v] for n, v in shape]}


def _key_from_jsonable(d: dict) -> tuple:
    return (str(d["kind"]), str(d["platform"]), str(d["mode"]),
            tuple((str(n), v if isinstance(v, str)
                   else float(v) if isinstance(v, float) else int(v))
                  for n, v in d["shape"]))


def _read_entries(path: str) -> dict[tuple, KernelConfig]:
    """Parse a :func:`dump_cache` file; every config is re-validated."""
    with open(path) as f:
        payload = json.load(f)
    if payload.get("format", 0) > _CACHE_FORMAT:
        raise IOError(f"{path}: tuning-cache format {payload['format']} is "
                      f"newer than this reader (format {_CACHE_FORMAT})")
    return {_key_from_jsonable(e["key"]): KernelConfig(**e["config"]).validate()
            for e in payload.get("entries", [])}


def dump_cache(path: str, *, merge: bool = True) -> int:
    """Write the in-process cache to ``path`` as JSON (atomic tmp+rename)
    and return the number of entries written.  ``merge=True`` first
    folds in the file's entries this process does not hold (in-process
    entries win), under the lockfile and ``_CACHE_LOCK``; ``merge=False``
    writes exactly the in-process snapshot."""
    from repro_torch.train.checkpoint import atomic_json_dump
    with _file_lock(path):
        with _CACHE_LOCK:
            if merge and os.path.exists(path):
                for key, cfg in _read_entries(path).items():
                    _CACHE.setdefault(key, cfg)
            payload = {
                "format": _CACHE_FORMAT,
                "entries": [{"key": _key_to_jsonable(k),
                             "config": dataclasses.asdict(v)}
                            for k, v in _CACHE.items()],
            }
        atomic_json_dump(path, payload)
    return len(payload["entries"])


def load_cache(path: str) -> int:
    """Merge a :func:`dump_cache` file into the in-process cache (the
    file's entries win) and return the number of entries merged."""
    entries = _read_entries(path)
    with _CACHE_LOCK:
        _CACHE.update(entries)
    return len(entries)


def _maybe_load_env_cache() -> None:
    """Load the ``REPRO_AUTOTUNE_CACHE`` file once, if set and present."""
    global _env_cache_loaded
    with _CACHE_LOCK:
        if _env_cache_loaded:
            return
        _env_cache_loaded = True
        path = os.environ.get(_CACHE_ENV_VAR)
        if path and os.path.exists(path):
            load_cache(path)


def _time_ms(fn, device) -> float:
    """One run of ``fn``: CUDA events around it on the card, from an idle
    card (so no candidate's host time hides under the work queued before
    it), the host clock elsewhere."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)


def _race(cands, run, device, log, reps: int) -> KernelConfig:
    """Time ``run(cand)`` for each config of ``cands`` in ``reps`` turns
    over all of them (after one warm-up run of the first) and return the
    one of least time (the first on a tie); each candidate's knobs,
    least ms and runs go to ``log``."""
    run(cands[0])
    times = [[] for _ in cands]
    for _ in range(reps):
        for cand, ts in zip(cands, times):
            ts.append(_time_ms(lambda: run(cand), device))
    for cand, ts in zip(cands, times):
        log.append({"shortlist": cand.shortlist,
                    "block_docs": cand.block_docs, "ms": min(ts),
                    "runs": ts})
    return cands[min(range(len(cands)), key=lambda i: min(times[i]))]


def _measure_pruning(shape: dict, base: KernelConfig, device,
                     log: list) -> KernelConfig:
    """Race K in {K/2, K, 2K} (R = K - 1) on the ``shortlist_topk`` path
    over a bucket of the key's shape, then ``block_docs`` in {1/2, 1, 2}
    x the heuristic's at the winning K."""
    from repro_torch.core import sampling, voronoi

    n = int(shape.get("n_samples", 2048))
    m = int(shape.get("m", 128))
    dim = int(shape.get("dim", 128))
    n_docs = int(shape.get("n_docs", 1))
    g = torch.Generator(device=device).manual_seed(0)
    d = torch.randn((n_docs, m, dim), generator=g, device=device)
    masks = torch.ones((n_docs, m), dtype=torch.bool, device=device)
    samples = sampling.sample_sphere(g, n, dim)

    def run(cand):
        # every knob pinned: an unpinned one would consult the tuner on
        # the key being raced
        return voronoi._pruning_order_shortlist(
            d, masks, samples, shortlist=cand.shortlist,
            rescan_every=cand.rescan_every, rescan="topk",
            block_docs=cand.block_docs)

    ks = sorted({max(2, min(k, m, topk_ops.K_MAX)) for k in
                 (base.shortlist // 2, base.shortlist, base.shortlist * 2)})
    best = _race([dataclasses.replace(base, shortlist=k, rescan_every=k - 1)
                  for k in ks], run, device, log, PRUNING_REPS)
    bds = sorted({max(1, bd) for bd in (base.block_docs // 2,
                                        base.block_docs,
                                        base.block_docs * 2)})
    return _race([dataclasses.replace(best, block_docs=bd) for bd in bds],
                 run, device, log, PRUNING_REPS)


def _race_index(codec, d, masks):
    """A serving index of ``d`` in the key's codec: fp32 or bf16 dense
    docs, or a one-bucket int8 or residual pack."""
    from repro_torch.serve.index import PackedIndex
    from repro_torch.serve.retrieval import TokenIndex

    if codec is None:
        return TokenIndex.build(d, masks)
    if codec == "bf16":
        return TokenIndex.build(d.bfloat16(), masks)
    if codec == "int8":
        return PackedIndex.pack(d, masks, compression="int8")
    if codec.startswith("residual"):
        return PackedIndex.pack(d, masks, compression="residual",
                                residual_bits=int(codec[len("residual"):]))
    raise ValueError(f"unknown codec tag {codec!r}")


def _measure_serving(shape: dict, base: KernelConfig, device,
                     log: list) -> KernelConfig:
    """Race ``block_docs`` in {1/2, 1, 2} x the heuristic through
    ``maxsim_scores(backend="fused")`` on one launch's docs (a streaming
    key's slab) in the key's codec."""
    from repro_torch.serve import retrieval

    n_q = int(shape.get("n_q", 16))
    m = int(shape.get("m", 128))
    l = int(shape.get("l", 32))
    dim = int(shape.get("dim", 128))
    n_docs = _launch_docs(shape)
    g = torch.Generator(device=device).manual_seed(0)
    d = torch.randn((n_docs, m, dim), generator=g, device=device)
    masks = torch.ones((n_docs, m), dtype=torch.bool, device=device)
    q = torch.randn((n_q, l, dim), generator=g, device=device)
    index = _race_index(shape.get("codec"), d, masks)

    def run(cand):
        return retrieval.maxsim_scores(index, q, backend="fused",
                                       block_docs=cand.block_docs)

    bds = sorted({max(1, min(bd, n_docs)) for bd in
                  (base.block_docs // 2, base.block_docs,
                   base.block_docs * 2)})
    return _race([dataclasses.replace(base, block_docs=bd) for bd in bds],
                 run, device, log, SERVING_REPS)


def tune(kind: str, *, device=None, measure: bool | None = None,
         **shape) -> KernelConfig:
    """Resolve a :class:`KernelConfig` for (kind, shape) on ``device``
    (``cuda`` unless given; its type is the platform).

    ``measure=None`` reads ``REPRO_AUTOTUNE`` (``"measure"`` races;
    anything else stays heuristic).  Results are cached per (kind,
    platform, mode, shape bucket): the heuristic is memoized, the race
    runs once a key.  Call it outside a served batch: measured mode
    launches real work."""
    if measure is None:
        measure = os.environ.get(_ENV_VAR, "").lower() == "measure"
    device = backend_lib.resolve_device(device)
    platform = device.type
    _maybe_load_env_cache()
    key = shape_key(kind, shape, platform=platform, measured=measure)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit

    def heuristic():
        if platform == "cuda":
            return _cuda_heuristic(kind, shape, device)
        return heuristic_config(kind, platform=platform, **shape)

    if not measure:
        # pure: two threads filling one key store equal values, so a
        # GIL-atomic store suffices and the hot path takes no lock
        cfg = heuristic()
        _CACHE[key] = cfg
        return cfg
    with _CACHE_LOCK:
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
        # seed the key with the heuristic first: a consult of this key
        # from inside the race gets it instead of racing again
        cfg = _CACHE[key] = heuristic()
        log = []
        measure_fn = (_measure_pruning if kind == "pruning"
                      else _measure_serving)
        cfg = measure_fn(shape, cfg, device, log).validate()
        _CACHE[key] = cfg
        _RACES[key] = log
        path = os.environ.get(_CACHE_ENV_VAR)
        if path:
            dump_cache(path)
    return cfg


def clear_cache() -> None:
    global _env_cache_loaded
    with _CACHE_LOCK:
        _CACHE.clear()
        _RACES.clear()
        _env_cache_loaded = False


def cache_info() -> dict[tuple, KernelConfig]:
    """Snapshot of the in-process tuning cache."""
    with _CACHE_LOCK:
        return dict(_CACHE)


def race_info() -> dict[tuple, list]:
    """Each measured key's race this process ran: a list of
    ``{"shortlist", "block_docs", "ms", "runs"}`` per candidate timed
    (``ms`` the least of its ``runs``)."""
    with _CACHE_LOCK:
        return {k: list(v) for k, v in _RACES.items()}
