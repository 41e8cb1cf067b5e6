"""Live index mutation of the PyTorch port against the JAX reference.

* **The delta oracle**: serving a ``DeltaLog`` view — base epoch +
  delta buckets + tombstones, stale ids masked to -inf inside each
  slab — equals, bit for bit, a from-scratch repack of the mutated
  corpus (upserts, shadowing, deletes, resurrection, everything
  deleted), and equals the reference's view within 1e-5 (ids equal
  beyond that gap).  Duplicate ids in a batch are refused.
* **Compaction**: bit-equal to an offline repack for ``none`` and
  ``int8``; a residual base re-encodes; a placed artifact rebalances.
* **Durability**: the WAL-logged lifecycle on disk, read by both
  packages; every one of the 11 ``CRASH_POINTS`` as a real SIGKILL in
  a spawned child process, then ``recover``: the artifact lands on the
  bitwise pre- or post-mutation epoch with zero orphans.
* **Serving and the launcher**: ``apply_mutation``, the epoch swap,
  routed ``bounded`` under mutation equal to exhaustive, and
  ``serve_retrieval(index_dir=..., upsert=, delete=, compact=)`` at
  SMOKE against the reference's run with its weights carried across.
"""

import inspect
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sampling import sample_sphere as j_sample_sphere
from repro.launch.serve import serve_retrieval as j_serve_retrieval
from repro.serve import index_io as j_io
from repro.serve import mutation as j_mut
from repro.serve import retrieval as j_ret
from repro.serve.index import PackedIndex as JPackedIndex
from repro_torch.configs import colbert_base
from repro_torch.launch.serve import serve_retrieval
from repro_torch.serve import index_io, mutation, retrieval
from repro_torch.serve.index import PackedIndex
from repro_torch.serve.retrieval import RetrievalServer, topk_search
from repro_torch.serve.routing import RoutingIndex
from repro_torch.sharding import PlacementPlan
from test_torch_index_io import _assert_topk
from test_torch_models import J_SMOKE, _port

ROOT = os.path.join(os.path.dirname(__file__), "..")
UPSERT = ([3, 7, 11, 24, 25, 26], 1)      # (ids, corpus seed)
DELETE = [5, 9, 25]


def _corpus(seed=0, n=24, m=12, dim=16, p=0.8):
    """Unit tokens, random masks, doc 2 empty after pruning."""
    rng = np.random.default_rng(seed)
    embs = rng.normal(size=(n, m, dim)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=-1, keepdims=True)
    masks = rng.random((n, m)) < p
    if n > 2:
        masks[2] = False
    return embs, masks


def _queries(seed=99, n_q=4, l=6, dim=16):
    q = np.random.default_rng(seed).normal(size=(n_q, l, dim))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _pack(embs, masks, **kw):
    return PackedIndex.pack(torch.tensor(embs), torch.tensor(masks), **kw)


def _bitwise(a, b, msg=""):
    assert torch.equal(a[0], b[0]), f"{msg}: ids diverge"
    assert torch.equal(a[1], b[1]), f"{msg}: scores diverge"


def _view_topk(log, q, k):
    return topk_search(log.base, torch.tensor(q), k=k, mutation=log.view())


def _oracle_topk(log, q, k, compression="none"):
    """Re-pack the mutated corpus from scratch: the oracle the delta view
    must match bit for bit."""
    embs, masks, ids = mutation.materialize(log)
    repacked = mutation._pack_with_ids(
        embs, masks, ids, log.n_total, compression=compression,
        granularity="pow2", min_width=8)
    return topk_search(repacked, torch.tensor(q), k=k)


def _both_logs(ops, compression="none", **kw):
    """The same op list applied to a port and a reference DeltaLog."""
    embs, masks = _corpus()
    log = mutation.DeltaLog(base=_pack(embs, masks, compression=compression,
                                       **kw))
    jlog = j_mut.DeltaLog(base=JPackedIndex.pack(
        jnp.asarray(embs), jnp.asarray(masks), compression=compression,
        **kw))
    for op, arg in ops:
        if op == "upsert":
            ids, seed = arg
            ue, um = _corpus(seed, n=len(ids))
            log.upsert(ue, um, ids)
            jlog.upsert(ue, um, ids)
        else:
            log.delete(arg)
            jlog.delete(arg)
    return log, jlog


class TestDeltaOracle:
    CASES = {
        "upsert": [("upsert", UPSERT)],
        "shadow_delete": [("upsert", ([3, 7, 24, 25], 1)),
                          ("delete", [5, 7, 25]),
                          ("upsert", ([3, 9], 2))],
        "resurrect": [("delete", [4]), ("upsert", ([4], 3))],
    }

    @pytest.mark.parametrize("case", list(CASES))
    def test_view_equals_repack_and_reference(self, case):
        log, jlog = _both_logs(self.CASES[case])
        np.testing.assert_array_equal(log.owner_map(), jlog.owner_map())
        assert log.tombstones == jlog.tombstones
        assert log.n_live == jlog.n_live and log.n_total == jlog.n_total
        q = _queries()
        for k in (1, 5, 10, log.n_live, log.n_live + 7):
            got = _view_topk(log, q, k)
            _bitwise(got, _oracle_topk(log, q, k), f"{case} k={k}")
            _assert_topk(got, j_ret.topk_search(
                jlog.base, jnp.asarray(q), k=k, mutation=jlog.view()))

    def test_net_tombstones_and_owner(self):
        log, _ = _both_logs(self.CASES["shadow_delete"])
        assert log.tombstones == frozenset({5, 7, 25})
        assert log.n_live == 24 + 2 - 3
        log, _ = _both_logs(self.CASES["resurrect"])
        assert 4 not in log.tombstones and log.owner_map()[4] == 1
        v = log.view()
        assert v.owner.dtype == torch.int32 and v.n_live == 24

    def test_materialize_matches_reference(self):
        for compression in ("none", "int8"):
            log, jlog = _both_logs(self.CASES["shadow_delete"], compression)
            got, want = mutation.materialize(log), j_mut.materialize(jlog)
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            np.testing.assert_array_equal(got[1].numpy(), want[1])
            np.testing.assert_array_equal(got[2], want[2])

    def test_all_docs_deleted_serves_empty(self):
        embs, masks = _corpus(n=6)
        log = mutation.DeltaLog(base=_pack(embs, masks))
        log.delete(range(6))
        assert log.n_live == 0
        ids, vals = _view_topk(log, _queries(), 5)
        assert ids.shape == (4, 0) and vals.shape == (4, 0)

    def test_duplicate_ids_in_batch_rejected(self):
        embs, masks = _corpus(n=3)
        log = mutation.DeltaLog(base=_pack(embs, masks))
        with pytest.raises(ValueError, match="duplicate"):
            log.upsert(embs, masks, [1, 1, 2])
        with pytest.raises(ValueError, match=">= 0"):
            log.upsert(embs, masks, [-1, 1, 2])

    def test_ids_ascend_within_every_delta_bucket(self):
        log, _ = _both_logs([("upsert", ([26, 3, 25, 7, 24, 11], 1))])
        for b in log.deltas[0].buckets:
            ids = b.doc_ids.numpy()
            assert (np.diff(ids) > 0).all()

    def test_search_refusals(self):
        log, _ = _both_logs([("upsert", ([24, 25], 1))])
        q = torch.tensor(_queries())
        with pytest.raises(ValueError, match="streaming e2e"):
            retrieval.search(log.base, q, k=5, n_first=4,
                             mutation=log.view())
        with pytest.raises(ValueError, match="streaming-only"):
            retrieval.search(log.base, q, k=3, end_to_end=True,
                             return_full=True, mutation=log.view())

    def test_bf16_delta_stays_bf16_over_bf16_base(self):
        embs, masks = _corpus()
        log = mutation.DeltaLog(base=PackedIndex.pack(
            torch.tensor(embs).bfloat16(), torch.tensor(masks)))
        ue, um = _corpus(1, n=6)
        log.upsert(torch.tensor(ue).bfloat16(), torch.tensor(um), UPSERT[0])
        assert log.deltas[0].buckets[0].embs.dtype == torch.bfloat16
        e, m, i = mutation.materialize(log)
        assert e.dtype == torch.float32
        # every value came from a bf16 leaf: narrowing is exact
        rep = mutation._pack_with_ids(e.bfloat16(), m, i, log.n_total,
                                      compression="none",
                                      granularity="pow2", min_width=8)
        q = torch.tensor(_queries())
        _bitwise(topk_search(log.base, q, k=10, mutation=log.view()),
                 topk_search(rep, q, k=10), "bf16")


def test_merge_topk_unique_matches_reference():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 6, size=(5, 12)).astype(np.int32)
    scores = np.round(rng.normal(size=(5, 12)), 1).astype(np.float32)
    scores[0, :3] = -np.inf
    for k in (1, 4, 12):
        gi, gs = retrieval._merge_topk_unique(torch.tensor(scores),
                                              torch.tensor(ids), k)
        wi, ws = j_ret._merge_topk_unique(jnp.asarray(scores),
                                          jnp.asarray(ids), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


class TestCompaction:
    OPS = [("upsert", UPSERT), ("delete", [5, 25])]

    @pytest.mark.parametrize("compression", ["none", "int8"])
    def test_compact_bitwise_equals_offline_repack(self, compression):
        log, jlog = _both_logs(self.OPS, compression)
        compacted = mutation.compact_index(log)
        embs, masks, ids = mutation.materialize(log)
        offline = mutation._pack_with_ids(
            embs, masks, ids, log.n_total, compression=compression,
            granularity="pow2", min_width=8)
        q = torch.tensor(_queries())
        _bitwise(topk_search(compacted, q, k=10),
                 topk_search(offline, q, k=10), compression)
        _assert_topk(topk_search(compacted, q, k=10), j_ret.topk_search(
            j_mut.compact_index(jlog), jnp.asarray(_queries()), k=10))

    def test_compact_preserves_serving_bitwise(self):
        log, _ = _both_logs(self.OPS)
        compacted = mutation.compact_index(log)
        assert compacted.epoch == log.epoch + 1
        assert compacted.n_docs == log.n_total
        ids = torch.cat([b.doc_ids for b in compacted.buckets]).numpy()
        assert len(ids) == log.n_live and 5 not in ids and 25 not in ids
        q = _queries()
        _bitwise(_view_topk(log, q, 10),
                 topk_search(compacted, torch.tensor(q), k=10))

    def test_bf16_base_compacts_to_fp32(self):
        embs, masks = _corpus()
        log = mutation.DeltaLog(base=PackedIndex.pack(
            torch.tensor(embs).bfloat16(), torch.tensor(masks)))
        log.delete([5])
        compacted = mutation.compact_index(log)
        assert compacted.buckets[0].embs.dtype == torch.float32
        q = torch.tensor(_queries())
        _bitwise(topk_search(log.base, q, k=10, mutation=log.view()),
                 topk_search(compacted, q, k=10), "bf16 -> fp32")

    def test_residual_reencodes(self, tmp_path):
        embs, masks = _corpus(seed=7)
        path = str(tmp_path / "idx")
        base = _pack(embs, masks, compression="residual", residual_bits=4,
                     n_centroids=8)
        index_io.save_index(path, base)
        ue, um = _corpus(seed=9, n=4)
        mutation.append_upsert(path, ue, um, [1, 30, 31, 32])
        mutation.append_delete(path, [3])
        log = mutation.load_state(path, device="cpu")
        assert all(d.compression == "none" for d in log.deltas)
        sub = json.load(open(os.path.join(path,
                                          index_io._delta_manifest(0))))
        assert sub["format"] == 4
        q = _queries()
        # the mixed view (residual base leaf, fp32 delta) equals its
        # repack, the base decoded
        _bitwise(_view_topk(log, q, 5), _oracle_topk(log, q, 5), "mixed")
        new = mutation.Compactor(path, device="cpu").run()
        assert (new.epoch, new.compression, new.residual_bits,
                new.n_centroids) == (1, "residual", 4, 8)
        re = index_io.load_index(path, device="cpu")
        assert (re.compression, re.residual_bits, re.epoch) == (
            "residual", 4, 1)
        # re-encoded: a doc's own tokens still retrieve it
        qe = torch.tensor(ue[0][um[0]][None, :6])
        assert int(topk_search(re, qe, k=1)[0][0, 0]) == 1
        # and the reference reads the re-encoded epoch
        jre = j_io.load_index(path)
        assert jre.epoch == 1 and jre.compression == "residual"

    def test_compaction_rebalances_placed_artifact(self, tmp_path):
        path = str(tmp_path / "artifact")
        embs, masks = _corpus(n=32)
        packed = _pack(embs, masks)
        index_io.save_index(path, packed,
                            placement=PlacementPlan.for_index(packed, 2))
        ue, um = _corpus(seed=1, n=4)
        mutation.append_upsert(path, ue, um, [1, 2, 32, 33])
        new_index = mutation.Compactor(path, device="cpu").run()
        got = index_io.load_placement(path)
        assert got is not None and got.n_groups == 2
        got.validate(len(new_index.buckets))
        assert got.to_manifest() == PlacementPlan.for_index(
            new_index, 2).to_manifest()
        part = index_io.load_index(path, group=0, device="cpu")
        assert part.n_docs == new_index.n_docs
        assert index_io.list_orphans(path) == []
        assert j_io.load_placement(path).to_manifest() == got.to_manifest()


class TestDurability:
    def test_durable_lifecycle_read_by_both_packages(self, tmp_path):
        path = str(tmp_path / "artifact")
        embs, masks = _corpus()
        index_io.save_index(path, _pack(embs, masks))
        ue, um = _corpus(seed=1, n=6)
        assert mutation.append_upsert(path, ue, um, UPSERT[0]) == 0
        mutation.append_delete(path, [5, 25])
        mem, _ = _both_logs([("upsert", UPSERT), ("delete", [5, 25])])
        log = mutation.load_state(path, device="cpu")
        q = _queries()
        pre = _view_topk(log, q, 10)
        _bitwise(pre, _view_topk(mem, q, 10), "disk vs memory")
        jlog = j_mut.load_state(path)
        _assert_topk(pre, j_ret.topk_search(jlog.base, jnp.asarray(q), k=10,
                                            mutation=jlog.view()))

        new_index = mutation.Compactor(path, device="cpu").run()
        assert new_index is not None and new_index.epoch == 1
        assert index_io.load_epoch(path) == 1 == j_io.load_epoch(path)
        assert index_io.list_orphans(path) == []
        assert index_io.live_epoch_dir(path).endswith("epoch_000001")
        reloaded = index_io.load_index(path, device="cpu")
        _bitwise(pre, topk_search(reloaded, torch.tensor(q), k=10),
                 "post-compaction")
        assert mutation.load_state(path, device="cpu").ops == []
        assert index_io.recover(path) == {
            "rolled_forward": [], "rolled_back": [], "removed": []}
        assert mutation.Compactor(path, device="cpu").run() is None

    def test_reference_mutates_port_artifact(self, tmp_path):
        """A delta log the reference appends to a port-written artifact
        serves in the port as the reference serves it."""
        path = str(tmp_path / "artifact")
        embs, masks = _corpus()
        index_io.save_index(path, _pack(embs, masks))
        ue, um = _corpus(seed=1, n=6)
        j_mut.append_upsert(path, ue, um, UPSERT[0])
        j_mut.append_delete(path, DELETE)
        log = mutation.load_state(path, device="cpu")
        jlog = j_mut.load_state(path)
        q = _queries()
        _assert_topk(_view_topk(log, q, 10), j_ret.topk_search(
            jlog.base, jnp.asarray(q), k=10, mutation=jlog.view()))
        mutation.Compactor(path, device="cpu").run()
        assert index_io.list_orphans(path) == j_io.list_orphans(path) == []

    def test_upsert_keeps_the_batch_dtype(self, tmp_path):
        path = str(tmp_path / "artifact")
        embs, masks = _corpus()
        index_io.save_index(path, PackedIndex.pack(
            torch.tensor(embs).bfloat16(), torch.tensor(masks)))
        ue, um = _corpus(seed=1, n=3)
        mutation.append_upsert(path, torch.tensor(ue), torch.tensor(um),
                               [1, 24, 25])
        mutation.append_upsert(path, torch.tensor(ue).bfloat16(),
                               torch.tensor(um), [2, 26, 27])
        log = mutation.load_state(path, device=torch.device("cpu"))
        assert log.base.buckets[0].embs.dtype == torch.bfloat16
        assert [d.buckets[0].embs.dtype for d in log.deltas] == [
            torch.float32, torch.bfloat16]

    def test_uncommitted_intent_invisible_until_recover(self, tmp_path):
        path = str(tmp_path / "artifact")
        embs, masks = _corpus()
        index_io.save_index(path, _pack(embs, masks))
        index_io.wal_append(path, {"op": "delete", "seq": 0,
                                   "doc_ids": [1]})
        assert mutation.load_state(path, device="cpu").ops == []
        assert index_io.recover(path)["rolled_back"] == [0]
        assert index_io.recover(path)["rolled_back"] == []

    def test_load_state_requires_artifact(self, tmp_path):
        with pytest.raises((IOError, OSError)):
            mutation.load_state(str(tmp_path / "nope"), device="cpu")


# -- the kill -9 sweep: child bodies, run in spawned processes ----------

def seed_artifact(path):
    from repro_torch.serve import index_io
    from repro_torch.serve.index import PackedIndex
    embs, masks = _corpus()
    index_io.save_index(path, PackedIndex.pack(torch.tensor(embs),
                                               torch.tensor(masks)))


def run_op(path, op, point=None):
    """One durable mutation op against ``path``, SIGKILLed at ``point``."""
    from repro_torch.serve import mutation
    from repro_torch.serve.health import CrashPlan
    crash = None if point is None else CrashPlan(kill_at=point)
    if op == "upsert":
        ue, um = _corpus(UPSERT[1], n=len(UPSERT[0]))
        mutation.append_upsert(path, ue, um, UPSERT[0], crash=crash)
    elif op == "delete":
        mutation.append_delete(path, DELETE, crash=crash)
    else:
        mutation.Compactor(path, crash=crash, device="cpu").run()
    print("MUTATION_OK")


def topk_result(path, k=10):
    log = mutation.load_state(path, device="cpu")
    view = log.view() if log.ops else None
    return topk_search(log.base, torch.tensor(_queries()), k=k,
                       mutation=view)


_CHILD = "\n".join(["import numpy as np", "import torch",
                    f"UPSERT, DELETE = {UPSERT!r}, {DELETE!r}",
                    inspect.getsource(_corpus), inspect.getsource(run_op)])

# Expected recovery side per crash point: before the last covered write
# lands the intent rolls BACK (pre-mutation epoch); once every write
# landed it rolls FORWARD (post).
EXPECT = {
    "upsert-intent": "pre", "upsert-body": "pre",
    "upsert-manifest": "post", "upsert-commit": "post",
    "delete-intent": "pre", "delete-tombstones": "post",
    "delete-commit": "post",
    "compact-intent": "pre", "compact-body": "pre",
    "compact-swap": "post", "compact-clean": "post",
}


@pytest.mark.parametrize("point", mutation.CRASH_POINTS)
def test_kill_and_recover(point, tmp_path):
    assert set(EXPECT) == set(mutation.CRASH_POINTS)
    op = point.split("-")[0]
    path, twin = str(tmp_path / "artifact"), str(tmp_path / "twin")
    for p in (path, twin):
        seed_artifact(p)
        if op == "compact":   # compaction folds an existing log
            run_op(p, "upsert")
            run_op(p, "delete")
    pre = topk_result(path)
    run_op(twin, op)
    post = topk_result(twin)

    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin"}
    code = _CHILD + f"\nrun_op({path!r}, {op!r}, {point!r})\n"
    child = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=240)
    assert child.returncode == -signal.SIGKILL, (
        f"{point}: child survived (rc={child.returncode})\n"
        f"{child.stderr[-2000:]}")
    assert "MUTATION_OK" not in child.stdout

    report = index_io.recover(path)
    got = topk_result(path)
    _bitwise(got, pre if EXPECT[point] == "pre" else post, point)
    assert index_io.list_orphans(path) == []
    index_io.load_index(path, device="cpu")
    if op == "compact":
        assert index_io.load_epoch(path) == (
            0 if EXPECT[point] == "pre" else 1), (point, report)
    assert index_io.recover(path) == {
        "rolled_forward": [], "rolled_back": [], "removed": []}
    # the reference reads the recovered artifact as the port does
    jlog = j_mut.load_state(path)
    _assert_topk(got, j_ret.topk_search(
        jlog.base, jnp.asarray(_queries()), k=10,
        mutation=jlog.view() if jlog.ops else None))


class TestServerMutation:
    def test_apply_mutation_and_epoch_swap(self, tmp_path):
        path = str(tmp_path / "artifact")
        embs, masks = _corpus()
        index_io.save_index(path, _pack(embs, masks))
        ue, um = _corpus(seed=1, n=6)
        mutation.append_upsert(path, ue, um, UPSERT[0])
        mutation.append_delete(path, [5, 25])
        log = mutation.load_state(path, device="cpu")

        q = torch.tensor(_queries())
        server = RetrievalServer(log.base, k=10, n_first=0x7FFFFFFF)
        base_idx, base_scores = server.query_batch(q)
        key0 = server.epoch_key
        server.apply_mutation(log.view())
        assert server.epoch_key[1] == key0[1] + 1
        mut = server.query_batch(q)
        want = _view_topk(log, q.numpy(), 10)
        np.testing.assert_array_equal(mut.top_idx, want[0].numpy())
        np.testing.assert_array_equal(mut.top_scores, want[1].numpy())
        assert not (np.array_equal(base_idx, mut.top_idx)
                    and np.array_equal(base_scores, mut.top_scores))

        mutation.Compactor(path, device="cpu").run()
        compacted = index_io.load_index(path, device="cpu")
        server.swap_index(compacted)
        new = server.query_batch(q)
        assert new.epoch_key[2] == 1
        np.testing.assert_array_equal(new.top_idx, mut.top_idx)
        np.testing.assert_array_equal(new.top_scores, mut.top_scores)

    def test_two_stage_server_serves_e2e_under_mutation(self):
        log, _ = _both_logs([("upsert", UPSERT), ("delete", DELETE)])
        server = RetrievalServer(log.base, k=10, n_first=4)
        server.apply_mutation(log.view())
        got = server.query_batch(torch.tensor(_queries()))
        want = _view_topk(log, _queries(), 10)
        np.testing.assert_array_equal(got.top_idx, want[0].numpy())

    @pytest.mark.parametrize("compression", ["none", "residual"])
    def test_routed_bounded_equals_exhaustive_under_mutation(
            self, compression):
        kw = ({"residual_bits": 4, "n_centroids": 8}
              if compression == "residual" else {})
        log, jlog = _both_logs([("upsert", UPSERT), ("delete", DELETE)],
                               compression, **kw)
        table = RoutingIndex.build(log.base, n_centroids=2)
        q = torch.tensor(_queries())
        want = topk_search(log.base, q, k=10, mutation=log.view())
        for n_probe in (1, 2):
            stats = {}
            got = topk_search(log.base, q, k=10, route="bounded",
                              routing=table, n_probe=n_probe,
                              mutation=log.view(), route_stats=stats)
            _bitwise(got, want, f"bounded n_probe={n_probe}")
            assert stats["buckets_scored"] <= table.n_buckets
        server = RetrievalServer(log.base, k=10, route="bounded",
                                 routing=table)
        server.apply_mutation(log.view())
        res = server.query_batch(q)
        np.testing.assert_array_equal(res.top_idx, want[0].numpy())
        np.testing.assert_array_equal(res.top_scores, want[1].numpy())
        if compression == "none":
            _assert_topk(want, j_ret.topk_search(
                jlog.base, jnp.asarray(_queries()), k=10,
                mutation=jlog.view()))


def test_serve_retrieval_mutation_lifecycle_matches_jax(tmp_path):
    """encode -> prune -> pack -> save -> load -> serve, then upsert 8
    fresh docs, delete two, serve the view, compact and serve the new
    epoch — with the reference's weights and samples carried across."""
    ji, js = j_serve_retrieval(n_queries=8, index_dir=str(tmp_path / "j"),
                               upsert=8, delete=(3, 5), compact=True)
    _, model = _port(J_SMOKE, colbert_base.SMOKE)
    samples = torch.from_numpy(np.array(j_sample_sphere(
        jax.random.PRNGKey(1), 2048, J_SMOKE.out_dim)))
    path = str(tmp_path / "t")
    res = serve_retrieval(colbert_base.SMOKE, n_queries=8, device="cpu",
                          model=model, samples=samples, index_dir=path,
                          upsert=8, delete=(3, 5), compact=True)
    _assert_topk((res.idx, res.scores), (np.asarray(ji), np.asarray(js)))
    assert index_io.load_epoch(path) == 1
    assert index_io.list_orphans(path) == []
    assert res.server.epoch_key[2] == 1
    # the reference reads the port's compacted epoch
    _assert_topk(topk_search(index_io.load_index(path, device="cpu"),
                             res.q_emb, k=10),
                 j_ret.topk_search(j_io.load_index(path),
                                   jnp.asarray(res.q_emb.numpy()), k=10))


def test_serve_retrieval_route_needs_index_dir():
    with pytest.raises(ValueError, match="index_dir"):
        serve_retrieval(colbert_base.SMOKE, n_queries=2, n_docs=8,
                        device="cpu", route="bounded")
