"""Index persistence of the PyTorch port against the JAX reference.

An artifact written by either package loads in the other: the same
numpy corpus is packed by both, saved by one and loaded by the other,
for the ``none`` (fp32 and bf16), ``int8`` and ``residual`` codecs and
for flat, placed (format 2) and replicated (format 3) layouts, whole
and by ``group=``.  Every leaf comes back bit-equal, and the top-10s
agree: scores within 1e-5 across packages, ids equal wherever the
reference's score gap to a neighbour exceeds that.  The manifests the
two packages write for the same index are the same JSON objects, and
the mutation WAL is one format: a record written by either is read by
the other, with equal crc32s.
"""

import json
import os
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.serve import index_io as j_io
from repro.serve import retrieval as j_ret
from repro.serve import routing as j_routing
from repro.serve.index import PackedIndex as JPackedIndex
from repro.sharding import PlacementPlan as JPlacementPlan
from repro.train import checkpoint as j_ckpt
from repro_torch.serve import index_io, retrieval
from repro_torch.serve.index import PackedIndex
from repro_torch.serve.routing import RoutingIndex
from repro_torch.sharding import PlacementPlan
from repro_torch.train import checkpoint

ATOL = 1e-5
CODECS = {"none": {}, "bf16": {}, "int8": {"compression": "int8"},
          "residual": {"compression": "residual", "residual_bits": 4,
                       "n_centroids": 8}}
LAYOUTS = {"flat": None, "placed": (2, 1), "replicated": (3, 2)}
LEAVES = ("doc_ids", "masks", "embs", "q8", "scales", "codes", "resq",
          "rscale", "codebook")


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed=0, n=24, m=12, dim=16, p=0.8):
    rng = np.random.default_rng(seed)
    embs = _unit(rng, n, m, dim)
    masks = rng.random((n, m)) < p
    masks[2] = False                  # an empty-after-prune doc
    return embs, masks


def _queries(seed=99, n_q=4, l=6, dim=16):
    return _unit(np.random.default_rng(seed), n_q, l, dim)


def _pack_jax(codec, seed=0, n=24):
    embs, masks = _corpus(seed, n)
    if codec == "bf16":
        embs = embs.astype(ml_dtypes.bfloat16)
    return JPackedIndex.pack(jnp.asarray(embs), jnp.asarray(masks),
                             **CODECS[codec])


def _pack_port(codec, seed=0, n=24):
    embs, masks = _corpus(seed, n)
    e = torch.tensor(embs)
    if codec == "bf16":
        e = e.bfloat16()
    return PackedIndex.pack(e, torch.tensor(masks), **CODECS[codec])


def _host(x):
    """A leaf of either package as numpy (bf16 as its bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_same_leaves(got, want):
    assert (got.n_docs, got.m, got.dim, got.tokens_total, got.compression,
            got.epoch, got.residual_bits) == (
        want.n_docs, want.m, want.dim, want.tokens_total, want.compression,
        want.epoch, want.residual_bits)
    assert len(got.buckets) == len(want.buckets)
    for gb, wb in zip(got.buckets, want.buckets):
        assert gb.cap == wb.cap
        for k in LEAVES:
            g, w = getattr(gb, k), getattr(wb, k)
            assert (g is None) == (w is None), k
            if g is not None:
                gh, wh = _host(g), _host(w)
                assert gh.dtype == wh.dtype, k
                np.testing.assert_array_equal(gh, wh, err_msg=k)


def _assert_topk(got, want, tol=ATOL):
    """Scores within ``tol``; ids equal wherever the reference's score
    gap to a neighbour in its list exceeds ``tol``."""
    gi, gs = (np.asarray(x) for x in got[:2])
    wi, ws = (np.asarray(x) for x in want[:2])
    assert gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=1e-6)
    gap = np.full(ws.shape, np.inf)
    if ws.shape[1] > 1:
        d = np.abs(np.diff(ws, axis=1))
        gap[:, 1:] = np.minimum(gap[:, 1:], d)
        gap[:, :-1] = np.minimum(gap[:, :-1], d)
    clear = gap > tol
    np.testing.assert_array_equal(gi[clear], wi[clear])


def _plans(layout, n_buckets):
    if LAYOUTS[layout] is None:
        return None, None
    g, r = LAYOUTS[layout]
    port = PlacementPlan.round_robin(n_buckets, g, replicas=r)
    jax_ = JPlacementPlan.round_robin(n_buckets, g, replicas=r)
    assert port.to_manifest() == jax_.to_manifest()
    return port, jax_


def _port_topk(index, q, k=10):
    return retrieval.topk_search(index, torch.tensor(q), k=k)


def _jax_topk(index, q, k=10):
    return j_ret.topk_search(index, jnp.asarray(q), k=k)


def _groups(plan):
    return [] if plan is None else range(plan.n_groups)


class TestCrossPackageArtifacts:
    @pytest.mark.parametrize("layout", list(LAYOUTS))
    @pytest.mark.parametrize("codec", list(CODECS))
    def test_jax_artifact_loads_in_port(self, tmp_path, codec, layout):
        jp = _pack_jax(codec)
        _, jplan = _plans(layout, len(jp.buckets))
        path = str(tmp_path / "a")
        j_io.save_index(path, jp, placement=jplan)
        got = index_io.load_index(path, device="cpu")
        _assert_same_leaves(got, jp)
        q = _queries()
        _assert_topk(_port_topk(got, q), _jax_topk(jp, q))
        for g in _groups(jplan):
            _assert_same_leaves(index_io.load_index(path, group=g,
                                                    device="cpu"),
                                j_io.load_index(path, group=g))
        assert index_io.has_index(path)
        assert index_io.load_placement(path) == (
            None if jplan is None else PlacementPlan.from_manifest(
                jplan.to_manifest()))

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    @pytest.mark.parametrize("codec", list(CODECS))
    def test_port_artifact_loads_in_jax(self, tmp_path, codec, layout):
        tp = _pack_port(codec)
        plan, _ = _plans(layout, len(tp.buckets))
        path = str(tmp_path / "a")
        index_io.save_index(path, tp, placement=plan)
        got = j_io.load_index(path)
        _assert_same_leaves(tp, got)
        _assert_same_leaves(index_io.load_index(path, device="cpu"), tp)
        q = _queries()
        _assert_topk(_port_topk(tp, q), _jax_topk(got, q))
        for g in _groups(plan):
            _assert_same_leaves(index_io.load_index(path, group=g,
                                                    device="cpu"),
                                j_io.load_index(path, group=g))
        assert j_io.has_index(path)

    @pytest.mark.parametrize("layout", list(LAYOUTS))
    @pytest.mark.parametrize("codec", list(CODECS))
    def test_manifests_equal_reference(self, tmp_path, codec, layout):
        jp, tp = _pack_jax(codec), _pack_port(codec)
        plan, jplan = _plans(layout, len(tp.buckets))
        a, b = str(tmp_path / "jax"), str(tmp_path / "port")
        j_io.save_index(a, jp, placement=jplan)
        index_io.save_index(b, tp, placement=plan)
        names = sorted(n for n in os.listdir(a) if n.endswith(".json"))
        assert names == sorted(n for n in os.listdir(b)
                               if n.endswith(".json"))
        for name in names:
            with open(os.path.join(a, name)) as f, \
                    open(os.path.join(b, name)) as g:
                assert json.load(g) == json.load(f), name

    def test_load_places_leaves_on_device_in_their_dtypes(self, tmp_path):
        path = str(tmp_path / "a")
        index_io.save_index(path, _pack_port("bf16"))
        got = index_io.load_index(path, device=torch.device("cpu"))
        b = got.buckets[0]
        assert (b.embs.dtype, b.masks.dtype, b.doc_ids.dtype) == (
            torch.bfloat16, torch.bool, torch.int32)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                index_io.load_index(path)


class TestRefusals:
    def test_newer_format_refused(self, tmp_path):
        path = str(tmp_path / "a")
        index_io.save_index(path, _pack_port("none"))
        man = os.path.join(path, index_io.MANIFEST)
        obj = json.load(open(man))
        obj["format"] = index_io.FORMAT + 1
        json.dump(obj, open(man, "w"))
        for load in (lambda: index_io.load_index(path, device="cpu"),
                     lambda: j_io.load_index(path)):
            with pytest.raises(IOError, match="newer"):
                load()
        assert not index_io.has_index(path)

    def test_missing_body_raises(self, tmp_path):
        path = str(tmp_path / "a")
        index_io.save_index(path, _pack_port("none"))
        for step in checkpoint.list_steps(path):
            shutil.rmtree(os.path.join(path, f"step_{step:09d}"))
        assert not index_io.has_index(path)
        with pytest.raises(IOError, match="no restorable"):
            index_io.load_index(path, device="cpu")

    def test_residual_manifest_refused_by_previous_format(self, tmp_path,
                                                          monkeypatch):
        path = str(tmp_path / "a")
        index_io.save_index(path, _pack_port("residual"))
        assert json.load(open(os.path.join(path, index_io.MANIFEST)))[
            "format"] == 5
        monkeypatch.setattr(index_io, "FORMAT", 4)
        with pytest.raises(IOError, match="newer"):
            index_io.load_index(path, device="cpu")

    @pytest.mark.parametrize("missing", [True, False])
    def test_torn_group_submanifest_names_recover(self, tmp_path, missing):
        path = str(tmp_path / "a")
        tp = _pack_port("none", n=32)
        index_io.save_index(path, tp,
                            placement=PlacementPlan.for_index(tp, 2))
        sub = os.path.join(path, "packed_index.group1.json")
        if missing:
            os.remove(sub)
        else:
            whole = open(sub).read()
            open(sub, "w").write(whole[:len(whole) // 2])
        with pytest.raises(IOError, match=r"group 1.*recover"):
            index_io.load_index(path, device="cpu")

    def test_group_load_needs_placement(self, tmp_path):
        path = str(tmp_path / "a")
        index_io.save_index(path, _pack_port("none"))
        with pytest.raises(IOError, match="no placement"):
            index_io.load_index(path, group=0, device="cpu")


class TestAsyncSave:
    def test_async_save_joins_and_round_trips(self, tmp_path):
        tp = _pack_port("int8")
        path = str(tmp_path / "a")
        index_io.save_index(path, tp, async_save=True)
        # the host copy was taken at the call: a later in-place update
        # does not reach the pending write
        tp.buckets[0].q8.zero_()
        checkpoint.wait_pending()
        got = index_io.load_index(path, device="cpu")
        assert int(got.buckets[0].q8.abs().sum()) > 0
        _assert_same_leaves(got, j_io.load_index(path))


class TestRoutingSidecar:
    def test_round_trip_both_ways(self, tmp_path):
        tp = _pack_port("none")
        table = RoutingIndex.build(tp, n_centroids=3)
        path = str(tmp_path / "a")
        index_io.save_index(path, tp)
        index_io.save_routing(index_io.live_epoch_dir(path), table)
        assert index_io.has_routing(path) and j_io.has_routing(path)
        for got in (index_io.load_routing(path, device="cpu"),
                    j_io.load_routing(path)):
            assert got.meta() == table.meta()
            for k, v in table.body_tree().items():
                np.testing.assert_array_equal(np.asarray(got.body_tree()[k]),
                                              v.numpy())
        jt = j_routing.RoutingIndex.build(j_io.load_index(path),
                                          n_centroids=3, seed=5)
        other = str(tmp_path / "b")
        j_io.save_index(other, j_io.load_index(path))
        j_io.save_routing(other, jt)
        got = index_io.load_routing(other, device="cpu")
        assert got.meta() == jt.meta()
        np.testing.assert_array_equal(got.centroids.numpy(),
                                      np.asarray(jt.centroids))
        got.validate_for(index_io.load_index(other, device="cpu"))

    def test_absent_sidecar_loads_none(self, tmp_path):
        path = str(tmp_path / "a")
        index_io.save_index(path, _pack_port("none"))
        assert not index_io.has_routing(path)
        assert index_io.load_routing(path, device="cpu") is None


class TestWal:
    RECORDS = ({"op": "upsert", "seq": 0, "delta": 0, "doc_ids": [1, 2]},
               {"op": "commit", "seq": 0},
               {"op": "delete", "seq": 1, "doc_ids": [3]},
               {"op": "compact", "seq": 2, "epoch": 1, "deltas": [0]})

    def test_round_trip_and_equal_crcs(self, tmp_path):
        path = str(tmp_path)
        for r in self.RECORDS:
            got = index_io.wal_append(path, r)
            assert got["crc"] == j_io._wal_crc(r) == index_io._wal_crc(r)
        assert index_io.wal_read(path) == list(self.RECORDS)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_read_by_the_other_package(self, tmp_path, writer):
        path = str(tmp_path)
        append = j_io.wal_append if writer == "jax" else index_io.wal_append
        read = index_io.wal_read if writer == "jax" else j_io.wal_read
        for r in self.RECORDS:
            append(path, r)
        assert read(path) == list(self.RECORDS)
        with open(os.path.join(path, index_io.WAL), "rb") as f:
            written = f.read()
        other = str(tmp_path / "other")
        for r in self.RECORDS:
            (index_io.wal_append if writer == "jax"
             else j_io.wal_append)(other, r)
        with open(os.path.join(other, index_io.WAL), "rb") as f:
            assert f.read() == written

    def test_torn_tail_yields_valid_prefix(self, tmp_path):
        path = str(tmp_path)
        for s in range(3):
            index_io.wal_append(path, {"op": "delete", "seq": s,
                                       "doc_ids": [s]})
        wal = os.path.join(path, index_io.WAL)
        lines = open(wal).read().splitlines(keepends=True)
        open(wal, "w").write("".join(lines[:2])
                             + lines[2][:len(lines[2]) // 2])
        assert [r["seq"] for r in index_io.wal_read(path)] == [0, 1]
        assert index_io.wal_read(path) == j_io.wal_read(path)
        bad = lines[1].replace('"doc_ids": [1]', '"doc_ids": [9]')
        open(wal, "w").write(lines[0] + bad + lines[2])
        assert [r["seq"] for r in index_io.wal_read(path)] == [0]

    def test_format_stamps_match_reference(self):
        plans = [None, PlacementPlan.round_robin(3, 2),
                 PlacementPlan.round_robin(3, 2, replicas=2)]
        jplans = [None, JPlacementPlan.round_robin(3, 2),
                  JPlacementPlan.round_robin(3, 2, replicas=2)]
        for p, jp in zip(plans, jplans):
            for epoch in (0, 1):
                for c in ("none", "int8", "residual"):
                    assert index_io._format_for(p, epoch, c) == \
                        j_io._format_for(jp, epoch, c)
        assert index_io.FORMAT == j_io.FORMAT


def test_placement_plan_matches_reference():
    """The port's copy of ``PlacementPlan``: balanced, rebalanced and
    repacked plans equal the reference's."""
    w = [5, 1, 9, 3, 3, 7]
    for g, r in ((2, 1), (3, 2), (4, 3)):
        p = PlacementPlan.balanced(w, g, replicas=r)
        jp = JPlacementPlan.balanced(w, g, replicas=r)
        assert p.to_manifest() == jp.to_manifest()
        assert p.rebalance([0], w).to_manifest() == \
            jp.rebalance([0], w).to_manifest()
        assert p.rebalance_repack(w[:4]).to_manifest() == \
            jp.rebalance_repack(w[:4]).to_manifest()
        assert p.buckets_of(1) == jp.buckets_of(1)
    with pytest.raises(IOError, match="newer"):
        PlacementPlan.from_manifest({"format": 3, "n_groups": 1,
                                     "groups": [0]})


def test_checkpoint_body_is_the_reference_format(tmp_path):
    """The index body is the checkpoint layer's: the reference's
    checkpointer restores the port's bucket leaves by name."""
    path = str(tmp_path / "a")
    tp = _pack_port("residual")
    index_io.save_index(path, tp)
    like = {"buckets": [{k: 0 for k in ("doc_ids", "masks", "codes", "resq",
                                        "rscale", "codebook")}
                        for _ in tp.buckets]}
    step, tree = j_ckpt.restore_latest(path, like)
    assert step == 0
    np.testing.assert_array_equal(np.asarray(tree["buckets"][0]["codes"]),
                                  tp.buckets[0].codes.numpy())
