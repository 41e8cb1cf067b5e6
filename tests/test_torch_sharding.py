"""The port's sharding plumbing (``repro_torch.sharding``,
``repro_torch.launch.mesh``) and the bucket shard view against the JAX
reference: thread-local rules, the serving and pruning rule resolvers,
the mesh functions (meshes of repeated CPU positions stand in for
devices), and ``PackedBucket.shard_view``'s pads, array for array the
reference's.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import index as j_index
from repro.sharding import specs as j_specs
from repro_torch.core import voronoi
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import (Mesh, default_serve_hosts,
                                     make_host_mesh, make_serve_mesh)
from repro_torch.serve.index import PackedBucket, PackedIndex
from repro_torch.serve.retrieval import topk_search_group
from repro_torch.sharding import (PlacementPlan, axis_rules, constrain,
                                  current_rules, data_mesh_for,
                                  grid_axes_for, logical_to_spec,
                                  mesh_axes_for, serve_rules, spec_for)

CPU = torch.device("cpu")


def _cpus(n):
    return [CPU] * n


class TestRules:
    def test_rules_are_thread_local(self):
        seen = {}

        def probe():
            seen["rules"] = current_rules()

        with axis_rules({"candidates": ("model",)}):
            assert current_rules() == {"candidates": ("model",)}
            t = threading.Thread(target=probe)
            t.start()
            t.join()
        assert seen["rules"] is None       # a new thread starts without
        assert current_rules() is None     # restored on exit

    def test_nested_rules_restore(self):
        with axis_rules({"a": "x"}):
            with axis_rules({"b": "y"}):
                assert current_rules() == {"b": "y"}
            assert current_rules() == {"a": "x"}

    def test_constrain_is_the_identity(self):
        x = torch.ones(4)
        with axis_rules({"candidates": ("model",)}):
            assert constrain(x, "candidates") is x

    @pytest.mark.parametrize("axes", [("candidates", None, None),
                                      ("batch", "candidates"),
                                      ("fsdp", "embed", "fsdp")])
    def test_logical_to_spec_matches_reference(self, axes):
        rules = {"candidates": ("model",), "batch": ("data", "model"),
                 "fsdp": "data", "embed": None}
        want = tuple(j_specs.logical_to_spec(axes, rules))
        assert logical_to_spec(axes, rules) == want
        with axis_rules(rules):
            assert spec_for(*axes) == want

    def test_serve_rules_and_mesh(self):
        r = serve_rules()
        assert r["candidates"] == ("model",) and r["batch"] is None
        assert "__mesh__" not in r
        assert {k: v for k, v in r.items()} == j_specs.serve_rules()
        mesh = make_serve_mesh(devices=_cpus(4))
        r = serve_rules(mesh)
        assert r["__mesh__"] is mesh
        with axis_rules(r):
            got, axes, n = mesh_axes_for("candidates")
        assert got is mesh and axes == ("model",) and n == 4
        with axis_rules(serve_rules(make_serve_mesh(devices=_cpus(1)))):
            assert mesh_axes_for("candidates") == (None, (), 1)

    def test_mesh_axes_for_replicated_and_bare(self):
        assert mesh_axes_for("candidates") == (None, (), 1)
        mesh = make_serve_mesh(devices=_cpus(2))
        with axis_rules({"__mesh__": mesh, "candidates": None}):
            assert mesh_axes_for("candidates") == (None, (), 1)

    def test_grid_axes_for_ignores_flat_meshes(self):
        assert grid_axes_for() == (None, 1, 1, None)
        mesh = make_serve_mesh(devices=_cpus(4))
        with axis_rules(serve_rules(mesh)):
            assert grid_axes_for()[0] is None
        grid = make_serve_mesh(2, _cpus(4))
        assert serve_rules(grid)["candidates"] == ("candidates",)
        with axis_rules(serve_rules(grid)):
            assert grid_axes_for() == (grid, 2, 2, None)
        one = make_serve_mesh(1, _cpus(4))       # hosts=1 stays flat
        assert "hosts" not in one.axis_names

    def test_serve_rules_carry_placement(self):
        plc = PlacementPlan.pinned(2, 2)
        r = serve_rules(make_serve_mesh(2, _cpus(2)), placement=plc)
        assert r["__placement__"] is plc
        with axis_rules(r):
            assert grid_axes_for()[3] is plc

    def test_data_mesh_for_policy(self):
        assert data_mesh_for(None, who="f") is None
        assert data_mesh_for(False, who="f") is None
        with pytest.raises(ValueError, match="f\\(sharded=True\\)"):
            data_mesh_for(True, who="f")
        mesh = make_host_mesh(_cpus(4))
        with axis_rules({"__mesh__": mesh}):
            assert data_mesh_for(None, who="f") is mesh
            assert data_mesh_for(False, who="f") is None
        with axis_rules({"__mesh__": make_host_mesh(_cpus(1))}):
            assert data_mesh_for(None, who="f") is None

    def test_sharded_true_requires_mesh(self):
        ranks = torch.zeros((4, 6), dtype=torch.int32)
        errs = torch.zeros((4, 6))
        masks = torch.ones((4, 6), dtype=torch.bool)
        with pytest.raises(ValueError, match="__mesh__"):
            voronoi.global_keep_masks(ranks, errs, masks, 0.5, sharded=True)

    def test_group_search_requires_grid_rules(self):
        packed = PackedIndex.pack(torch.randn(8, 16, 8),
                                  torch.ones(8, 16, dtype=torch.bool))
        with pytest.raises(ValueError, match="grid"):
            topk_search_group(packed, torch.ones(2, 3, 8), group=0)
        with axis_rules(serve_rules(make_serve_mesh(2, _cpus(4)))):
            with pytest.raises(ValueError, match="outside"):
                topk_search_group(packed, torch.ones(2, 3, 8), group=2)


class TestMeshes:
    def test_make_serve_mesh_needs_divisible_devices(self):
        with pytest.raises(ValueError, match="divide"):
            make_serve_mesh(hosts=3, devices=_cpus(4))
        grid = make_serve_mesh(2, _cpus(4))
        assert grid.shape == {"hosts": 2, "candidates": 2}
        flat = make_serve_mesh(devices=_cpus(4))
        assert flat.shape == {"data": 1, "model": 4}
        assert make_host_mesh(_cpus(4)).shape == {"data": 4, "model": 1}

    @pytest.mark.parametrize("n,want", [(1, 1), (2, 1), (4, 2), (8, 2),
                                        (16, 4), (6, 2), (3, 1)])
    def test_default_serve_hosts(self, n, want, monkeypatch):
        from repro.launch import mesh as j_mesh
        monkeypatch.setattr(j_mesh.jax, "devices", lambda: [None] * n)
        assert default_serve_hosts(_cpus(n)) == want
        assert j_mesh.default_serve_hosts() == want

    def test_devices_along_rows(self):
        devs = [torch.device("cpu", i) for i in range(4)]
        grid = make_serve_mesh(2, devs)
        assert grid.devices_along(("candidates",), hosts=1) == devs[2:]
        assert grid.devices_along(("hosts",)) == [devs[0], devs[2]]
        assert grid.distinct() == 4
        assert make_serve_mesh(2, _cpus(4)).distinct() == 1

    def test_mesh_equality_and_hash(self):
        a, b = make_serve_mesh(2, _cpus(4)), make_serve_mesh(2, _cpus(4))
        assert a == b and hash(a) == hash(b)
        assert a != make_serve_mesh(1, _cpus(4))
        with pytest.raises(ValueError):
            Mesh(_cpus(3), ("hosts", "candidates"), (2, 2))

    def test_local_devices(self):
        assert mesh_lib.local_devices("cpu") == [CPU]
        want = torch.cuda.device_count()
        assert len(mesh_lib.local_devices()) == want
        if not want:
            with pytest.raises(RuntimeError, match="no device"):
                make_serve_mesh()


def _bucket_pair(rng, n, cap, dim, codec):
    """The same bucket in both packages (``codec``: "none" or
    "residual")."""
    e = rng.normal(size=(n, cap, dim)).astype(np.float32)
    mask = np.arange(cap)[None] < rng.integers(0, cap + 1, n)[:, None]
    ids = np.sort(rng.choice(10 * max(n, 1), n, replace=False)).astype(
        np.int32)
    if codec == "none":
        j = j_index.PackedBucket(cap=cap, doc_ids=jnp.asarray(ids),
                                 masks=jnp.asarray(mask),
                                 embs=jnp.asarray(e))
        t = PackedBucket(cap=cap, doc_ids=torch.tensor(ids),
                         masks=torch.tensor(mask), embs=torch.tensor(e))
        return j, t
    codes = rng.integers(0, 4, (n, cap)).astype(np.int8)
    resq = rng.integers(0, 256, (n, cap, dim // 2)).astype(np.uint8)
    scale = rng.random((n, cap, 1)).astype(np.float32)
    cb = rng.normal(size=(4, dim)).astype(np.float32)
    kw = lambda f: dict(cap=cap, doc_ids=f(ids), masks=f(mask),  # noqa
                        codes=f(codes), resq=f(resq), rscale=f(scale),
                        codebook=f(cb))
    return (j_index.PackedBucket(**kw(jnp.asarray)),
            PackedBucket(**kw(torch.tensor)))


class TestShardView:
    @pytest.mark.parametrize("codec", ["none", "residual"])
    @pytest.mark.parametrize("n", [0, 1, 5, 8])
    @pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
    def test_matches_reference_and_splits(self, codec, n, n_shards):
        rng = np.random.default_rng(n * 10 + n_shards)
        jb, tb = _bucket_pair(rng, n, 8, 8, codec)
        je, jm, ji = jb.shard_view(8, n_shards, pad_id=99)
        te, tm, ti = tb.shard_view(8, n_shards, pad_id=99)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        parts = ([(te.codes, je.codes), (te.resq, je.resq),
                  (te.scale, je.scale)] if codec == "residual"
                 else [(te, je)])
        for t, j in parts:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        # shard by shard: the same rows, views of the bucket where no pad
        shards = [tb.shard_view(8, n_shards, 99, shard=s)
                  for s in range(n_shards)]
        np.testing.assert_array_equal(
            torch.cat([s[2] for s in shards]).numpy(), ti.numpy())
        np.testing.assert_array_equal(
            torch.cat([s[1] for s in shards]).numpy(), tm.numpy())
        assert len({s[2].shape[0] for s in shards}) == 1

    def test_empty_bucket_pads_each_shard_with_minus_one(self):
        b = PackedBucket(cap=8, doc_ids=torch.zeros(0, dtype=torch.int32),
                         masks=torch.zeros(0, 8, dtype=torch.bool),
                         embs=torch.zeros(0, 8, 4))
        for n_shards in (1, 2, 4):
            e, mk, ids = b.shard_view(4, n_shards, pad_id=99)
            assert e.shape == (n_shards, 8, 4)
            assert not bool(mk.any())
            assert (ids == -1).all()

    def test_spec_resolves_under_rules(self):
        packed = PackedIndex.pack(torch.randn(4, 8, 8),
                                  torch.ones(4, 8, dtype=torch.bool))
        assert packed.spec() == (None, None, None)
        with axis_rules(serve_rules(make_serve_mesh(devices=_cpus(2)))):
            assert packed.spec() == ("model", None, None)
        with axis_rules(serve_rules(make_serve_mesh(2, _cpus(4)))):
            assert packed.spec() == ("candidates", None, None)
