"""The autotuner of the PyTorch port (``repro_torch.core.tuning``) against
the JAX reference's (``repro.core.tuning``): its rules, cache keys and
files, measured mode, and the consumers that read their knobs through
the backend seam.

Every parity check is exact: the port's off-card heuristic equals the
reference's field for field (``chunk_docs`` aside: 1,024 on every
platform, a documented deviation), and cache files cross between the
two packages entry for entry.  The cuda heuristic is checked on the CPU
at the H100's 132 SMs against the launchers' doc-block rule.
"""

import dataclasses
import json
import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tuning as j_tuning
from repro.core import voronoi as j_vor
from repro_torch.core import backend as backend_lib
from repro_torch.core import pruning_pipeline, tuning, voronoi
from repro_torch.kernels import build
from repro_torch.kernels.colbert_maxsim import ops as cm_ops
from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
from repro_torch.serve import retrieval
from repro_torch.serve.index import PackedIndex

CPU = torch.device("cpu")
SMS = 132   # the H100 SXM's streaming multiprocessors
FIELDS = [f.name for f in dataclasses.fields(tuning.KernelConfig)]


@pytest.fixture(autouse=True)
def _fresh_cache():
    tuning.clear_cache()
    j_tuning.clear_cache()
    yield
    tuning.clear_cache()
    j_tuning.clear_cache()


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed=0, n_docs=4, m=14, dim=8, n_samples=300):
    rng = np.random.default_rng(seed)
    e = _unit(rng, n_docs, m, dim)
    lens = rng.integers(4, m + 1, size=n_docs)
    mask = np.arange(m)[None, :] < lens[:, None]
    return e, mask, _unit(rng, n_samples, dim)


def _index(seed=0, n_docs=40, m=12, dim=16, n_q=5, l=6):
    rng = np.random.default_rng(seed)
    e = _unit(rng, n_docs, m, dim)
    mask = np.arange(m)[None, :] < rng.integers(1, m + 1, size=n_docs)[:, None]
    q = _unit(rng, n_q, l, dim)
    return (retrieval.TokenIndex.build(torch.tensor(e), torch.tensor(mask)),
            torch.tensor(q))


def _mirror_docs_per_block(n_docs, G, gx, sms=SMS):
    """The launchers' rule as csrc writes it: about four blocks an SM over
    gx blocks along the other axis, whole tile groups of G docs."""
    units = max(1, -(-n_docs // G))
    groups = max(1, min(units, -(-4 * sms // gx)))
    return -(-units // groups) * G


class TestHeuristics:
    @pytest.mark.parametrize("n_samples", [64, 2048, 100_000])
    @pytest.mark.parametrize("m", [2, 8, 48, 180, 1000])
    def test_pruning_configs_always_legal(self, n_samples, m):
        for platform, sms in (("cpu", None), ("cuda", SMS)):
            cfg = tuning.heuristic_config("pruning", platform=platform,
                                          sm_count=sms, n_samples=n_samples,
                                          m=m, dim=128, n_docs=37)
            cfg.validate()
            assert cfg.shortlist >= cfg.rescan_every + 1
            assert cfg.shortlist <= max(m, 2)
            assert cfg.block_s % 8 == 0

    @pytest.mark.parametrize("n_q", [1, 16, 200])
    @pytest.mark.parametrize("n_docs", [8, 256, 10_000])
    @pytest.mark.parametrize("l", [8, 32])
    def test_serving_configs_always_legal(self, n_q, n_docs, l):
        for platform, sms in (("cpu", None), ("cuda", SMS)):
            cfg = tuning.heuristic_config("serving", platform=platform,
                                          sm_count=sms, n_q=n_q,
                                          n_docs=n_docs, m=128, l=l, dim=128)
            cfg.validate()
            assert cfg.block_docs >= 1 and cfg.block_q >= 1

    def test_deterministic(self):
        a = tuning.heuristic_config("pruning", platform="cpu",
                                    n_samples=2048, m=48, dim=128)
        b = tuning.heuristic_config("pruning", platform="cpu",
                                    n_samples=2048, m=48, dim=128)
        assert a == b

    def test_budget_shrinks_tiles(self):
        big = tuning.heuristic_config("pruning", platform="cpu",
                                      n_samples=4096, m=512, dim=768)
        small = tuning.heuristic_config("pruning", platform="cpu",
                                        n_samples=4096, m=512, dim=768,
                                        budget=256 * 1024)
        assert small.block_s < big.block_s
        assert (4 * (small.block_s * 768 + small.block_t * 768
                     + small.block_s * small.block_t) <= 256 * 1024
                or small.block_s == 8)

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="kind"):
            tuning.heuristic_config("nope", platform="cpu", m=8)
        with pytest.raises(ValueError, match="kind"):
            tuning.shape_key("nope", {}, platform="cpu")

    def test_invalid_config_rejected(self):
        with pytest.raises(ValueError, match="exactness"):
            tuning.KernelConfig(shortlist=4, rescan_every=4).validate()
        with pytest.raises(ValueError, match="< 1"):
            tuning.KernelConfig(block_docs=0).validate()

    def test_cuda_needs_the_sm_count(self):
        with pytest.raises(ValueError, match="sm_count"):
            tuning.heuristic_config("pruning", platform="cuda", m=8)

    @pytest.mark.parametrize("n_docs", [1, 7, 128, 2908, 10_000])
    @pytest.mark.parametrize("n_samples", [128, 2048, 10_000])
    def test_cuda_pruning_block_is_the_launch_rule(self, n_docs, n_samples):
        """B1/B2: one doc a tile group, ceil(N / 128) sample blocks; the
        tiles reported are the kernels' 128 samples x 64 tokens."""
        cfg = tuning.heuristic_config("pruning", platform="cuda",
                                      sm_count=SMS, n_samples=n_samples,
                                      m=180, dim=128, n_docs=n_docs)
        assert cfg.block_docs == _mirror_docs_per_block(
            n_docs, 1, -(-n_samples // 128))
        assert (cfg.block_s, cfg.block_t) == (128, 64)
        assert (cfg.shortlist, cfg.rescan_every) == (16, 15)

    @pytest.mark.parametrize("m,codec,G", [
        (128, "bf16", 1), (64, "bf16", 2), (32, "bf16", 4), (8, "bf16", 16),
        (128, None, 1), (64, None, 1), (32, None, 2), (4, "int8", 8),
        (20, "residual4", 2)])
    @pytest.mark.parametrize("n_q,l", [(64, 32), (5, 6), (1, 64)])
    def test_cuda_serving_block_is_the_launch_rule(self, m, codec, G, n_q, l):
        """B3/B5: G docs a tile (128-row tiles for bf16 docs, 64-row for
        fp32 and residual), two warpgroups of floor(64 / l) queries a
        block; a streaming key scores one 1,024-doc slab of its shard."""
        shape = dict(n_q=n_q, n_docs=3695, m=m, l=l, dim=128)
        if codec:
            shape["codec"] = codec
        qpw = 64 // l
        gx = -(-n_q // (2 * qpw))
        cfg = tuning.heuristic_config("serving", platform="cuda",
                                      sm_count=SMS, **shape)
        assert cfg.block_docs == _mirror_docs_per_block(3695, G, gx)
        assert cfg.block_q == 2 * qpw
        stream = tuning.heuristic_config("serving", platform="cuda",
                                         sm_count=SMS, k=10, n_shards=2,
                                         **shape)
        assert stream.block_docs == _mirror_docs_per_block(1024, G, gx)
        assert stream.chunk_docs == 1024
        assert cm_ops.tile_group(m, codec == "bf16") == G

    def test_build_rule_is_the_mirror(self):
        for n_docs in (1, 9, 100, 4096):
            for G in (1, 2, 8, 16):
                for gx in (1, 3, 16, 132, 600):
                    assert build.docs_per_block(n_docs, G, gx, SMS) \
                        == _mirror_docs_per_block(n_docs, G, gx)


class TestParityWithReference:
    def test_pow2_at_least(self):
        for x in range(1, 4097):
            assert tuning._pow2_at_least(x) == j_tuning._pow2_at_least(x)

    @pytest.mark.parametrize("kind,shape", [
        ("pruning", dict(n_samples=1500, m=48, dim=128)),
        ("pruning", dict(n_samples=2049, m=180, dim=64)),
        ("serving", dict(n_q=5, n_docs=300, m=16, l=8, dim=64)),
        ("serving", dict(n_q=64, n_docs=3695, m=128, l=32, dim=128, k=10,
                         n_shards=4, n_groups=2, codec="residual4")),
        ("serving", dict(n_q=3, n_docs=9, m=4, l=32, dim=128, n_probe=2,
                         threshold=0.25)),
    ])
    @pytest.mark.parametrize("measured", [False, True])
    def test_shape_key_equal(self, kind, shape, measured):
        got = tuning.shape_key(kind, shape, platform="cpu", measured=measured)
        want = j_tuning.shape_key(kind, shape, platform="cpu",
                                  measured=measured)
        assert got == want

    @pytest.mark.parametrize("n", [64, 2048, 100_000])
    @pytest.mark.parametrize("m", [1, 2, 8, 48, 180, 1000])
    @pytest.mark.parametrize("dim", [8, 128, 768])
    def test_pruning_heuristic_equal(self, n, m, dim):
        got = tuning.heuristic_config("pruning", platform="cpu",
                                      n_samples=n, m=m, dim=dim)
        want = j_tuning.heuristic_config("pruning", platform="cpu",
                                         n_samples=n, m=m, dim=dim)
        for f in FIELDS:
            if f != "chunk_docs":
                assert getattr(got, f) == getattr(want, f), f
        assert got.chunk_docs == 1024

    @pytest.mark.parametrize("n_q", [1, 16, 64, 200])
    @pytest.mark.parametrize("n_docs", [8, 256, 3695, 10_000])
    @pytest.mark.parametrize("m,l", [(16, 8), (128, 32), (512, 32)])
    @pytest.mark.parametrize("stream", [None, (10, 1), (100, 4)])
    def test_serving_heuristic_equal(self, n_q, n_docs, m, l, stream):
        shape = dict(n_q=n_q, n_docs=n_docs, m=m, l=l, dim=128)
        if stream:
            shape.update(k=stream[0], n_shards=stream[1])
        got = tuning.heuristic_config("serving", platform="cpu", **shape)
        want = j_tuning.heuristic_config("serving", platform="cpu", **shape)
        for f in FIELDS:
            if f != "chunk_docs":
                assert getattr(got, f) == getattr(want, f), f
        assert got.chunk_docs == 1024

    def test_reference_file_loads_in_the_port(self, tmp_path):
        path = str(tmp_path / "ref.json")
        j_tuning.tune("pruning", platform="cpu", n_samples=2048, m=48,
                      dim=128)
        j_tuning.tune("serving", platform="cpu", n_q=16, n_docs=256, m=128,
                      l=32, dim=128, codec="int8")
        j_tuning.tune("serving", platform="cpu", n_q=4, n_docs=9, m=4, l=32,
                      dim=128, threshold=0.5)
        assert j_tuning.dump_cache(path) == 3
        assert tuning.load_cache(path) == 3
        got = tuning.cache_info()
        for key, cfg in j_tuning.cache_info().items():
            assert dataclasses.asdict(got[key]) == dataclasses.asdict(cfg)

    def test_port_file_loads_in_the_reference(self, tmp_path):
        path = str(tmp_path / "port.json")
        tuning.tune("pruning", device="cpu", n_samples=2048, m=48, dim=128,
                    n_docs=300)
        tuning.tune("serving", device="cpu", n_q=64, n_docs=3695, m=128,
                    l=32, dim=128, k=10, n_shards=1, codec="bf16")
        tuning.tune("serving", device="cpu", n_q=4, n_docs=9, m=4, l=32,
                    dim=128, n_probe=1, threshold=0.5)
        assert tuning.dump_cache(path) == 3
        assert j_tuning.load_cache(path) == 3
        got = j_tuning.cache_info()
        for key, cfg in tuning.cache_info().items():
            assert dataclasses.asdict(got[key]) == dataclasses.asdict(cfg)


class TestCacheKeying:
    def test_batchlike_axes_bucket_pow2(self):
        k = [tuning.shape_key("pruning", dict(n_samples=n, m=48, dim=128),
                              platform="cpu") for n in (1500, 2048, 2049)]
        assert k[0] == k[1] != k[2]

    def test_per_item_axes_exact(self):
        k1 = tuning.shape_key("pruning", dict(n_samples=2048, m=48, dim=128),
                              platform="cpu")
        k2 = tuning.shape_key("pruning", dict(n_samples=2048, m=49, dim=128),
                              platform="cpu")
        assert k1 != k2

    def test_kind_platform_mode_disambiguate(self):
        base = dict(m=48, dim=128)
        assert tuning.shape_key("pruning", base, platform="cpu") \
            != tuning.shape_key("serving", base, platform="cpu")
        assert tuning.shape_key("pruning", base, platform="cpu") \
            != tuning.shape_key("pruning", base, platform="cuda")
        assert tuning.shape_key("pruning", base, platform="cpu",
                                measured=True) \
            != tuning.shape_key("pruning", base, platform="cpu")

    def test_codec_tag_keys_separately(self):
        base = dict(n_q=4, n_docs=256, m=16, l=8, dim=64)
        keys = {tuning.shape_key("serving", base | ({"codec": c} if c else {}),
                                 platform="cpu")
                for c in (None, "bf16", "int8", "residual4", "residual2")}
        assert len(keys) == 5
        fp = tuning.shape_key("serving", base, platform="cpu")
        assert not any(n == "codec" for n, _ in fp[-1])

    def test_tuned_serving_blocks_codec_passthrough(self):
        shape = dict(n_q=4, n_docs=256, m=16, l=8, dim=64, device="cpu")
        backend_lib.tuned_serving_blocks(**shape)
        assert len(tuning.cache_info()) == 1
        backend_lib.tuned_serving_blocks(**shape, codec="residual4")
        assert len(tuning.cache_info()) == 2
        backend_lib.tuned_serving_blocks(**shape)
        backend_lib.tuned_serving_blocks(**shape, codec="residual4")
        assert len(tuning.cache_info()) == 2

    def test_optional_keys_only_when_set(self):
        backend_lib.tuned_streaming_blocks(4, 256, 16, 8, 64, 10,
                                           device="cpu")
        backend_lib.tuned_routing_blocks(4, 9, 4, 8, 64, device="cpu")
        shapes = [dict(k[3]) for k in tuning.cache_info()]
        assert {"k", "n_shards"} <= set(shapes[0])
        assert not {"n_groups", "replicas", "codec"} & set(shapes[0])
        assert not {"n_probe", "threshold"} & set(shapes[1])
        backend_lib.tuned_streaming_blocks(4, 256, 16, 8, 64, 10,
                                           n_groups=2, replicas=2,
                                           codec="int8", device="cpu")
        backend_lib.tuned_routing_blocks(4, 9, 4, 8, 64, n_probe=2,
                                         threshold=0.5, device="cpu")
        assert len(tuning.cache_info()) == 4

    def test_tune_memoizes(self):
        a = tuning.tune("pruning", device="cpu", n_samples=2048, m=48,
                        dim=128)
        assert len(tuning.cache_info()) == 1
        b = tuning.tune("pruning", device="cpu", n_samples=1100, m=48,
                        dim=128)
        assert b is a and len(tuning.cache_info()) == 1
        tuning.tune("pruning", device="cpu", n_samples=2048, m=64, dim=128)
        assert len(tuning.cache_info()) == 2

    def test_platform_is_the_device_type(self):
        tuning.tune("serving", device="cpu", n_q=4, n_docs=8, m=8, l=8,
                    dim=16)
        tuning.tune("serving", device="meta", n_q=4, n_docs=8, m=8, l=8,
                    dim=16)
        assert sorted(k[1] for k in tuning.cache_info()) == ["cpu", "meta"]


class TestMeasuredMode:
    def test_one_shot_and_cached(self, monkeypatch):
        calls = []
        real = tuning._measure_pruning

        def counting(shape, base, device, log):
            calls.append(dict(shape))
            return real(shape, base, device, log)

        monkeypatch.setattr(tuning, "_measure_pruning", counting)
        shape = dict(n_samples=64, m=9, dim=4, n_docs=3)
        a = tuning.tune("pruning", device="cpu", measure=True, **shape)
        b = tuning.tune("pruning", device="cpu", measure=True, **shape)
        assert len(calls) == 1
        assert a is b
        a.validate()
        (race,) = tuning.race_info().values()
        # K in {2, 4, 8}, then block_docs in {4, 8, 16} at the winner
        assert sorted({c["shortlist"] for c in race[:3]}) == [2, 4, 8]
        assert [c["block_docs"] for c in race[3:]] == [4, 8, 16]
        assert all(c["ms"] == min(c["runs"]) >= 0 and len(c["runs"]) == 1
                   for c in race)
        assert a.shortlist in (2, 4, 8) and a.block_docs in (4, 8, 16)

    def test_serving_race_runs_real_candidates(self):
        for codec in (None, "bf16", "int8", "residual4"):
            shape = dict(n_q=3, n_docs=40, m=8, l=4, dim=16, k=5, n_shards=2)
            if codec:
                shape["codec"] = codec
            cfg = tuning.tune("serving", device="cpu", measure=True, **shape)
            cfg.validate()
        races = tuning.race_info()
        assert len(races) == 4
        for race in races.values():
            # the heuristic's 32 (a power of two over the shard's 20
            # docs) halved and doubled, clipped to the 20-doc slab
            assert [c["block_docs"] for c in race] == [16, 20]
            assert all(len(c["runs"]) == tuning.SERVING_REPS for c in race)

    def test_env_var_measured_race_runs_real_candidates(self, monkeypatch):
        monkeypatch.setenv("REPRO_AUTOTUNE", "measure")
        cfg = tuning.tune("pruning", device="cpu", n_samples=64, m=12, dim=4,
                          n_docs=2)
        cfg.validate()
        assert len(tuning.race_info()) == 1

    def test_env_var_enables(self, monkeypatch):
        hits = []
        monkeypatch.setattr(tuning, "_measure_pruning",
                            lambda shape, base, device, log:
                            hits.append(1) or base)
        monkeypatch.setenv("REPRO_AUTOTUNE", "measure")
        tuning.tune("pruning", device="cpu", n_samples=64, m=9, dim=4)
        assert hits == [1]
        monkeypatch.setenv("REPRO_AUTOTUNE", "heuristic")
        tuning.clear_cache()
        tuning.tune("pruning", device="cpu", n_samples=64, m=9, dim=4)
        assert hits == [1]

    def test_a_failing_candidate_raises(self, monkeypatch):
        def boom(*a, **kw):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(retrieval, "maxsim_scores", boom)
        with pytest.raises(RuntimeError, match="launch failed"):
            tuning.tune("serving", device="cpu", measure=True, n_q=2,
                        n_docs=8, m=8, l=4, dim=16)


class TestConsumersConsultTuner:
    PINNED = tuning.KernelConfig(shortlist=4, rescan_every=3, block_docs=2)

    def _pin(self, monkeypatch, seen):
        def fake_tune(kind, **shape):
            seen.append((kind, shape))
            return self.PINNED
        monkeypatch.setattr(tuning, "tune", fake_tune)

    @pytest.mark.parametrize("backend", ["shortlist", "shortlist_topk"])
    def test_knobs_reach_pruning_order(self, monkeypatch, backend):
        """The tuner's K 4, R 3 and doc block 2 reach the shortlist path,
        and the ranks still equal the reference's."""
        seen = []
        self._pin(monkeypatch, seen)
        rescans = []
        real = voronoi._pruning_order_shortlist

        def spy(*a, **kw):
            rescans.append((kw["shortlist"], kw["rescan_every"],
                            kw["block_docs"]))
            return real(*a, **kw)

        monkeypatch.setattr(voronoi, "_pruning_order_shortlist", spy)
        e, mask, s = _corpus()
        want = j_vor.pruning_order(jnp.asarray(e[1]), jnp.asarray(mask[1]),
                                   jnp.asarray(s), backend="reference")
        got = voronoi.pruning_order(torch.tensor(e[1]), torch.tensor(mask[1]),
                                    torch.tensor(s), backend=backend)
        assert rescans == [(4, 3, 2)]
        assert seen[0][0] == "pruning" and seen[0][1]["n_docs"] == 1
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))

    def test_knobs_reach_prune_corpus(self, monkeypatch):
        seen = []
        self._pin(monkeypatch, seen)
        e, mask, s = _corpus(3, n_docs=6)
        from repro.core import pruning_pipeline as j_pipe
        wk, wr, _ = j_pipe.prune_corpus(jnp.asarray(e), jnp.asarray(mask),
                                        jnp.asarray(s), 0.5,
                                        backend="reference")
        gk, gr, _ = pruning_pipeline.prune_corpus(
            torch.tensor(e), torch.tensor(mask), torch.tensor(s), 0.5,
            backend="shortlist_topk")
        assert seen and all(kind == "pruning" for kind, _ in seen)
        np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))

    def test_explicit_knobs_win(self, monkeypatch):
        def boom(kind, **shape):
            raise AssertionError("tuner consulted despite explicit knobs")

        monkeypatch.setattr(backend_lib, "tuned", boom)
        e, mask, s = _corpus()
        voronoi.pruning_order_shortlist(torch.tensor(e[0]),
                                        torch.tensor(mask[0]),
                                        torch.tensor(s), shortlist=6,
                                        rescan_every=4, block_docs=3,
                                        rescan="topk")
        index, q = _index()
        retrieval.topk_search(index, q, k=4, backend="fused", block_docs=5,
                              chunk_docs=16)
        retrieval.maxsim_scores(index, q, backend="fused", block_docs=5)
        retrieval.RetrievalServer(index, k=4, n_first=index.d_masks.shape[0],
                                  backend="fused", block_docs=5,
                                  chunk_docs=16).query_batch(q)

    def test_streaming_knobs_flow_from_tuner(self, monkeypatch):
        """A streaming sweep resolves one key per bucket and scores each
        in the tuner's ``chunk_docs`` slabs: the same top-k as any
        chunking."""
        index, q = _index(n_docs=60)
        packed = PackedIndex.pack(index.d_embs, index.d_masks,
                                  granularity=4, min_width=4)
        want = retrieval.topk_search(packed, q, k=7, backend="fused",
                                     chunk_docs=1024)
        seen = []
        real = backend_lib.tuned

        def small(kind, **shape):
            seen.append(shape)
            return dataclasses.replace(real(kind, **shape), chunk_docs=3)

        monkeypatch.setattr(backend_lib, "tuned", small)
        slabs = []
        real_stream = retrieval._stream_chunk_topk
        monkeypatch.setattr(
            retrieval, "_stream_chunk_topk",
            lambda n, chunk, *a, **kw: (slabs.append(chunk),
                                        real_stream(n, chunk, *a, **kw))[1])
        got = retrieval.topk_search(packed, q, k=7, backend="fused")
        live = [b for b in packed.buckets if b.n_docs]
        assert len(seen) == len(live) and set(slabs) == {3}
        assert sorted((s["n_docs"], s["m"]) for s in seen) == sorted(
            (b.n_docs, b.cap) for b in live)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_short_last_slab_takes_the_launch_rule(self, monkeypatch):
        """The tuned doc block serves a bucket's full slabs; a shorter last
        slab takes the launchers' rule at its own size (``None`` to the
        op), unless the caller pinned the block."""
        index, q = _index(n_docs=10)
        real = backend_lib.tuned
        monkeypatch.setattr(
            backend_lib, "tuned", lambda kind, **shape: dataclasses.replace(
                real(kind, **shape), chunk_docs=4, block_docs=7))
        seen = []
        real_op = retrieval.colbert_maxsim_multi_op

        def spy(*a, block_docs=None, **kw):
            seen.append(block_docs)
            return real_op(*a, block_docs=block_docs, **kw)

        monkeypatch.setattr(retrieval, "colbert_maxsim_multi_op", spy)
        retrieval.topk_search(index, q, k=3, backend="fused")
        assert seen == [7, 7, None]
        seen.clear()
        retrieval.topk_search(index, q, k=3, backend="fused", block_docs=5)
        assert seen == [5, 5, 5]

    def test_warm_tuner_fills_cache_before_first_batch(self, monkeypatch):
        index, q = _index()
        server = retrieval.RetrievalServer(index, k=4,
                                           n_first=index.d_masks.shape[0],
                                           backend="fused")
        at_serve = []
        real = retrieval.RetrievalServer._run

        def run(index, q_, **kw):
            at_serve.append(dict(tuning.cache_info()))
            return real(index, q_, **kw)

        monkeypatch.setattr(retrieval.RetrievalServer, "_run",
                            staticmethod(run))
        assert tuning.cache_info() == {}
        server.query_batch(q)
        assert len(at_serve) == 1 and len(at_serve[0]) == 1
        assert at_serve[0] == tuning.cache_info()
        (key,) = at_serve[0]
        assert dict(key[3])["k"] == 4 and key[1] == "cpu"

    def test_routed_server_warms_the_centroid_key(self):
        from repro_torch.serve.routing import RoutingIndex
        index, q = _index(n_docs=60)
        packed = PackedIndex.pack(index.d_embs, index.d_masks,
                                  granularity=4, min_width=4)
        table = RoutingIndex.build(packed, n_centroids=2)
        server = retrieval.RetrievalServer(packed, k=4, route="nprobe",
                                           routing=table, n_probe=2,
                                           backend="fused")
        server._warm_tuner(q)
        warmed = set(tuning.cache_info())
        server.query_batch(q)
        assert set(tuning.cache_info()) == warmed
        assert any(dict(k[3]).get("m") == 2 and "k" not in dict(k[3])
                   for k in warmed)

    def test_two_stage_server_consults_nothing(self):
        index, q = _index()
        retrieval.RetrievalServer(index, k=4, n_first=8,
                                  backend="fused").query_batch(q)
        assert tuning.cache_info() == {}


class TestPlainVersionsIgnoreBlockDocs:
    @pytest.mark.parametrize("block_docs", [1, 3, 64])
    def test_outputs_equal_for_any_block(self, block_docs):
        rng = np.random.default_rng(0)
        s = torch.tensor(_unit(rng, 50, 16))
        t = torch.tensor(_unit(rng, 5, 9, 16))
        alive = torch.tensor(rng.random((5, 9)) < 0.8)
        for a, b in zip(maxsim_top2_op(s, t, alive),
                        maxsim_top2_op(s, t, alive, block_docs=block_docs)):
            assert torch.equal(a, b)
        for a, b in zip(maxsim_topk_op(s, t, alive, k=3),
                        maxsim_topk_op(s, t, alive, k=3,
                                       block_docs=block_docs)):
            assert torch.equal(a, b)
        q = torch.tensor(_unit(rng, 3, 4, 16))
        assert torch.equal(
            cm_ops.colbert_maxsim_multi_op(q, t, alive),
            cm_ops.colbert_maxsim_multi_op(q, t, alive,
                                           block_docs=block_docs))
        codes = torch.tensor(rng.integers(0, 4, (5, 9)), dtype=torch.int8)
        resq = torch.tensor(rng.integers(0, 256, (5, 9, 8)),
                            dtype=torch.uint8)
        scale = torch.tensor(rng.random((5, 9, 1)), dtype=torch.float32)
        cb = torch.tensor(_unit(rng, 4, 16))
        args = (q, codes, resq, scale, cb, alive)
        assert torch.equal(
            cm_ops.colbert_maxsim_residual_multi_op(*args, bits=4),
            cm_ops.colbert_maxsim_residual_multi_op(*args, bits=4,
                                                    block_docs=block_docs))


class TestPersistedCache:
    def test_dump_load_roundtrip(self, tmp_path):
        path = str(tmp_path / "tune.json")
        a = tuning.tune("pruning", device="cpu", n_samples=2048, m=48,
                        dim=128)
        b = tuning.tune("serving", device="cpu", n_q=16, n_docs=256, m=128,
                        l=32, dim=128)
        assert tuning.dump_cache(path) == 2
        tuning.clear_cache()
        assert tuning.cache_info() == {}
        assert tuning.load_cache(path) == 2
        assert tuning.tune("pruning", device="cpu", n_samples=2048, m=48,
                           dim=128) == a
        assert tuning.tune("serving", device="cpu", n_q=16, n_docs=256,
                           m=128, l=32, dim=128) == b

    def test_load_validates_entries(self, tmp_path):
        path = str(tmp_path / "tune.json")
        tuning.tune("pruning", device="cpu", n_samples=64, m=9, dim=4)
        tuning.dump_cache(path)
        with open(path) as f:
            payload = json.load(f)
        payload["entries"][0]["config"]["shortlist"] = 1
        with open(path, "w") as f:
            json.dump(payload, f)
        tuning.clear_cache()
        with pytest.raises(ValueError, match="exactness"):
            tuning.load_cache(path)

    def test_newer_format_refused(self, tmp_path):
        path = str(tmp_path / "tune.json")
        with open(path, "w") as f:
            json.dump({"format": tuning._CACHE_FORMAT + 1, "entries": []}, f)
        with pytest.raises(IOError):
            tuning.load_cache(path)

    def test_format_one_file_loads(self, tmp_path):
        path = str(tmp_path / "tune.json")
        key = tuning.shape_key("pruning", dict(n_samples=64, m=9, dim=4),
                               platform="cpu")
        cfg = dataclasses.asdict(tuning.KernelConfig(shortlist=4,
                                                     rescan_every=3))
        del cfg["chunk_docs"]
        with open(path, "w") as f:
            json.dump({"format": 1, "entries": [
                {"key": tuning._key_to_jsonable(key), "config": cfg}]}, f)
        assert tuning.load_cache(path) == 1
        assert tuning.cache_info()[key].chunk_docs == tuning.CHUNK_DOCS

    def test_env_hook_loads_and_dumps(self, tmp_path, monkeypatch):
        path = str(tmp_path / "shared.json")
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
        races = []
        pinned = tuning.KernelConfig(shortlist=6, rescan_every=5)
        monkeypatch.setattr(tuning, "_measure_pruning",
                            lambda shape, base, device, log:
                            races.append(1) or pinned)
        monkeypatch.setenv("REPRO_AUTOTUNE", "measure")
        got = tuning.tune("pruning", device="cpu", n_samples=64, m=9, dim=4)
        assert races == [1] and got == pinned
        assert os.path.exists(path)
        tuning.clear_cache()
        got2 = tuning.tune("pruning", device="cpu", n_samples=64, m=9, dim=4)
        assert races == [1]
        assert got2 == pinned


class TestCacheConcurrency:
    def test_racing_merged_dumps_lose_nothing(self, tmp_path):
        path = str(tmp_path / "tune.json")
        errors = []
        old = sys.getswitchinterval()

        def dump(worker):
            try:
                for i in range(6):
                    cfg = tuning.KernelConfig(shortlist=4 + worker,
                                              rescan_every=3)
                    key = tuning.shape_key(
                        "pruning", {"n_samples": 64 << worker, "m": 8 + i,
                                    "dim": 4}, platform="cpu")
                    with tuning._CACHE_LOCK:
                        tuning._CACHE[key] = cfg
                    tuning.dump_cache(path, merge=True)
            except Exception as e:       # pragma: no cover
                errors.append(e)

        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=dump, args=(w,))
                       for w in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[0]
        with open(path) as f:
            payload = json.load(f)
        assert len(payload["entries"]) == 8 * 6
        assert not os.path.exists(path + ".lock")

    def test_file_lock_breaks_orphans(self, tmp_path, monkeypatch):
        monkeypatch.setattr(tuning, "_LOCK_RETRIES", 5)
        path = str(tmp_path / "tune.json")
        with open(path + ".lock", "w") as f:
            f.write("999999")
        key = tuning.shape_key("pruning", {"n_samples": 64, "m": 8, "dim": 4},
                               platform="cpu")
        tuning._CACHE[key] = tuning.KernelConfig(shortlist=4, rescan_every=3)
        assert tuning.dump_cache(path, merge=True) == 1
        assert not os.path.exists(path + ".lock")
