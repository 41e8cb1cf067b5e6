"""The port's checkpointer: the reference's guarantees (atomic save,
integrity with fallback, keep policy with the in-flight registry, async
save), its on-disk format, and checkpoints that cross between the
packages in both directions.  Counterparts of
``tests/test_substrate.py::TestCheckpoint`` and
``tests/test_checkpoint_async.py``.
"""

import dataclasses
import io
import json
import os
import sys
import threading
import zlib

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro import configs
from repro.models import colbert as j_colbert
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch.configs import colbert_base
from repro_torch.data import synthetic
from repro_torch.models.colbert import ColBERT
from repro_torch.models.convert import params_from_jax
from repro_torch.train import checkpoint, optimizer, train_step

J_SMOKE = configs.get("colbert").smoke
CONFIGS = {
    "fp32": (J_SMOKE, colbert_base.SMOKE),
    "bf16": (dataclasses.replace(J_SMOKE, param_dtype=jnp.bfloat16,
                                 compute_dtype=jnp.bfloat16),
             dataclasses.replace(colbert_base.SMOKE,
                                 param_dtype=torch.bfloat16,
                                 compute_dtype=torch.bfloat16)),
}


def _tree(step: int):
    return {"w": torch.full((4, 3), float(step)),
            "b": torch.arange(3, dtype=torch.int32) + step}


def _equal(a, b):
    fa, fb = checkpoint.tree_flatten(a), checkpoint.tree_flatten(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


class TestCheckpoint:
    def test_roundtrip_and_keep_policy(self, tmp_path):
        root = str(tmp_path / "ckpt")
        tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                           "b": torch.ones(3, dtype=torch.bfloat16)},
                "step": torch.tensor(7, dtype=torch.int32)}
        for s in range(5):
            checkpoint.save(root, s, tree, keep=2)
        assert checkpoint.list_steps(root) == [3, 4]
        step, restored = checkpoint.restore_latest(root, tree)
        assert step == 4
        _equal(restored, tree)
        assert restored["params"]["b"].dtype == torch.bfloat16

    def test_corruption_falls_back(self, tmp_path):
        root = str(tmp_path / "ckpt")
        tree = {"w": torch.ones(4)}
        checkpoint.save(root, 1, tree)
        checkpoint.save(root, 2, {"w": torch.full((4,), 2.0)})
        with open(os.path.join(root, "step_000000002", "leaves.msgpack"),
                  "r+b") as f:
            f.seek(10)
            f.write(b"\x00\x00\x00\x00")
        step, restored = checkpoint.restore_latest(root, tree)
        assert step == 1
        assert torch.equal(restored["w"], torch.ones(4))

    def test_truncated_body_and_wrong_tree_fall_back(self, tmp_path):
        root = str(tmp_path / "ckpt")
        checkpoint.save(root, 1, _tree(1))
        checkpoint.save(root, 2, _tree(2))
        body = os.path.join(root, "step_000000002", "leaves.msgpack")
        with open(body, "r+b") as f:
            f.truncate(os.path.getsize(body) - 3)
        step, restored = checkpoint.restore_latest(root, _tree(0))
        assert step == 1
        _equal(restored, _tree(1))
        # a tree whose leaf names or shapes differ restores nothing
        assert checkpoint.restore_latest(root, {"v": torch.zeros(4, 3),
                                                "b": torch.zeros(3)}) == (
            None, None)
        assert checkpoint.restore_latest(root, {"w": torch.zeros(3, 4),
                                                "b": torch.zeros(3)}) == (
            None, None)

    def test_restore_empty(self, tmp_path):
        assert checkpoint.restore_latest(str(tmp_path / "nope"),
                                         {"w": torch.ones(1)}) == (None, None)

    def test_async_save(self, tmp_path):
        root = str(tmp_path / "ckpt")
        t = checkpoint.save_async(root, 3, {"w": torch.ones(8)})
        t.join(timeout=30)
        assert not t.is_alive()
        assert checkpoint.list_steps(root) == [3]

    def test_keep_period_archival(self, tmp_path):
        root = str(tmp_path / "ckpt")
        for s in range(0, 10):
            checkpoint.save(root, s, {"w": torch.ones(1)}, keep=2,
                            keep_period=4)
        steps = checkpoint.list_steps(root)
        assert 0 in steps and 4 in steps and 8 in steps and 9 in steps

    def test_format_is_the_references(self, tmp_path):
        """The manifest's fields and numpy dtype names; the body is each
        leaf's raw bytes as one msgpack bin object (bin8, bin16 and bin32
        here), exactly what ``msgpack`` packs; the crc32 is over the same
        bytes (a bf16 leaf's 2-byte words)."""
        tree = {"a": torch.arange(10, dtype=torch.bfloat16),
                "b": torch.zeros(100, dtype=torch.float32),
                "c": torch.ones(20000, dtype=torch.int8),
                "d": torch.tensor(True), "e": torch.zeros(0)}
        path = checkpoint.save(str(tmp_path), 5, tree)
        with open(os.path.join(path, "manifest.json")) as f:
            man = json.load(f)
        assert (man["step"], man["format"], man["compression"]) == (
            5, 1, "none")
        assert [(m["name"], m["dtype"], m["shape"]) for m in man["leaves"]] \
            == [("['a']", "bfloat16", [10]), ("['b']", "float32", [100]),
                ("['c']", "int8", [20000]), ("['d']", "bool", []),
                ("['e']", "float32", [0])]
        with open(os.path.join(path, "leaves.msgpack"), "rb") as f:
            body = f.read()
        bufs = list(msgpack.Unpacker(io.BytesIO(body)))
        assert body == b"".join(msgpack.packb(b) for b in bufs)
        assert bufs[0] == tree["a"].view(torch.int16).numpy().tobytes()
        for meta, buf in zip(man["leaves"], bufs):
            assert meta["nbytes"] == len(buf)
            assert meta["crc32"] == zlib.crc32(buf) & 0xFFFFFFFF

    def test_atomic_json_dump(self, tmp_path):
        path = str(tmp_path / "sub" / "m.json")
        checkpoint.atomic_json_dump(path, {"a": 1})
        checkpoint.atomic_json_dump(path, {"a": 2, "b": [3]})
        with open(path) as f:
            assert json.load(f) == {"a": 2, "b": [3]}
        assert os.listdir(tmp_path / "sub") == ["m.json"]

    def test_zstd_body_needs_zstandard(self, tmp_path, monkeypatch):
        """A zstd-compressed checkpoint raises where ``zstandard`` does
        not import (restore then finds nothing valid)."""
        path = checkpoint.save(str(tmp_path), 1, {"w": torch.ones(2)})
        man_path = os.path.join(path, "manifest.json")
        with open(man_path) as f:
            man = json.load(f)
        man["compression"] = "zstd"
        with open(man_path, "w") as f:
            json.dump(man, f)
        monkeypatch.setitem(sys.modules, "zstandard", None)
        with pytest.raises(ImportError, match="zstandard"):
            checkpoint._verify_and_load(path, {"w": torch.ones(2)})
        assert checkpoint.restore_latest(str(tmp_path),
                                         {"w": torch.ones(2)}) == (None, None)


class TestInflightRegistry:
    def test_registry_empty_after_save(self, tmp_path):
        root = str(tmp_path)
        checkpoint.save(root, 1, _tree(1), keep=2)
        assert checkpoint._inflight_steps(root) == set()

    def test_keep_policy_spares_inflight_steps(self, tmp_path):
        root = str(tmp_path)
        for s in (1, 2, 3):
            checkpoint.save(root, s, _tree(s), keep=0)
        key = (os.path.abspath(root), 1)
        with checkpoint._inflight_lock:
            checkpoint._inflight[key] = 1
        try:
            checkpoint._apply_keep_policy(root, keep=1, keep_period=0)
            assert checkpoint.list_steps(root) == [1, 3]
        finally:
            with checkpoint._inflight_lock:
                del checkpoint._inflight[key]
        checkpoint._apply_keep_policy(root, keep=1, keep_period=0)
        assert checkpoint.list_steps(root) == [3]

    def test_slow_async_writer_survives_concurrent_saves(
            self, tmp_path, monkeypatch):
        root = str(tmp_path)
        renamed = threading.Event()
        release = threading.Event()
        orig = checkpoint._apply_keep_policy

        def gated(r, keep, keep_period):
            if threading.current_thread() is not threading.main_thread():
                renamed.set()
                assert release.wait(timeout=30), "gate never released"
            return orig(r, keep, keep_period)

        monkeypatch.setattr(checkpoint, "_apply_keep_policy", gated)
        t = checkpoint.save_async(root, 1, _tree(1), keep=1)
        assert renamed.wait(timeout=30), "async writer never renamed"
        assert 1 in checkpoint.list_steps(root)
        checkpoint.save(root, 2, _tree(2), keep=1)
        checkpoint.save(root, 3, _tree(3), keep=1)
        assert 1 in checkpoint.list_steps(root), (
            "keep policy reaped a step whose writer is still in flight")
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        checkpoint.wait_pending()
        assert checkpoint._inflight_steps(root) == set()
        checkpoint.save(root, 4, _tree(4), keep=1)
        assert checkpoint.list_steps(root) == [4]

    def test_rapid_async_saves_leave_consistent_tail(self, tmp_path):
        root = str(tmp_path)
        for s in range(12):
            checkpoint.save_async(root, s, _tree(s), keep=2)
        checkpoint.wait_pending()
        assert checkpoint._inflight_steps(root) == set()
        steps = checkpoint.list_steps(root)
        assert steps and steps[-1] == 11
        for s in steps:
            got_step, tree = checkpoint._verify_and_load(
                os.path.join(root, f"step_{s:09d}"), _tree(0))
            assert got_step == s
            _equal(tree, _tree(s))
        step, tree = checkpoint.restore_latest(root, _tree(0))
        assert step == 11
        _equal(tree, _tree(11))

    def test_async_same_step_rename_race_tolerated(self, tmp_path):
        root = str(tmp_path)
        for _ in range(4):
            checkpoint.save_async(root, 7, _tree(7), keep=3)
        checkpoint.save(root, 7, _tree(7), keep=3)
        checkpoint.wait_pending()
        assert checkpoint.list_steps(root) == [7]
        step, tree = checkpoint.restore_latest(root, _tree(0))
        assert step == 7
        _equal(tree, _tree(7))
        assert [n for n in os.listdir(root) if n.startswith("tmp.")] == []


def _j_state(jcfg, trained: bool):
    """The reference's SMOKE train state, after one step where
    ``trained`` (so the moments are not zero)."""
    opt_cfg = j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    state = j_step.make_train_state(
        jax.random.PRNGKey(0), lambda k: j_colbert.init_params(k, jcfg),
        opt_cfg)
    if trained:
        c = synthetic.token_corpus(1, n_docs=4, n_q=4, vocab=jcfg.vocab,
                                   m=jcfg.doc_len, l=jcfg.query_len)
        batch = {"query_ids": jnp.asarray(c.q_ids),
                 "doc_ids": jnp.asarray(c.doc_ids)}
        state, _ = j_step.colbert_train_step(jcfg, opt_cfg, reg="sim",
                                             alpha=0.1)(state, batch)
    return state


def _leaf_tensor(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


class TestCrossPackage:
    @pytest.mark.parametrize("dtype", sorted(CONFIGS))
    def test_reference_checkpoint_restores_in_port(self, tmp_path, dtype):
        """A train state saved by the JAX package (compression="none")
        restores into the port's train state leaf for leaf, and the
        restored encoder encodes as the reference's."""
        jcfg, tcfg = CONFIGS[dtype]
        jstate = _j_state(jcfg, trained=True)
        j_ckpt.save(str(tmp_path), 1, jstate, compression="none")
        state = train_step.make_train_state(ColBERT(tcfg))
        step, tree = checkpoint.restore_latest(
            str(tmp_path), train_step.state_tree(state))
        assert step == 1
        state = train_step.load_state_tree(state, tree)
        assert state["step"] == 1 and int(state["opt"].step) == 1
        got = checkpoint.tree_flatten(train_step.state_tree(state))
        want = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert len(got) == len(want)
        for (name, x), (path, y) in zip(got, want):
            assert name == jax.tree_util.keystr(path)
            y = _leaf_tensor(y)
            assert x.dtype == y.dtype and torch.equal(x, y), name
        c = synthetic.token_corpus(3, n_docs=5, n_q=2, vocab=jcfg.vocab,
                                   m=jcfg.doc_len, l=jcfg.query_len)
        jd, _ = j_colbert.encode_docs(jstate["params"], jcfg,
                                      jnp.asarray(c.doc_ids))
        with torch.no_grad():
            td, _ = state["params"].encode_docs(torch.from_numpy(c.doc_ids))
        # fp32 as tests/test_torch_models.py holds the encoder; bf16 a
        # few bf16 ulps at 1.0, as it holds the bf16 encoder
        atol = 1e-5 if dtype == "fp32" else 5e-2
        np.testing.assert_allclose(td.float().numpy(),
                                   np.asarray(jd.astype(jnp.float32)),
                                   atol=atol)

    @pytest.mark.parametrize("dtype", sorted(CONFIGS))
    def test_port_checkpoint_restores_in_reference(self, tmp_path, dtype):
        """A train state saved by the port (after one of its steps)
        restores with the reference's ``restore_latest(like_tree=...)``
        into equal arrays."""
        jcfg, tcfg = CONFIGS[dtype]
        model = ColBERT(tcfg)
        model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray,
                                   j_colbert.init_params(
                                       jax.random.PRNGKey(0), jcfg))))
        state = train_step.make_train_state(model)
        c = synthetic.token_corpus(1, n_docs=4, n_q=4, vocab=jcfg.vocab,
                                   m=jcfg.doc_len, l=jcfg.query_len)
        state, _ = train_step.colbert_train_step(
            tcfg, optimizer.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=4),
            reg="sim", alpha=0.1)(state, {
                "query_ids": torch.from_numpy(c.q_ids),
                "doc_ids": torch.from_numpy(c.doc_ids)})
        tree = train_step.state_tree(state)
        checkpoint.save(str(tmp_path), 1, tree)
        step, restored = j_ckpt.restore_latest(str(tmp_path),
                                               _j_state(jcfg, False))
        assert step == 1
        got = jax.tree_util.tree_flatten_with_path(restored)[0]
        want = checkpoint.tree_flatten(tree)
        assert len(got) == len(want)
        for (path, x), (name, y) in zip(got, want):
            assert jax.tree_util.keystr(path) == name
            x = _leaf_tensor(x)
            assert x.dtype == y.dtype and torch.equal(x, y), name

    def test_pending_async_save_is_a_snapshot(self, tmp_path, monkeypatch):
        """``save_async`` returns before it writes; the next train step
        updates the parameters and moments in place (CPU tensors), and
        the pending save still writes the state as it was."""
        tcfg = colbert_base.SMOKE
        model = ColBERT(tcfg)
        state = train_step.make_train_state(model)
        step_fn = train_step.colbert_train_step(
            tcfg, optimizer.AdamWConfig(lr=1e-2, warmup_steps=0,
                                        total_steps=4))
        c = synthetic.token_corpus(1, n_docs=4, n_q=4, vocab=tcfg.vocab,
                                   m=tcfg.doc_len, l=tcfg.query_len)
        batch = {"query_ids": torch.from_numpy(c.q_ids),
                 "doc_ids": torch.from_numpy(c.doc_ids)}
        state, _ = step_fn(state, batch)
        before = {n: x.clone() for n, x in checkpoint.tree_flatten(
            train_step.state_tree(state))}

        started, release = threading.Event(), threading.Event()
        orig = checkpoint._save_locked

        def gated(*a, **kw):
            started.set()
            assert release.wait(timeout=30), "gate never released"
            return orig(*a, **kw)
        monkeypatch.setattr(checkpoint, "_save_locked", gated)
        t = checkpoint.save_async(str(tmp_path), 1,
                                  train_step.state_tree(state))
        assert started.wait(timeout=30)
        state, _ = step_fn(state, batch)          # in place, while pending
        after = dict(checkpoint.tree_flatten(train_step.state_tree(state)))
        # the embedding leaf is the parameter itself, not a copy
        for name in ("['params']['backbone']['embed']",
                     "['opt'].m['backbone']['embed']"):
            assert not torch.equal(after[name], before[name]), name
        release.set()
        t.join(timeout=30)
        assert not t.is_alive()
        _, restored = checkpoint.restore_latest(str(tmp_path),
                                                train_step.state_tree(state))
        for name, x in checkpoint.tree_flatten(restored):
            assert torch.equal(x, before[name]), name
