"""ColBERT training in the PyTorch port against the JAX reference: the
regularizers and losses, AdamW, the train step, the training driver and
its bit-exact resume, the step-indexed pipeline, the elastic policies
and the synthetic embedding corpora.  Weights cross over through
``params_from_jax``; the same numpy inputs feed both packages.

Tolerances: regularizers and losses within 1e-6 abs; the schedule and
one AdamW update within 1e-6 relative; the train step's loss and
accuracy within 1e-5, every gradient leaf but the embedding's within
1e-6 + 1e-4 |g|, the embedding's no further from the reference's float64
gradient (``jax_enable_x64``) than the reference's fp32 one, which lies
within 1e-5 of it, and the updated parameters within 1e-6 where |g|
clears that gradient tolerance a hundredfold (Adam's first
step is a sign function, so an element whose gradient is near 0 may
move the other way); the driver's five losses within 1e-4 relative.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.core import regularizers as j_reg
from repro.data import synthetic as j_synth
from repro.launch import train as j_train
from repro.models import colbert as j_colbert
from repro.train import losses as j_losses
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch.configs import colbert_base
from repro_torch.core import regularizers
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import train as t_train
from repro_torch.models import colbert as colbert_lib
from repro_torch.models.colbert import ColBERT
from repro_torch.models.convert import (jax_ranks, params_from_jax,
                                        params_to_jax)
from repro_torch.train import (checkpoint, elastic, losses, optimizer,
                               train_step)

J_SMOKE = configs.get("colbert").smoke


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model(params, tcfg=colbert_base.SMOKE):
    model = ColBERT(tcfg)
    model.load_state_dict(params_from_jax(_np(params)))
    return model


def _j_params(seed=0, jcfg=J_SMOKE):
    return j_colbert.init_params(jax.random.PRNGKey(seed), jcfg)


def _doc_batch(seed=0, B=3, m=7, dim=16):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((B, m, dim)).astype(np.float32) * 0.4
    mask = np.arange(m)[None, :] < rng.integers(1, m + 1, size=B)[:, None]
    return d, mask


def _close(got, want, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


class TestRegularizersAndLosses:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_regularizers(self, seed):
        d, mask = _doc_batch(seed)
        td, tm = torch.from_numpy(d), torch.from_numpy(mask)
        _close(regularizers.l1_reg(td, tm), j_reg.l1_reg(d, mask))
        _close(regularizers.doc_sim_reg(td, tm), j_reg.doc_sim_reg(d, mask))
        _close(regularizers.ball_projection(td), j_reg.ball_projection(d))

    def test_softmax_xent_and_lm_loss(self):
        rng = np.random.default_rng(2)
        logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
        tokens = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
        mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
        tl, tt, tmask = map(torch.from_numpy, (logits, tokens, mask))
        _close(losses.softmax_xent(tl, tt), j_losses.softmax_xent(
            logits, tokens))
        _close(losses.softmax_xent(tl, tt, tmask), j_losses.softmax_xent(
            logits, tokens, mask))
        _close(losses.lm_loss(tl, tt), j_losses.lm_loss(logits, tokens))
        _close(losses.lm_loss(tl, tt, tmask),
               j_losses.lm_loss(logits, tokens, mask))

    def test_bce_and_masked_item_loss(self):
        rng = np.random.default_rng(3)
        lg = (rng.standard_normal(17) * 6).astype(np.float32)
        lb = (rng.random(17) < 0.3).astype(np.float32)
        _close(losses.bce_logits(torch.from_numpy(lg), torch.from_numpy(lb)),
               j_losses.bce_logits(lg, lb))
        logits = rng.standard_normal((2, 6, 9)).astype(np.float32)
        labels = rng.integers(0, 9, size=(2, 6)).astype(np.int32)
        pos = rng.random((2, 6)) < 0.4
        _close(losses.masked_item_loss(*map(torch.from_numpy,
                                            (logits, labels, pos))),
               j_losses.masked_item_loss(logits, labels, pos))

    @pytest.mark.parametrize("reg", [None, "l1", "sim"])
    def test_colbert_contrastive(self, reg):
        rng = np.random.default_rng(4)
        q = rng.standard_normal((4, 5, 16)).astype(np.float32) * 0.3
        qm = np.ones((4, 5), bool)
        qm[1, 3:] = False
        d, dm = _doc_batch(5, B=4, m=9)
        tl, ts = losses.colbert_contrastive(
            *map(torch.from_numpy, (q, d, dm, qm)), reg=reg, alpha=0.1)
        jl, js = j_losses.colbert_contrastive(q, d, dm, qm, reg=reg,
                                              alpha=0.1)
        _close(tl, jl)
        _close(ts, js, atol=1e-5)


class TestOptimizer:
    @pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
    def test_schedule_lr(self, schedule):
        cfg = j_opt.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=150,
                                schedule=schedule)
        tcfg = optimizer.AdamWConfig(**dataclasses.asdict(cfg))
        got = np.array([float(optimizer.schedule_lr(tcfg, s))
                        for s in range(201)], np.float32)
        want = np.array([float(j_opt.schedule_lr(cfg, jnp.int32(s)))
                         for s in range(201)], np.float32)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert got[0] == 0.0

    def test_schedule_shapes(self):
        cfg = optimizer.AdamWConfig(lr=1.0, warmup_steps=10,
                                    total_steps=100, schedule="cosine",
                                    min_lr_ratio=0.1)
        lrs = [float(optimizer.schedule_lr(cfg, s))
               for s in (0, 5, 10, 50, 100)]
        assert lrs[0] == 0.0
        assert abs(lrs[1] - 0.5) < 1e-6
        assert abs(lrs[2] - 1.0) < 1e-6
        assert lrs[3] < lrs[2]
        assert abs(lrs[4] - 0.1) < 1e-6

    def test_adamw_converges_quadratic(self):
        cfg = optimizer.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                                    weight_decay=0.0, schedule="constant")
        params = {"w": torch.tensor([5.0, -3.0])}
        state = optimizer.init(params)
        for _ in range(200):
            g = {"w": 2 * params["w"]}
            params, state, _ = optimizer.apply(cfg, params, g, state)
        assert float((params["w"] ** 2).sum()) < 1e-3
        assert int(state.step) == 200

    def test_grad_norm_reported_before_clip(self):
        cfg = optimizer.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0,
                                    schedule="constant")
        params = {"w": torch.zeros(4)}
        _, _, stats = optimizer.apply(cfg, params, {"w": torch.full((4,),
                                                                    1e6)},
                                      optimizer.init(params))
        assert float(stats["grad_norm"]) > 1e6

    @staticmethod
    def _inputs(seed, grad_scale):
        """The SMOKE encoder's params, random grads and a random AdamW
        state at step 3, as the reference's trees."""
        params = _np(_j_params(seed))
        rng = np.random.default_rng(seed)

        def like(scale, positive=False):
            def f(p):
                x = rng.standard_normal(p.shape).astype(np.float32) * scale
                return np.abs(x) if positive else x
            return jax.tree_util.tree_map(f, params)
        state = j_opt.AdamWState(step=jnp.int32(3), m=like(1e-3),
                                 v=like(1e-6, positive=True))
        return params, like(grad_scale), state

    @pytest.mark.parametrize("grad_scale", [1e-3, 1.0],
                             ids=["unclipped", "clipped"])
    def test_apply_matches_jax(self, grad_scale):
        """Identical params, grads and state in both: params, m and v
        within 1e-6 relative, the decay rule by the reference's rank."""
        params, grads, state = self._inputs(0, grad_scale)
        cfg = j_opt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=50,
                                weight_decay=0.1)
        jp, js, jstats = j_opt.apply(cfg, params, grads, state)
        tp = {k: v.clone() for k, v in params_from_jax(params).items()}
        tstate = optimizer.AdamWState(
            torch.tensor(3, dtype=torch.int32),
            {k: v.clone() for k, v in params_from_jax(state.m).items()},
            {k: v.clone() for k, v in params_from_jax(state.v).items()})
        tp, ts, tstats = optimizer.apply(
            optimizer.AdamWConfig(**dataclasses.asdict(cfg)), tp,
            params_from_jax(grads), tstate, ranks=jax_ranks(tp))
        assert int(ts.step) == int(js.step) == 4
        _close(tstats["lr"], jstats["lr"], atol=0, rtol=1e-6)
        _close(tstats["grad_norm"], jstats["grad_norm"], atol=0, rtol=1e-6)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            got = params_to_jax(got)
            for (path, g), w in zip(
                    jax.tree_util.tree_flatten_with_path(got)[0],
                    jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w), rtol=1e-6, atol=0,
                    err_msg=jax.tree_util.keystr(path))

    def test_decay_by_reference_rank(self):
        """Zero grads, decay 1: a stacked layer's ln1 gain is a rank-2
        leaf in the reference and is decayed; ln_f (rank 1) is not."""
        params = _np(_j_params(1))
        zeros = jax.tree_util.tree_map(np.zeros_like, params)
        cfg = j_opt.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0,
                                schedule="constant")
        jp, _, _ = j_opt.apply(cfg, params, zeros, j_opt.init(params))
        tp = {k: v.clone() for k, v in params_from_jax(params).items()}
        optimizer.apply(optimizer.AdamWConfig(**dataclasses.asdict(cfg)),
                        tp, params_from_jax(zeros), optimizer.init(tp),
                        ranks=jax_ranks(tp))
        np.testing.assert_allclose(tp["backbone.layers.0.ln1"].numpy(), 0.9,
                                   rtol=1e-6)
        np.testing.assert_array_equal(tp["backbone.ln_f"].numpy(), 1.0)
        np.testing.assert_allclose(
            tp["backbone.layers.1.ln2"].numpy(),
            np.asarray(jp["backbone"]["layers"]["ln2"][1]), rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(jp["backbone"]["ln_f"]), 1.0)
        # the port's own rank would not decay the gain
        own = {k: v.clone() for k, v in params_from_jax(params).items()}
        optimizer.apply(optimizer.AdamWConfig(**dataclasses.asdict(cfg)),
                        own, params_from_jax(zeros), optimizer.init(own))
        np.testing.assert_array_equal(own["backbone.layers.0.ln1"].numpy(),
                                      1.0)


EMBED = "['backbone']['embed']"


# The reference's embedding gradient in float64: the JAX model under
# ``jax_enable_x64``, its fp32 upcasts read as float64, run in a process of
# its own (x64 is a process-wide switch).  argv: the params and batch
# (.npz), the output (.npz, one gradient per reg).
X64_EMBED_GRAD = r"""
import dataclasses, sys, types
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro import configs
from repro.core import regularizers, scoring
from repro.models import attention, colbert, common, transformer
from repro.train import losses


class Wide(types.ModuleType):
    def __getattr__(self, k):
        return jnp.float64 if k == "float32" else getattr(jnp, k)


for mod in (common, attention, transformer, colbert, losses, regularizers,
            scoring):
    mod.jnp = Wide("jnp")
data = np.load(sys.argv[1])
cfg = dataclasses.replace(configs.get("colbert").smoke,
                          param_dtype=jnp.float64, compute_dtype=jnp.float64)
tree = jax.tree_util.tree_structure(
    colbert.init_params(jax.random.PRNGKey(0), cfg))
params = jax.tree_util.tree_unflatten(tree, [
    jnp.asarray(data[f"p{i}"], jnp.float64) for i in range(tree.num_leaves)])
q_ids, doc_ids = jnp.asarray(data["query_ids"]), jnp.asarray(data["doc_ids"])
out = {}
for reg in ("none", "sim"):
    def loss(p):
        q, qm = colbert.encode_queries(p, cfg, q_ids)
        d, dm = colbert.encode_docs(p, cfg, doc_ids)
        return losses.colbert_contrastive(
            q, d, dm, qm, reg=None if reg == "none" else reg, alpha=0.1)[0]
    out[reg] = np.asarray(jax.grad(loss)(params)["backbone"]["embed"])
    assert out[reg].dtype == np.float64
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def x64_embed_grads(tmp_path_factory):
    """{reg: the reference's float64 embedding gradient} on the train
    step's fixture (params seed 2, :func:`_train_batch`)."""
    d = tmp_path_factory.mktemp("x64")
    leaves = jax.tree_util.tree_leaves(_np(_j_params(2)))
    np.savez(d / "in.npz", **_train_batch(colbert_base.SMOKE),
             **{f"p{i}": x for i, x in enumerate(leaves)})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    subprocess.run([sys.executable, "-c", X64_EMBED_GRAD, str(d / "in.npz"),
                    str(d / "out.npz")], check=True, env=env, timeout=300)
    out = np.load(d / "out.npz")
    return {None: out["none"], "sim": out["sim"]}


def _train_batch(cfg, B=4, seed=6):
    c = synthetic.token_corpus(seed, n_docs=B, n_q=B, vocab=cfg.vocab,
                               m=cfg.doc_len, l=cfg.query_len)
    return {"query_ids": c.q_ids, "doc_ids": c.doc_ids}


class TestTrainStep:
    @pytest.mark.parametrize("reg", [None, "sim"])
    def test_step_matches_jax(self, reg, x64_embed_grads):
        jcfg, tcfg = J_SMOKE, colbert_base.SMOKE
        params = _j_params(2)
        batch = _train_batch(tcfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

        def j_loss(p):
            q, qm = j_colbert.encode_queries(p, jcfg, jbatch["query_ids"])
            d, dm = j_colbert.encode_docs(p, jcfg, jbatch["doc_ids"])
            return j_losses.colbert_contrastive(q, d, dm, qm, reg=reg,
                                                alpha=0.1)[0]
        j_grads = jax.grad(j_loss)(params)
        opt_cfg = j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
        jstate = j_step.make_train_state(jax.random.PRNGKey(2),
                                         lambda k: _j_params(2), opt_cfg)
        jnew, jm = j_step.colbert_train_step(jcfg, opt_cfg, reg=reg,
                                             alpha=0.1)(jstate, jbatch)

        model = _model(params)
        state = train_step.make_train_state(model)
        # the port's grads, through the step's own loss
        q, qm = model.encode_queries(tbatch["query_ids"])
        d, dm = model.encode_docs(tbatch["doc_ids"])
        loss, _ = losses.colbert_contrastive(q, d, dm, qm, reg=reg,
                                             alpha=0.1)
        names = [n for n, _ in model.named_parameters()]
        t_grads = params_to_jax(dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters())))))
        # Every leaf but the embedding's within 1e-6 + 1e-4 |g|.  The
        # embedding gradient reaches ~10 and sums every occurrence of a
        # token, so where those sums cancel both packages keep the rounding
        # of the larger terms, in different orders (nn.Embedding's backward
        # against XLA's scatter-add).  That leaf is held to the reference's
        # float64 gradient: the reference's fp32 gradient lies within 1e-5
        # of it (5.94e-6 measured), and the port's no further than that.
        g64 = x64_embed_grads[reg]
        atols = []
        for (path, g), w in zip(
                jax.tree_util.tree_flatten_with_path(t_grads)[0],
                jax.tree_util.tree_leaves(j_grads)):
            w = np.asarray(w)
            if jax.tree_util.keystr(path) == EMBED:
                ref_dist = float(np.abs(w - g64).max())
                assert ref_dist <= 1e-5
                assert np.abs(g.numpy() - g64).max() <= ref_dist
                atols.append(ref_dist)
                continue
            atols.append(1e-6)
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-4,
                                       err_msg=jax.tree_util.keystr(path))
        assert EMBED in [jax.tree_util.keystr(p) for p, _ in
                         jax.tree_util.tree_flatten_with_path(t_grads)[0]]

        new, tm = train_step.colbert_train_step(
            tcfg, optimizer.AdamWConfig(**dataclasses.asdict(opt_cfg)),
            reg=reg, alpha=0.1)(state, tbatch)
        assert new["step"] == int(jnew["step"]) == 1
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr",
                                      "in_batch_acc"}
        for k in ("loss", "in_batch_acc"):
            _close(tm[k], jm[k], atol=1e-5)
        _close(tm["grad_norm"], jm["grad_norm"], atol=0, rtol=1e-4)
        got = params_to_jax(dict(model.named_parameters()))
        for (path, p), w, g, atol in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_leaves(jnew["params"]),
                jax.tree_util.tree_leaves(j_grads), atols):
            g = np.abs(np.asarray(g))
            clear = g > 100 * (atol + 1e-4 * g)
            assert clear.any(), jax.tree_util.keystr(path)
            np.testing.assert_allclose(
                p.detach().numpy()[clear], np.asarray(w)[clear], atol=1e-6,
                rtol=0, err_msg=jax.tree_util.keystr(path))

    def test_state_tree_names_are_the_references(self):
        params = _j_params(0)
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params,
                                         j_opt.AdamWConfig())
        want = [(jax.tree_util.keystr(p), np.shape(x)) for p, x in
                jax.tree_util.tree_flatten_with_path(jstate)[0]]
        tree = train_step.state_tree(train_step.make_train_state(
            _model(params)))
        got = [(n, tuple(x.shape)) for n, x in checkpoint.tree_flatten(tree)]
        assert got == want


@pytest.fixture
def jax_init(monkeypatch):
    """The port's driver initialises from the reference's weights."""
    def init(gen, cfg, device=None):
        assert cfg == colbert_base.SMOKE
        return _model(_j_params(0)).to(device)
    monkeypatch.setattr(colbert_lib, "init_params", init)


class TestDriver:
    def test_five_steps_match_jax(self, jax_init):
        want = j_train.run("colbert", steps=5, batch=8, log_every=0)
        got = t_train.run("colbert", steps=5, batch=8, log_every=0,
                          device="cpu")
        assert len(got["losses"]) == 5
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)

    def test_resume_is_bit_exact(self, tmp_path):
        """Eight steps straight == four, a stop, and four more resumed
        from the checkpoint: parameters and moments bit for bit."""
        kw = dict(steps=8, batch=4, log_every=0, device="cpu")
        full = t_train.run("colbert", ckpt_dir=str(tmp_path / "a"),
                           ckpt_every=100, **kw)
        part = t_train.run("colbert", ckpt_dir=str(tmp_path / "b"),
                           ckpt_every=2, stop_after=4, **kw)
        resumed = t_train.run("colbert", ckpt_dir=str(tmp_path / "b"),
                              ckpt_every=100, **kw)
        assert part["start"] == 0 and resumed["start"] == 4
        assert part["losses"] + resumed["losses"] == full["losses"]
        a, b = full["state"], resumed["state"]
        assert a["step"] == b["step"] == 8
        for x, y in zip(checkpoint.tree_flatten(train_step.state_tree(a)),
                        checkpoint.tree_flatten(train_step.state_tree(b))):
            assert x[0] == y[0] and torch.equal(x[1], y[1]), x[0]

    def test_resume_skips_corrupt_checkpoint(self, tmp_path):
        ck = str(tmp_path / "c")
        t_train.run("colbert", steps=8, batch=4, ckpt_dir=ck, ckpt_every=2,
                    log_every=0, stop_after=6, device="cpu")
        steps = checkpoint.list_steps(ck)
        newest = tmp_path / "c" / f"step_{steps[-1]:09d}" / "leaves.msgpack"
        with open(newest, "r+b") as f:
            f.seek(20)
            f.write(b"\xde\xad\xbe\xef")
        out = t_train.run("colbert", steps=8, batch=4, ckpt_dir=ck,
                          ckpt_every=100, log_every=0, device="cpu")
        assert out["start"] in steps[:-1]

    def test_other_families_raise(self):
        # the recsys family trains since its port (tests/
        # test_torch_recsys_train.py); the GNN family does not yet
        with pytest.raises(NotImplementedError, match="item 8"):
            t_train.run("gin-tu", steps=1, device="cpu")


class TestPipelineAndElastic:
    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_deterministic_replay(self, prefetch):
        mk = lambda step: synthetic.lm_batch(7, step, 4, 8, 100)
        p1 = pipeline.StepIndexedPipeline(mk, start_step=0,
                                          prefetch=prefetch)
        it = iter(p1)
        seen = [next(it) for _ in range(5)]
        p1.close()
        assert [s for s, _ in seen] == list(range(5))
        p2 = pipeline.StepIndexedPipeline(mk, start_step=3, prefetch=0)
        s3, b3 = next(iter(p2))
        assert s3 == 3
        np.testing.assert_array_equal(seen[3][1]["tokens"], b3["tokens"])

    def test_driver_batches_are_the_references(self):
        """The retrieval family's batch at step s is the reference's."""
        cfg = J_SMOKE
        _, _, t_mk = t_train.build_trainable(
            "colbert", "smoke", 8, 32, optimizer.AdamWConfig(), "cpu")
        _, _, j_mk = j_train.build_trainable("colbert", "smoke", 8, 32,
                                             j_opt.AdamWConfig())
        for s in (0, 5):
            got, want = t_mk(s), j_mk(s)
            for k in ("query_ids", "doc_ids"):
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got["doc_ids"].shape == (8, cfg.doc_len)

    def test_straggler_detection_and_rebalance(self):
        mon = elastic.StragglerMonitor(threshold=1.5, window=4, patience=2)
        for _ in range(8):
            for h in ("h0", "h1", "h2", "h3"):
                mon.record(h, 1.0 if h != "h3" else 3.0)
            mon.stragglers()
        assert "h3" in mon.stragglers()
        plan = mon.plan_rebalance({"h0": 4, "h1": 4, "h2": 4, "h3": 4})
        assert plan["h3"] == 3 and sum(plan.values()) == 16

    def test_no_false_positives(self):
        mon = elastic.StragglerMonitor(threshold=1.5, window=4, patience=2)
        rng = np.random.default_rng(0)
        for _ in range(12):
            for h in ("a", "b", "c"):
                mon.record(h, 1.0 + 0.05 * rng.standard_normal())
            mon.stragglers()
        assert mon.stragglers() == []

    def test_plan_mesh_and_rescale(self):
        fleet = elastic.FleetView(512, failed=frozenset(range(17)))
        assert elastic.plan_mesh(fleet, model_parallel=16) == (30, 16)
        with pytest.raises(RuntimeError, match="not enough healthy"):
            elastic.plan_mesh(elastic.FleetView(16, frozenset(range(15))),
                              16)
        out = elastic.rescale(32, 30, batch=256, lr=3e-4)
        assert out["global_batch"] == 256 and out["grad_accum"] == 2
        out = elastic.rescale(32, 16, batch=256, lr=3e-4,
                              keep_global_batch=False)
        assert out["global_batch"] == 128
        assert out["lr"] == pytest.approx(1.5e-4)


class TestEmbeddingCorpus:
    FIELDS = ("d_embs", "d_masks", "q_embs", "q_topics", "d_topics", "rel",
              "gains")

    @pytest.mark.parametrize("kw", [
        dict(seed=3, n_docs=20, n_q=5),
        dict(seed=1, n_docs=9, n_q=4, norm="ball", m=30, dim=8),
    ], ids=["sphere", "ball"])
    def test_embedding_corpus_is_the_references(self, kw):
        got, want = synthetic.embedding_corpus(**kw), \
            j_synth.embedding_corpus(**kw)
        for f in self.FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))
        assert got.d_embs.dtype == np.float32
        assert got.stop_frac == want.stop_frac

    def test_domain_shifted_is_the_references(self):
        got = synthetic.domain_shifted(2, 5, n_docs=11, n_q=3)
        want = j_synth.domain_shifted(2, 5, n_docs=11, n_q=3)
        for f in self.FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))
        assert got.stop_frac == 0.55
