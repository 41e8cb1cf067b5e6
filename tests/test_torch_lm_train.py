"""LM training in the PyTorch port against the JAX reference:
``lm_train_step`` (MoE aux losses folded in, microbatch accumulation)
and ``lm_serve_step`` at the smoke configs of minitron-4b (dense) and
granite-moe-3b-a800m (MoE), remat, the LM train state under the
reference's leaf names and ranks, checkpoints across the packages, the
launcher's LM branch against the reference's and its bit-exact resume,
and the gradient error-feedback codec of ``train.compress``.  Weights
are the reference's ``init_params``, carried across by ``convert``;
token batches are the port's numpy ``lm_batch``, fed to both.

Tolerances: losses within 1e-6 relative; the gradient norm within 1e-5
relative; parameters after each AdamW step within 1e-7 abs wherever
every step's reference gradient so far cleared 100 x (1e-6 + 1e-4 |g|)
(Adam's first steps are nearly sign functions, so an element whose
gradient is near 0 may move the other way, and the next step starts
from there), and within 1e-6 after the second step (its gradients carry
that divergence: 1.4e-6 abs on the minitron smoke's embeddings, where
the first step's were within 3e-7); moments within 2e-4 relative +
1e-7 abs (m, (1 - b1) x the gradient tolerance) and 1e-10 abs (v), ten
times that after the second step; the
launcher's losses within 1e-5 relative; the codec bit for bit.  Every
MoE routing the port makes is clear of a near-tie (``test_torch_lm``'s
``GAP_TOL`` on the router logits).
"""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import train as j_train
from repro.models import transformer as j_tfm
from repro.train import checkpoint as j_ckpt
from repro.train import compress as j_compress
from repro.train import losses as j_losses
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch import configs
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import train as t_train
from repro_torch.models import convert
from repro_torch.models import transformer as t_tfm
from repro_torch.train import checkpoint, compress, optimizer, train_step
from test_torch_lm import _check_routing, _lm_pair

ARCHS = ["minitron-4b", "granite-moe-3b-a800m"]
G_ATOL, G_RTOL, P_ATOL = 1e-6, 1e-4, 1e-7
M_ATOL, V_ATOL = 1e-7, 1e-10
B, S = 4, 16


def _leaves(tree):
    """[(keystr, numpy)] in jax's order, for either package's tree."""
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(
                    lambda t: t.detach().numpy()
                    if isinstance(t, torch.Tensor) else t, tree))[0]]


def _to_jax(tensors):
    return convert.params_to_jax(tensors, "lm")


def _opt_cfg():
    return j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)


@functools.lru_cache(maxsize=None)
def _j_grad_fn(jcfg):
    def total(p, t):
        logits, aux = j_tfm.forward(p, t, jcfg)
        return (j_losses.lm_loss(logits, t)
                + 0.01 * (aux["load_balance"] + aux["router_z"]))
    return jax.jit(jax.grad(total))


def _j_grads(params, tokens, jcfg, accum):
    """The reference's gradients of ``lm_train_step``'s total loss,
    averaged over microbatches as its ``acc_body`` does."""
    grad = _j_grad_fn(jcfg)
    mbs = tokens.reshape(accum, -1, tokens.shape[1])
    gs = [grad(params, mb) for mb in mbs]
    return jax.tree_util.tree_map(lambda *g: sum(g) / accum, *gs)


class TestLmStep:
    @pytest.mark.parametrize("accum", [1, 2])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_two_steps_match_jax(self, arch, accum):
        jcfg, params, model = _lm_pair(arch)
        opt_cfg = _opt_cfg()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        j_fn = jax.jit(j_step.lm_train_step(jcfg, opt_cfg, accum=accum))
        state = train_step.make_train_state(model)
        t_fn = train_step.lm_train_step(
            model.cfg, optimizer.AdamWConfig(**dataclasses.asdict(opt_cfg)),
            accum=accum)
        clear = {}           # elements whose every step's gradient cleared
        for s in range(2):
            tok = lm_batch(0, s, B, S, jcfg.vocab)["tokens"]
            j_g = _j_grads(jstate["params"], jnp.asarray(tok), jcfg, accum)
            jstate, jm = j_fn(jstate, {"tokens": jnp.asarray(tok)})
            state, tm = t_fn(state, {"tokens": torch.from_numpy(tok)})
            assert state["step"] == int(jstate["step"]) == s + 1
            assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=1e-6)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)
            got = _leaves(_to_jax(dict(model.named_parameters())))
            want = _leaves(jstate["params"])
            assert [n for n, _ in got] == [n for n, _ in want]
            for (name, p), (_, w), (_, g) in zip(got, want, _leaves(j_g)):
                g = np.abs(g)
                hold = clear[name] = clear.get(name, True) & (
                    (g > 100 * (G_ATOL + G_RTOL * g)) | (g == 0))
                assert hold.any(), name
                np.testing.assert_allclose(p[hold], w[hold],
                                           atol=P_ATOL * 10 ** s, rtol=0,
                                           err_msg=name)
            for tree, jtree, atol in ((state["opt"].m, jstate["opt"].m,
                                       M_ATOL),
                                      (state["opt"].v, jstate["opt"].v,
                                       V_ATOL)):
                for (name, x), (_, y) in zip(_leaves(_to_jax(tree)),
                                             _leaves(jtree)):
                    np.testing.assert_allclose(x, y, atol=atol * 10 ** s,
                                               rtol=2e-4, err_msg=name)
        _check_routing(model)

    def test_loss_and_aux_match_jax(self):
        """``lm_loss_fn``: the total with the aux losses, the next-token
        loss and the aux means, against the reference's ``loss_fn``."""
        jcfg, params, model = _lm_pair("granite-moe-3b-a800m")
        tok = lm_batch(2, 0, B, S, jcfg.vocab)["tokens"]
        logits, aux = j_tfm.forward(params, jnp.asarray(tok), jcfg)
        loss = j_losses.lm_loss(logits, jnp.asarray(tok))
        total, t_loss, t_aux = train_step.lm_loss_fn(
            model, torch.from_numpy(tok), aux_weight=0.5)
        np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-6)
        for k in ("load_balance", "router_z"):
            np.testing.assert_allclose(t_aux[k].item(), float(aux[k]),
                                       rtol=1e-6)
        want = loss + 0.5 * (aux["load_balance"] + aux["router_z"])
        np.testing.assert_allclose(total.item(), float(want), rtol=1e-6)
        assert t_aux["load_balance"].item() > 0
        _check_routing(model)

    def test_serve_step_matches_jax(self):
        jcfg, params, model = _lm_pair("granite-moe-3b-a800m")
        tok = lm_batch(4, 0, 2, 1, jcfg.vocab)["tokens"]
        want, _ = j_step.lm_serve_step(jcfg)(
            params, j_tfm.init_cache(jcfg, 2, 4), jnp.asarray(tok),
            jnp.int32(0))
        got, cache = train_step.lm_serve_step(model.cfg)(
            model, model.init_cache(2, 4), torch.from_numpy(tok), 0)
        assert not got.requires_grad and cache["k"].shape[0] == 2
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        _check_routing(model)

    def test_remat_recomputes_each_block(self):
        """With ``remat`` each block runs again in the backward (the
        reference's ``jax.checkpoint``), and the gradients are the same
        bits as without."""
        grads, calls = {}, {}
        tok = torch.from_numpy(lm_batch(5, 0, B, S, 128)["tokens"])
        for remat in (False, True):
            _, _, model = _lm_pair("granite-moe-3b-a800m")
            model.cfg = dataclasses.replace(model.cfg, remat=remat)
            n = [0]          # a pre-hook: recomputation may stop early
            model.layers[0].register_forward_pre_hook(
                lambda *a: n.__setitem__(0, n[0] + 1))
            total, _, _ = train_step.lm_loss_fn(model, tok)
            grads[remat] = train_step.param_grads(model, total)
            calls[remat] = n[0]
        assert calls == {False: 1, True: 2}
        for name, g in grads[False].items():
            assert torch.equal(g, grads[True][name]), name

    def test_every_parameter_gets_a_gradient(self):
        """The MoE leaves (router and experts of every layer) reach the
        loss: the aux losses through the router, the experts through the
        kept tokens."""
        _, _, model = _lm_pair("granite-moe-3b-a800m")
        tok = torch.from_numpy(lm_batch(6, 0, B, S, 128)["tokens"])
        total, _, _ = train_step.lm_loss_fn(model, tok)
        grads = train_step.param_grads(model, total)
        assert set(grads) == {n for n, _ in model.named_parameters()}
        for name, g in grads.items():
            if "moe" in name:
                assert bool(g.ne(0).any()), name


class TestLmState:
    def test_state_tree_names_and_ranks_are_the_references(self):
        _, params, model = _lm_pair("granite-moe-3b-a800m")
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params,
                                         j_opt.AdamWConfig())
        want = [(jax.tree_util.keystr(p), np.shape(x)) for p, x in
                jax.tree_util.tree_flatten_with_path(jstate)[0]]
        tree = train_step.state_tree(train_step.make_train_state(model))
        got = [(n, tuple(x.shape)) for n, x in checkpoint.tree_flatten(tree)]
        assert got == want
        ranks = convert.jax_ranks(dict(model.named_parameters()), "lm")
        for name, rank in ranks.items():
            path, _, _ = convert.jax_place(name, "lm")
            leaf = params
            for k in path:
                leaf = leaf[k]
            assert np.ndim(leaf) == rank, name
        assert ranks["layers.0.moe.router"] == 3
        assert ranks["layers.1.moe.w_down"] == 4
        # the round trip is exact, the router fp32 at any param dtype
        back = convert.params_from_jax(tree["params"], "lm")
        for n, p in model.named_parameters():
            assert torch.equal(back[n], p.detach()), n

    def test_port_checkpoint_restores_in_reference(self, tmp_path):
        jcfg, params, model = _lm_pair("granite-moe-3b-a800m")
        state = train_step.make_train_state(model)
        state, _ = train_step.lm_train_step(
            model.cfg, optimizer.AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=4))(
            state, {"tokens": torch.from_numpy(
                lm_batch(7, 0, B, S, jcfg.vocab)["tokens"])})
        tree = train_step.state_tree(state)
        checkpoint.save(str(tmp_path), 1, tree)
        like = j_step.make_train_state(jax.random.PRNGKey(0),
                                       lambda k: params, _opt_cfg())
        step, restored = j_ckpt.restore_latest(str(tmp_path), like)
        assert step == 1
        got = jax.tree_util.tree_flatten_with_path(restored)[0]
        want = checkpoint.tree_flatten(tree)
        assert len(got) == len(want)
        for (path, x), (name, y) in zip(got, want):
            assert jax.tree_util.keystr(path) == name
            assert torch.equal(torch.from_numpy(np.array(x)), y), name


@pytest.fixture
def jax_init(monkeypatch):
    """The port's launcher draws the reference's weights, and the
    reference's reads the port's numpy-made token batches."""
    def init(gen, cfg, device=None):
        arch = {configs.get(a).smoke: a for a in ARCHS}[cfg]
        return _lm_pair(arch)[2].to(device)

    def j_batch(seed, step, batch, seq, vocab):
        return {"tokens": jnp.asarray(lm_batch(seed, step, batch, seq,
                                               vocab)["tokens"])}
    monkeypatch.setattr(t_tfm, "init_params", init)
    monkeypatch.setattr(j_train.synthetic, "lm_batch", j_batch)


class TestLauncher:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_five_steps_match_jax(self, arch, jax_init):
        want = j_train.run(arch, steps=5, batch=B, seq=S, log_every=0)
        got = t_train.run(arch, steps=5, batch=B, seq=S, log_every=0,
                          device="cpu")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)

    def test_stop_and_resume_is_bit_exact(self, tmp_path, monkeypatch,
                                          capsys):
        """granite-moe-3b-a800m: six steps stopped after three and
        resumed equal six uninterrupted ones, bit for bit (losses,
        parameters, moments), resumed by ``run`` and by the CLI
        (``--arch granite-moe-3b-a800m``)."""
        arch = "granite-moe-3b-a800m"
        kw = dict(steps=6, batch=B, seq=S, log_every=0, device="cpu")
        full = t_train.run(arch, **kw)
        want = checkpoint.tree_flatten(train_step.state_tree(full["state"]))
        for resume in ("run", "cli"):
            ck = str(tmp_path / resume)
            part = t_train.run(arch, ckpt_dir=ck, ckpt_every=2,
                               stop_after=3, **kw)
            assert part["losses"] == full["losses"][:3]
            if resume == "run":
                rest = t_train.run(arch, ckpt_dir=ck, **kw)
                assert rest["start"] == 3
                assert part["losses"] + rest["losses"] == full["losses"]
            else:
                monkeypatch.setattr(sys, "argv", [
                    "train", "--arch", arch, "--steps", "6", "--batch",
                    str(B), "--seq", str(S), "--ckpt-dir", ck, "--device",
                    "cpu"])
                t_train.main()
                assert "[train] resumed from step 3" in \
                    capsys.readouterr().out
            step, tree = checkpoint.restore_latest(
                ck, train_step.state_tree(full["state"]))
            assert step == 6
            got = checkpoint.tree_flatten(tree)
            assert [n for n, _ in got] == [n for n, _ in want]
            for (n, x), (_, y) in zip(got, want):
                assert torch.equal(x, y), (resume, n)


class TestCompress:
    def test_int8_roundtrip_accuracy(self):
        g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
            1000).astype(np.float32))}
        q, res = compress.compress_tree(g, compress.init_residuals(g))
        deq = compress.decompress_tree(q, g)
        err = float((deq["w"] - g["w"]).abs().max())
        assert err <= float(g["w"].abs().max()) / 127 + 1e-6
        torch.testing.assert_close(res["w"], g["w"] - deq["w"], atol=0,
                                   rtol=0)

    def test_error_feedback_matches_reference(self):
        """50 EF steps of a tiny constant gradient (heavy quantization
        noise) on a nested tree: the int8 codes, scales, residuals and
        decoded gradients equal the reference's bit for bit, and the
        mean of the decoded gradients converges to the true one."""
        rng = np.random.default_rng(1)
        arrays = {"w": np.full((512,), 0.001, np.float32),
                  "layer": {"b": rng.standard_normal((3, 7)).astype(
                      np.float32) * 1e-3}}
        jg = jax.tree_util.tree_map(jnp.asarray, arrays)
        tg = jax.tree_util.tree_map(torch.from_numpy, arrays)
        jres, tres = j_compress.init_residuals(jg), compress.init_residuals(tg)
        total = torch.zeros(512)
        for _ in range(50):
            jq, jres = j_compress.compress_tree(jg, jres)
            tq, tres = compress.compress_tree(tg, tres)
            for (n, x), (_, y) in zip(_leaves(tq), _leaves(jq)):
                assert np.array_equal(x, y), n
            for (n, x), (_, y) in zip(_leaves(tres), _leaves(jres)):
                assert np.array_equal(x, y), n
            deq = compress.decompress_tree(tq, tg)
            jdeq = j_compress.decompress_tree(jq, jg)
            for (n, x), (_, y) in zip(_leaves(deq), _leaves(jdeq)):
                assert np.array_equal(x, y), n
            total += deq["w"]
        np.testing.assert_allclose((total / 50).numpy(), 0.001, rtol=0.2)
