"""BERT4Rec in the PyTorch port against the JAX reference, at the smoke
config: the config and its shapes, ``layer_norm``/``gelu``/``mlp``, the
forward with and without a key mask, user vectors, the sampled-softmax
head and loss, both train steps (sampled and full-logit) against
``jax.jit`` of the reference's, the serving cells (``serve_p99`` /
``retrieval_cand`` and ``serve_bulk``), checkpoints across the two
packages, and the train launcher's bit-exact resume.  Weights are the
reference's ``bert4rec_init``, carried across by ``convert``; batches
are the port's numpy-made ones, fed to both.

Tolerances (fp32): building blocks within 1e-6; logits, hidden states,
user vectors and serving scores within 1e-5 abs (|x| <= ~5; the
matmuls and attention sum in another order); losses within 1e-6
relative; gradients within 1e-6 abs + 1e-4 relative; parameters after
one AdamW step within 1e-7 abs wherever |g| clears the gradient
tolerance a hundredfold or is exactly 0 in the reference; top-k ids
equal wherever the gap to a neighbour exceeds 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as j_configs
from repro.launch import train as j_train
from repro.models import common as j_common
from repro.models import recsys as j_recsys
from repro.train import checkpoint as j_ckpt
from repro.train import losses as j_losses
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch import configs
from repro_torch.configs import bert4rec as bert4rec_cfg
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.launch import train as t_train
from repro_torch.models import common, convert, recsys
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, losses, optimizer, train_step

ATOL = 1e-5
G_ATOL, G_RTOL, P_ATOL = 1e-6, 1e-4, 1e-7
J_SMOKE = j_configs.get("bert4rec").smoke
SMOKE = bert4rec_cfg.SMOKE


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed=0):
    params = j_recsys.bert4rec_init(jax.random.PRNGKey(seed), J_SMOKE)
    model = tfm.Transformer(SMOKE.lm_config())
    model.load_state_dict(convert.params_from_jax(_np_tree(params), "lm"))
    return params, model


def _sampled(batch=6, seed=1, step=0, m=4, n=32):
    b = synthetic.bert4rec_sampled_batch(seed, step, batch, SMOKE.seq_len,
                                         SMOKE.n_items, m, n)
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _masked(batch=4, seed=2):
    b = synthetic.bert4rec_batch(seed, 0, batch, SMOKE.seq_len, SMOKE.n_items)
    b["attn_mask"][:, -5:] = False                      # padded tails
    b["attn_mask"][0, -9:] = False
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(
                    lambda t: t.detach().numpy()
                    if isinstance(t, torch.Tensor) else t, tree))[0]]


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


class TestConfigAndBlocks:
    def test_config_is_the_references(self):
        entry = configs.get("bert4rec")
        j_entry = j_configs.get("bert4rec")
        assert entry.family == j_entry.family == "recsys"
        for c, jc in ((entry.config, j_entry.config),
                      (entry.smoke, j_entry.smoke)):
            for f in ("name", "n_items", "embed_dim", "n_blocks", "n_heads",
                      "seq_len", "d_ff"):
                assert getattr(c, f) == getattr(jc, f), f
            assert c.param_dtype == c.compute_dtype == torch.float32
            lm, jlm = c.lm_config(), jc.lm_config()
            assert (lm.vocab, lm.causal, lm.tie_embeddings, lm.hd) == (
                jlm.vocab, jlm.causal, jlm.tie_embeddings, jlm.hd)
            assert lm.param_dtype == torch.float32
            assert c.param_count() == jc.param_count()
        assert {k: (s.kind, s.dims) for k, s in entry.shapes.items()} == {
            k: (s.kind, s.dims) for k, s in j_entry.shapes.items()}
        model = recsys.init_model(torch.Generator().manual_seed(0), SMOKE)
        assert isinstance(model, tfm.Transformer) and model.lm_head is None
        assert sum(p.numel() for p in model.parameters()) == \
            SMOKE.param_count()

    def test_layer_norm_gelu_mlp(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 16)).astype(np.float32) * 3 + 1
        g, b = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
        _close(common.layer_norm(*map(torch.from_numpy, (x, g, b))),
               j_common.layer_norm(x, g, b), atol=1e-6)
        xb = torch.from_numpy(x).bfloat16()
        got = common.layer_norm(xb, torch.from_numpy(g), torch.from_numpy(b))
        assert got.dtype == torch.bfloat16
        _close(common.gelu(torch.from_numpy(x)), j_common.gelu(x), atol=1e-6)
        ws = [rng.standard_normal(s).astype(np.float32) * 0.3
              for s in ((16, 8), (8, 4))]
        bs = [rng.standard_normal(4 if i else 8).astype(np.float32)
              for i in range(2)]
        tw, tb = [torch.from_numpy(w) for w in ws], [torch.from_numpy(v)
                                                     for v in bs]
        for final_act in (False, True):
            _close(common.mlp(torch.from_numpy(x), tw, tb,
                              final_act=final_act),
                   j_common.mlp(x, ws, bs, final_act=final_act), atol=1e-6)
        _close(common.mlp(torch.from_numpy(x), tw, None, act=common.gelu),
               j_common.mlp(x, ws, None, act=j_common.gelu), atol=1e-6)


class TestModel:
    @pytest.mark.parametrize("masked", [False, True])
    def test_forward_and_user_vectors(self, masked):
        params, model = _pair()
        b, jb = _masked()
        mask, jmask = ((b["attn_mask"], jb["attn_mask"]) if masked
                       else (None, None))
        want = j_recsys.bert4rec_forward(params, J_SMOKE, jb["items"], jmask)
        j_h, j_pool = j_recsys.bert4rec_user_vectors(params, J_SMOKE,
                                                     jb["items"], jmask)
        for backend in ("reference", "fused"):
            with torch.no_grad():
                got = recsys.bert4rec_forward(model, SMOKE, b["items"], mask,
                                              backend=backend)
                h, pool = recsys.bert4rec_user_vectors(
                    model, SMOKE, b["items"], mask, backend=backend)
            assert got.shape == (4, SMOKE.seq_len, SMOKE.n_items + 2)
            _close(got, want)
            _close(h, j_h)
            _close(pool, j_pool)

    def test_sampled_logits_and_losses(self):
        params, model = _pair(1)
        b, jb = _sampled()
        jpos, jneg = j_recsys.bert4rec_sampled_logits(
            params, J_SMOKE, jb["items"], jb["mask_idx"], jb["labels"],
            jb["negatives"])
        with torch.no_grad():
            pos, neg = recsys.bert4rec_sampled_logits(
                model, SMOKE, b["items"], b["mask_idx"], b["labels"],
                b["negatives"])
        assert pos.shape == (6, 4) and neg.shape == (6, 4, 32)
        _close(pos, jpos)
        _close(neg, jneg)
        np.testing.assert_allclose(
            recsys.sampled_softmax_loss(pos, neg).item(),
            float(j_recsys.sampled_softmax_loss(jpos, jneg)), rtol=1e-6)
        mb, jmb = _masked()
        logits = jax.random.normal(jax.random.PRNGKey(3),
                                   mb["items"].shape + (SMOKE.n_items + 2,))
        np.testing.assert_allclose(
            losses.masked_item_loss(torch.from_numpy(np.array(logits)),
                                    mb["labels"],
                                    mb["mask_positions"]).item(),
            float(j_losses.masked_item_loss(logits, jmb["labels"],
                                            jmb["mask_positions"])),
            rtol=1e-6)

    def test_batches(self):
        b = synthetic.bert4rec_batch(0, 3, 8, 24, 200)
        assert set(b) == {"items", "labels", "mask_positions", "attn_mask"}
        assert b["items"].dtype == b["labels"].dtype == torch.int32
        m = b["mask_positions"]
        assert m.dtype == torch.bool and 0 < int(m.sum()) < m.numel()
        assert torch.equal(b["items"][m], torch.full_like(b["items"][m], 3))
        assert torch.equal(b["items"][~m], b["labels"][~m])
        assert int(b["labels"].min()) >= 4 and int(b["labels"].max()) < 200
        assert bool(b["attn_mask"].all())
        again = synthetic.bert4rec_batch(0, 3, 8, 24, 200)
        assert all(torch.equal(b[k], again[k]) for k in b)
        s = synthetic.bert4rec_sampled_batch(0, 1, 8, 24, 200, 30, 64)
        assert {k: tuple(v.shape) for k, v in s.items()} == {
            "items": (8, 24), "mask_idx": (8, 30), "labels": (8, 30),
            "negatives": (64,)}
        assert int(s["mask_idx"].max()) < 24 and int(s["negatives"].min()) \
            >= 4

    def test_lm_params_round_trip_and_ranks(self):
        params, model = _pair()
        sd = dict(model.named_parameters())
        tree = convert.params_to_jax(sd, "lm")
        for (n, x), (_, y) in zip(_leaves(tree), _leaves(params)):
            np.testing.assert_array_equal(x, y, err_msg=n)
        ranks = convert.jax_ranks(sd, "lm")
        for name, rank in ranks.items():
            path, layer, _ = convert.jax_place(name, "lm")
            leaf = params
            for k in path:
                leaf = leaf[k]
            assert np.ndim(leaf) == rank, name
        assert ranks["layers.0.ln1"] == 2 and ranks["ln_f"] == 1


def _j_sampled_step(opt_cfg):
    """The BERT4Rec step of the reference's ``launch.train`` (defined
    inline in ``repro.launch.train.build_trainable``)."""
    _, step, _ = j_train.build_trainable("bert4rec", "smoke", 6, 24, opt_cfg)
    return step


def _j_sampled_loss(params, jb):
    pos, neg = j_recsys.bert4rec_sampled_logits(
        params, J_SMOKE, jb["items"], jb["mask_idx"], jb["labels"],
        jb["negatives"])
    return j_recsys.sampled_softmax_loss(pos, neg)


def _j_full_loss(params, jb):
    logits = j_recsys.bert4rec_forward(params, J_SMOKE, jb["items"],
                                       jb["attn_mask"])
    return j_losses.masked_item_loss(logits, jb["labels"],
                                     jb["mask_positions"])


class TestSteps:
    @pytest.mark.parametrize("kind", ["sampled", "full"])
    def test_one_step_matches_jax(self, kind):
        params, model = _pair(2)
        opt_cfg = j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
        t_opt = optimizer.AdamWConfig(**dataclasses.asdict(opt_cfg))
        if kind == "sampled":
            b, jb = _sampled()
            j_loss_fn, j_step_fn = _j_sampled_loss, _j_sampled_step(opt_cfg)
            loss = train_step.bert4rec_sampled_loss(SMOKE, model, b)
            t_step_fn = train_step.bert4rec_sampled_train_step(SMOKE, t_opt)
        else:
            b, jb = _masked()
            j_loss_fn = _j_full_loss
            j_step_fn = j_step.bert4rec_train_step(J_SMOKE, opt_cfg)
            loss = train_step.bert4rec_loss(SMOKE, model, b)
            t_step_fn = train_step.bert4rec_train_step(SMOKE, t_opt)
        j_loss, j_grads = jax.value_and_grad(j_loss_fn)(params, jb)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
        grads = convert.params_to_jax(train_step.param_grads(model, loss),
                                      "lm")
        got, want = _leaves(grads), _leaves(j_grads)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, atol=G_ATOL, rtol=G_RTOL,
                                       err_msg=name)

        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        jnew, jm = jax.jit(j_step_fn)(jstate, jb)
        new, tm = t_step_fn(train_step.make_train_state(model), b)
        assert new["step"] == int(jnew["step"]) == 1
        assert set(tm) == {"loss", "grad_norm", "lr"} <= set(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        got = _leaves(convert.params_to_jax(dict(model.named_parameters()),
                                            "lm"))
        for (name, p), (_, w), (_, g) in zip(got, _leaves(jnew["params"]),
                                             _leaves(j_grads)):
            g = np.abs(g)
            hold = (g > 100 * (G_ATOL + G_RTOL * g)) | (g == 0)
            assert hold.any(), name
            np.testing.assert_allclose(p[hold], w[hold], atol=P_ATOL, rtol=0,
                                       err_msg=name)

    def test_every_parameter_gets_a_gradient(self):
        """The sampled step differentiates the plain path: every
        parameter has a gradient, and the attention, FFN and embedding
        matrices nonzero ones (a kernel would have cut them off)."""
        _, model = _pair(3)
        b, _ = _sampled()
        grads = train_step.param_grads(
            model, train_step.bert4rec_sampled_loss(SMOKE, model, b))
        assert set(grads) == {n for n, _ in model.named_parameters()}
        for name, g in grads.items():
            if g.dim() == 2:
                assert bool(g.ne(0).any()), name
        assert {n for n in grads if "attn.w" in n} and \
            {n for n in grads if "w_up" in n}


class TestServing:
    def test_serve_p99_and_retrieval_cand(self):
        params, model = _pair(4)
        for batch in (5, 1):
            (vals, ids), tm = serve.serve_bert4rec(
                SMOKE, batch, k=10, device="cpu", seed=3, model=model)
            items = serve._bert4rec_items(SMOKE, batch, 3, "cpu")
            assert int(items.min()) >= 4
            _, user = j_recsys.bert4rec_user_vectors(
                params, J_SMOKE, jnp.asarray(items.numpy()))
            scores = j_recsys.score_candidates(user, params["embed"])
            jv, ji = jax.lax.top_k(scores, 11)
            assert ids.dtype == torch.int32 and ids.shape == (batch, 10)
            _close(vals, jv[:, :10])
            jv, ji = np.asarray(jv), np.asarray(ji)
            gap = np.minimum(np.abs(np.diff(jv, axis=1))[:, :10],
                             np.abs(np.diff(jv, axis=1, prepend=np.inf))
                             [:, :10])
            assert ((ids.numpy() == ji[:, :10]) | (gap <= ATOL)).all()
            assert set(tm) == {"serve_s"}
        # ties go to the lowest id
        with torch.no_grad():
            model.embed.weight[7] = model.embed.weight[150]
        (_, ids), _ = serve.serve_bert4rec(SMOKE, 1, k=SMOKE.n_items + 2,
                                           device="cpu", model=model)
        order = ids[0].tolist()
        assert order.index(7) < order.index(150)

    def test_serve_bulk(self):
        params, model = _pair(5)
        scores, tm = serve.serve_bert4rec_bulk(SMOKE, 7, device="cpu",
                                               seed=2, model=model)
        items = serve._bert4rec_items(SMOKE, 7, 2, "cpu")
        targets = np.random.default_rng((2, 1)).integers(
            4, SMOKE.n_items, size=7, dtype=np.int32)
        _, user = j_recsys.bert4rec_user_vectors(params, J_SMOKE,
                                                 jnp.asarray(items.numpy()))
        want = jnp.sum(user * params["embed"][targets], axis=-1)
        _close(scores, want)
        assert scores.shape == (7,) and "serve_s" in tm

    def test_serve_draws_its_model_and_needs_a_device(self):
        (v1, i1), tm = serve.serve_bert4rec(SMOKE, 2, k=4, device="cpu")
        (v2, i2), _ = serve.serve_bert4rec(SMOKE, 2, k=4, device="cpu")
        assert "init_s" in tm and torch.equal(v1, v2) and torch.equal(i1, i2)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                serve.serve_bert4rec(SMOKE, 2)


class TestCheckpointAndLaunch:
    def test_reference_checkpoint_restores_in_port(self, tmp_path):
        params, model = _pair(6)
        opt_cfg = j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        _, jb = _sampled()
        jstate, _ = jax.jit(_j_sampled_step(opt_cfg))(jstate, jb)
        j_ckpt.save(str(tmp_path), 1, jstate, compression="none")
        state = train_step.make_train_state(model)
        step, tree = checkpoint.restore_latest(str(tmp_path),
                                               train_step.state_tree(state))
        assert step == 1
        state = train_step.load_state_tree(state, tree)
        got = checkpoint.tree_flatten(train_step.state_tree(state))
        want = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert len(got) == len(want)
        for (name, x), (path, y) in zip(got, want):
            assert name == jax.tree_util.keystr(path)
            assert torch.equal(x, torch.from_numpy(np.array(y))), name

    def test_port_checkpoint_restores_in_reference(self, tmp_path):
        params, model = _pair(7)
        b, _ = _sampled()
        state = train_step.make_train_state(model)
        state, _ = train_step.bert4rec_sampled_train_step(
            SMOKE, optimizer.AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=4))(state, b)
        tree = train_step.state_tree(state)
        checkpoint.save(str(tmp_path), 1, tree)
        like = j_step.make_train_state(jax.random.PRNGKey(0),
                                       lambda k: params, j_opt.AdamWConfig())
        step, restored = j_ckpt.restore_latest(str(tmp_path), like)
        assert step == 1
        got = jax.tree_util.tree_flatten_with_path(restored)[0]
        want = checkpoint.tree_flatten(tree)
        assert len(got) == len(want)
        for (path, x), (name, y) in zip(got, want):
            assert jax.tree_util.keystr(path) == name
            assert torch.equal(torch.from_numpy(np.array(x)), y), name

    def test_stop_and_resume_is_bit_exact(self, tmp_path):
        kw = dict(steps=8, batch=6, log_every=0, device="cpu")
        full = t_train.run("bert4rec", **kw)
        ck = str(tmp_path / "c")
        part = t_train.run("bert4rec", ckpt_dir=ck, ckpt_every=3,
                           stop_after=4, **kw)
        rest = t_train.run("bert4rec", ckpt_dir=ck, **kw)
        assert rest["start"] == 4
        assert part["losses"] + rest["losses"] == full["losses"]
        a = checkpoint.tree_flatten(train_step.state_tree(rest["state"]))
        b = checkpoint.tree_flatten(train_step.state_tree(full["state"]))
        for (n, x), (_, y) in zip(a, b):
            assert torch.equal(x, y), n
        assert full["losses"][-1] < full["losses"][0] + 1.0   # finite, sane

    def test_launch_batches_and_full_preset_shape(self):
        opt = optimizer.AdamWConfig()
        _, _, mk = t_train.build_trainable("bert4rec", "smoke", 6, 32, opt,
                                           torch.device("cpu"))
        b = mk(2)
        assert b["mask_idx"].shape == (6, 4) and b["negatives"].shape == (32,)
        assert b["items"].shape == (6, SMOKE.seq_len)
        dims = configs.get("bert4rec").shapes["train_batch"].dims
        assert (dims["n_masked"], dims["n_negatives"]) == (30, 1024)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    assert torch.equal(common.gelu(x), F.gelu(x, approximate="tanh"))
