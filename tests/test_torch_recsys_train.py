"""CTR training of the recsys family in the PyTorch port against the JAX
reference: ``ctr_train_step`` and ``ctr_serve_step`` for dlrm-rm2,
dcn-v2 and wide-deep at their smoke configs, the train state under the
reference's leaf names and ranks, checkpoints across the two packages,
the train launcher against the reference's and its bit-exact
resume, the fixed-order gather backward (``core.segment``) and chunked
checkpoint leaves.  Weights are the reference's ``*_init``, carried
across by ``convert``; batches are the port's numpy-made ``ctr_batch``,
fed to both.

Tolerances: the loss within 1e-6 relative; gradients within 1e-6 abs +
1e-4 relative (fp32 sums in another order: the MLPs' matmuls and a
table row's repeats); parameters after one AdamW step within 1e-7 abs
wherever |g| clears the gradient tolerance a hundredfold (Adam's first
step is a sign function, so an element whose gradient is near 0 may
move the other way; a table row no id hit has g exactly 0 in both and
is held everywhere); the launcher's losses within 1e-5 relative;
probabilities within 1e-6.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch import train as j_train
from repro.models import recsys as j_recsys
from repro.train import checkpoint as j_ckpt
from repro.train import losses as j_losses
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch import configs
from repro_torch.core.segment import segment_rows_sum, take_rows
from repro_torch.data.synthetic import ctr_batch
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.launch import train as t_train
from repro_torch.models import convert, recsys
from repro_torch.train import checkpoint, optimizer, train_step

ARCHS = ["dlrm-rm2", "dcn-v2", "wide-deep"]
J_INIT = {"dlrm-rm2": j_recsys.dlrm_init, "dcn-v2": j_recsys.dcn_init,
          "wide-deep": j_recsys.widedeep_init}
MODEL = {"dlrm-rm2": recsys.DLRM, "dcn-v2": recsys.DCN,
         "wide-deep": recsys.WideDeep}
G_ATOL, G_RTOL, P_ATOL = 1e-6, 1e-4, 1e-7


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j_fwd(arch, j_cfg):
    """The forward of ``arch`` in the reference's launch/train.py."""
    if arch == "wide-deep":
        return lambda p, b: j_recsys.widedeep_forward(p, j_cfg,
                                                      b["sparse_ids"])
    f = {"dlrm-rm2": j_recsys.dlrm_forward,
         "dcn-v2": j_recsys.dcn_forward}[arch]
    return lambda p, b: f(p, j_cfg, b["dense"], b["sparse_ids"])


def _pair(arch, seed=0):
    j_cfg = j_configs.get(arch).smoke
    cfg = configs.get(arch).smoke
    params = J_INIT[arch](jax.random.PRNGKey(seed), j_cfg)
    model = MODEL[arch](cfg)
    model.load_state_dict(convert.params_from_jax(_np_tree(params), arch))
    return params, j_cfg, model, cfg


def _batches(cfg, batch=16, seed=3, step=0):
    b = ctr_batch(seed, step, batch, 13, cfg.n_sparse, cfg.table_rows)
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _to_jax(model, grads):
    return convert.params_to_jax(grads, convert.family_of(model),
                                 n_features=model.cfg.n_sparse)


def _leaves(tree):
    """[(keystr, numpy)] in jax's order, for either package's tree."""
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(
                    lambda t: t.detach().numpy()
                    if isinstance(t, torch.Tensor) else t, tree))[0]]


def _opt_cfg():
    return j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)


class TestCtrStep:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_one_step_matches_jax(self, arch):
        params, j_cfg, model, cfg = _pair(arch)
        b, jb = _batches(cfg)
        fwd = _j_fwd(arch, j_cfg)
        j_loss, j_grads = jax.value_and_grad(
            lambda p: j_losses.bce_logits(fwd(p, jb), jb["labels"]))(params)
        loss = train_step.ctr_loss(recsys.ctr_forward, model, b)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
        grads = train_step.param_grads(model, loss)
        got, want = _leaves(_to_jax(model, grads)), _leaves(j_grads)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, atol=G_ATOL, rtol=G_RTOL,
                                       err_msg=name)

        opt_cfg = _opt_cfg()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        jnew, jm = jax.jit(j_step.ctr_train_step(fwd, opt_cfg))(jstate, jb)
        state = train_step.make_train_state(model)
        new, tm = train_step.ctr_train_step(
            recsys.ctr_forward,
            optimizer.AdamWConfig(**dataclasses.asdict(opt_cfg)))(state, b)
        assert new["step"] == int(jnew["step"]) == 1
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        got = _leaves(_to_jax(model, dict(model.named_parameters())))
        for (name, p), (_, w), (_, g) in zip(got, _leaves(jnew["params"]),
                                             _leaves(j_grads)):
            g = np.abs(g)
            hold = (g > 100 * (G_ATOL + G_RTOL * g)) | (g == 0)
            assert hold.any(), name
            np.testing.assert_allclose(p[hold], w[hold], atol=P_ATOL, rtol=0,
                                       err_msg=name)
        # the moments too
        for tree, jtree in ((new["opt"].m, jnew["opt"].m),
                            (new["opt"].v, jnew["opt"].v)):
            for (name, x), (_, y) in zip(_leaves(_to_jax(model, tree)),
                                         _leaves(jtree)):
                np.testing.assert_allclose(x, y, atol=1e-9, rtol=2e-4,
                                           err_msg=name)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_serve_step_matches_jax(self, arch):
        params, j_cfg, model, cfg = _pair(arch)
        b, jb = _batches(cfg, seed=5)
        want = j_step.ctr_serve_step(_j_fwd(arch, j_cfg))(params, jb)
        before = embedding_bag_op.launches
        for backend in ("reference", "fused"):
            got = train_step.ctr_serve_step(recsys.ctr_forward,
                                            backend=backend)(model, b)
            assert not got.requires_grad
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
        assert embedding_bag_op.launches == before      # plain on the CPU

    @pytest.mark.parametrize("arch", ARCHS)
    def test_every_parameter_gets_a_gradient(self, arch):
        """The step differentiates the plain path: every parameter has a
        gradient, every matrix a nonzero one (a kernel launch would have
        cut the tables or the MLPs from the graph)."""
        *_, model, cfg = _pair(arch)
        b, _ = _batches(cfg)
        grads = train_step.param_grads(
            model, train_step.ctr_loss(recsys.ctr_forward, model, b))
        assert set(grads) == {n for n, _ in model.named_parameters()}
        for name, g in grads.items():
            if g.dim() == 2:
                assert bool(g.ne(0).any()), name
        # the rows the batch hit, and only those, moved
        hit = recsys.stacked_ids(b["sparse_ids"], cfg.table_rows).long()
        rows = grads["tables"].ne(0).any(-1)
        assert bool(rows[hit.unique()].all())
        assert int(rows.sum()) <= hit.unique().numel()

    def test_state_tree_names_and_ranks_are_the_references(self):
        for arch in ARCHS:
            params, _, model, _ = _pair(arch)
            jstate = j_step.make_train_state(
                jax.random.PRNGKey(0), lambda k: params, j_opt.AdamWConfig())
            want = [(jax.tree_util.keystr(p), np.shape(x)) for p, x in
                    jax.tree_util.tree_flatten_with_path(jstate)[0]]
            tree = train_step.state_tree(train_step.make_train_state(model))
            got = [(n, tuple(x.shape))
                   for n, x in checkpoint.tree_flatten(tree)]
            assert got == want, arch
            # each parameter's rank is its leaf's rank in the reference
            ranks = convert.jax_ranks(dict(model.named_parameters()), arch)
            for name, rank in ranks.items():
                path, _, _ = convert.jax_place(name, arch)
                leaf = params
                for k in path:
                    leaf = leaf[k]
                assert np.ndim(leaf) == rank, (arch, name)
            assert ranks["tables"] == 3

    @pytest.mark.parametrize("arch", ARCHS)
    def test_params_round_trip(self, arch):
        params, _, model, cfg = _pair(arch)
        sd = dict(model.named_parameters())
        tree = convert.params_to_jax(sd, arch, n_features=cfg.n_sparse)
        for (name, x), (_, y) in zip(_leaves(tree), _leaves(params)):
            np.testing.assert_array_equal(x, y, err_msg=name)
        back = convert.params_from_jax(tree, arch)
        assert set(back) == set(sd)
        for n in sd:
            assert torch.equal(back[n], sd[n].detach()), n
        with pytest.raises(ValueError, match="feature count"):
            convert.params_to_jax(sd, arch)


class TestSegment:
    def test_sums_match_index_add_in_order(self):
        rng = np.random.default_rng(0)
        rows = torch.from_numpy(rng.integers(0, 9, 200))
        vals = torch.from_numpy(rng.standard_normal((200, 3)).astype(
            np.float32))
        got = segment_rows_sum(vals, rows, 12)
        want = torch.zeros((12, 3))
        for i in range(200):                      # one add at a time
            want[rows[i]] = want[rows[i]] + vals[i]
        assert torch.equal(got, want)
        assert segment_rows_sum(vals[:0], rows[:0], 4).eq(0).all()

    def test_take_rows_gradient_is_deterministic(self):
        torch.manual_seed(0)
        table = torch.randn((50, 6), requires_grad=True)
        idx = torch.randint(0, 50, (40, 30))
        out = take_rows(table, idx)
        assert torch.equal(out, table.detach()[idx])
        w = torch.randn(out.shape)
        g1, = torch.autograd.grad((take_rows(table, idx) * w).sum(), table)
        g2, = torch.autograd.grad((take_rows(table, idx) * w).sum(), table)
        assert torch.equal(g1, g2)
        want = torch.zeros_like(table).index_add_(0, idx.reshape(-1),
                                                  w.reshape(-1, 6))
        torch.testing.assert_close(g1, want, rtol=1e-5, atol=1e-6)


class TestCheckpoint:
    def test_reference_checkpoint_restores_in_port(self, tmp_path):
        params, j_cfg, model, cfg = _pair("dlrm-rm2", seed=1)
        b, jb = _batches(cfg)
        opt_cfg = _opt_cfg()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        jstate, _ = jax.jit(j_step.ctr_train_step(
            _j_fwd("dlrm-rm2", j_cfg), opt_cfg))(jstate, jb)
        j_ckpt.save(str(tmp_path), 1, jstate, compression="none")
        state = train_step.make_train_state(model)
        step, tree = checkpoint.restore_latest(str(tmp_path),
                                               train_step.state_tree(state))
        assert step == 1
        state = train_step.load_state_tree(state, tree)
        assert state["step"] == 1 and int(state["opt"].step) == 1
        got = checkpoint.tree_flatten(train_step.state_tree(state))
        want = jax.tree_util.tree_flatten_with_path(jstate)[0]
        assert len(got) == len(want)
        for (name, x), (path, y) in zip(got, want):
            assert name == jax.tree_util.keystr(path)
            assert torch.equal(x, torch.from_numpy(np.array(y))), name

    def test_port_checkpoint_restores_in_reference(self, tmp_path):
        params, _, model, cfg = _pair("dlrm-rm2", seed=2)
        b, _ = _batches(cfg)
        state = train_step.make_train_state(model)
        state, _ = train_step.ctr_train_step(
            recsys.ctr_forward, optimizer.AdamWConfig(
                lr=1e-3, warmup_steps=1, total_steps=4))(state, b)
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

    def test_chunked_leaf_round_trip(self, tmp_path, monkeypatch):
        """A leaf of more than ``BIN_MAX`` bytes is written as several bin
        objects (``chunks`` in its manifest entry) and read back whole; a
        flipped byte in a later chunk fails its checksum."""
        monkeypatch.setattr(checkpoint, "BIN_MAX", 64)
        tree = {"big": torch.arange(50, dtype=torch.float32),
                "small": torch.ones(3, dtype=torch.bfloat16),
                "empty": torch.zeros(0)}
        path = checkpoint.save(str(tmp_path), 1, tree)
        import json
        with open(f"{path}/manifest.json") as f:
            metas = {m["name"]: m for m in json.load(f)["leaves"]}
        assert metas["['big']"]["chunks"] == 4 and "chunks" not in \
            metas["['small']"]
        step, got = checkpoint.restore_latest(str(tmp_path), tree)
        assert step == 1
        for k in tree:
            assert got[k].dtype == tree[k].dtype and torch.equal(got[k],
                                                                 tree[k])
        with open(f"{path}/leaves.msgpack", "r+b") as f:
            f.seek(8 + 5 + 64 * 3 + 2)               # inside the 4th chunk
            f.write(b"\xff")
        assert checkpoint.restore_latest(str(tmp_path), tree) == (None, None)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's launcher draws the reference's weights, and the
    reference's reads the port's numpy-made batches."""
    def init(gen, cfg, device=None):
        arch = {configs.get(a).smoke: a for a in ARCHS}[cfg]
        return _pair(arch)[2].to(device)

    def j_batch(seed, step, batch, n_dense, n_sparse, table_rows):
        b = ctr_batch(seed, step, batch, n_dense, n_sparse, table_rows)
        return {k: jnp.asarray(v.numpy()) for k, v in b.items()}
    monkeypatch.setattr(recsys, "init_model", init)
    monkeypatch.setattr(j_train.synthetic, "ctr_batch", j_batch)


class TestLauncher:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_five_steps_match_jax(self, arch, jax_init):
        want = j_train.run(arch, steps=5, batch=8, log_every=0)
        got = t_train.run(arch, steps=5, batch=8, log_every=0, device="cpu")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["final_loss"] == got["losses"][-1]

    @pytest.mark.parametrize("arch", ARCHS)
    def test_stop_and_resume_is_bit_exact(self, arch, tmp_path):
        kw = dict(steps=8, batch=8, log_every=0, device="cpu")
        full = t_train.run(arch, **kw)
        ck = str(tmp_path / "c")
        part = t_train.run(arch, ckpt_dir=ck, ckpt_every=2, stop_after=5,
                           **kw)
        rest = t_train.run(arch, ckpt_dir=ck, **kw)
        assert rest["start"] == 5
        assert part["losses"] + rest["losses"] == full["losses"]
        a = checkpoint.tree_flatten(train_step.state_tree(rest["state"]))
        b = checkpoint.tree_flatten(train_step.state_tree(full["state"]))
        assert [n for n, _ in a] == [n for n, _ in b]
        for (n, x), (_, y) in zip(a, b):
            assert torch.equal(x, y), n

    def test_gnn_still_raises(self, monkeypatch, capsys):
        # gin-tu trains since the GNN's port (tests/test_torch_gnn.py),
        # through run and the CLI
        out = t_train.run("gin-tu", steps=3, log_every=0, device="cpu")
        assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
        monkeypatch.setattr(sys, "argv", ["train", "--arch", "gin-tu",
                                          "--steps", "2", "--device", "cpu"])
        t_train.main()
        assert "[train] done: final loss" in capsys.readouterr().out
        # every arch the port has trains (the message lists them)
        with pytest.raises(NotImplementedError,
                           match=", ".join(configs.all_archs())):
            t_train.run("no-such-arch", steps=1, device="cpu")
