"""The GNN family of the PyTorch port against the JAX reference: the
graph generator and the fanout sampler (bit-equal from the same seed),
GIN's forward on the node task (an edge mask and padded edges) and the
graph task, ``gin_train_step`` (loss, gradients, one and three AdamW
updates), the fixed-order aggregation ``core.segment.segment_gather_sum``
(gradcheck, bit-equal across chunk sizes and past one piece, no (E, d)
tensor saved, no atomic op), checkpoints across the two packages and the
launcher's gin-tu branch.  Weights are the reference's ``init_params``,
carried across by ``convert.gnn_params_from_jax``; graphs and batches
are numpy, fed to both.

Tolerances: logits rtol and atol 1e-5; the loss within 1e-6 relative;
gradients within 1e-5 relative plus 1e-5 of each leaf's largest
magnitude (a weight's gradient sums products over every node, which
cancel: the sum aggregation over a skewed graph makes logits of ~1,500
at this init, and fp32 sums in another order than XLA's move a small
element by ~1e-5 of the leaf's scale); updated parameters rtol and atol
1e-5; the
aggregation against float64 within 1e-6 of the sum of its terms'
magnitudes.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.data import graph_sampler as j_gs
from repro.launch import train as j_train
from repro.models import gnn as j_gnn
from repro.train import checkpoint as j_ckpt
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch import configs
from repro_torch.core import segment
from repro_torch.data import graph_sampler as gs
from repro_torch.launch import train as t_train
from repro_torch.models import convert, gnn
from repro_torch.train import checkpoint, optimizer, train_step

TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """[(keystr, numpy)] in jax's order, for either package's tree."""
    return [(jax.tree_util.keystr(p), np.asarray(x))
            for p, x in jax.tree_util.tree_flatten_with_path(
                jax.tree_util.tree_map(
                    lambda t: t.detach().numpy()
                    if isinstance(t, torch.Tensor) else t, tree))[0]]


def _cfgs(**kw):
    return (dataclasses.replace(j_configs.get("gin-tu").smoke, **kw),
            dataclasses.replace(configs.get("gin-tu").smoke, **kw))


def _pair(seed=0, **kw):
    j_cfg, cfg = _cfgs(**kw)
    params = j_gnn.init_params(jax.random.PRNGKey(seed), j_cfg)
    model = gnn.GIN(cfg)
    model.load_state_dict(convert.gnn_params_from_jax(_np_tree(params)))
    return params, j_cfg, model, cfg


def _node_batch(seed=1):
    """A padded block at the reference test's sizes: it has masked and
    padded edges."""
    g = gs.synthetic_graph(seed, n_nodes=500, n_edges=4000, d_feat=8,
                           n_classes=4)
    b = gs.NeighborSampler(g, fanouts=(5, 3), seed=0).padded_batch(
        np.arange(16), max_nodes=256, max_edges=512)
    assert not b["edge_mask"].all()
    return b


def _molecule_batch():
    """8 graphs of 10 nodes and 24 edges, as tests/test_arch_smoke.py."""
    B, n, e = 8, 10, 24
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B * n, 6)).astype(np.float32)
    ei = np.concatenate([rng.integers(0, n, size=(2, e)) + i * n
                         for i in range(B)], axis=1).astype(np.int32)
    return {"x": x, "edge_index": ei,
            "graph_ids": np.repeat(np.arange(B), n).astype(np.int32),
            "labels": rng.integers(0, 2, B).astype(np.int32),
            "edge_mask": np.ones((B * e,), bool),
            "label_mask": np.ones((B,), np.float32)}


def _task(task):
    """(batch, model kwargs of the config) of the node or graph task."""
    if task == "graph":
        return _molecule_batch(), dict(d_feat=6, n_classes=2)
    return _node_batch(), dict(d_feat=8)


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _j_logits(params, j_cfg, jb, task):
    kw = dict(edge_mask=jb["edge_mask"])
    if task == "graph":
        kw.update(graph_ids=jb["graph_ids"], n_graphs=jb["labels"].shape[0])
    return j_gnn.forward(params, j_cfg, jb["x"], jb["edge_index"], **kw)


def _opt_cfg():
    return j_opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=5)


class TestGraphData:
    @pytest.mark.parametrize("seed,n,e,d,c", [(1, 500, 4000, 8, 4),
                                              (0, 200, 1000, 16, 16),
                                              (3, 64, 300, 5, 7)])
    def test_synthetic_graph_is_the_references(self, seed, n, e, d, c):
        got = gs.synthetic_graph(seed, n, e, d, c)
        want = j_gs.synthetic_graph(seed, n, e, d, c)
        assert got.n_nodes == want.n_nodes and got.n_edges == want.n_edges
        for name in ("edge_index", "x", "labels"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name

    def test_sampler_blocks_are_the_references(self):
        g = gs.synthetic_graph(1, n_nodes=500, n_edges=4000, d_feat=8,
                               n_classes=4)
        jg = j_gs.synthetic_graph(1, n_nodes=500, n_edges=4000, d_feat=8,
                                  n_classes=4)
        s = gs.NeighborSampler(g, fanouts=(5, 3), seed=0)
        js = j_gs.NeighborSampler(jg, fanouts=(5, 3), seed=0)
        seeds = [np.arange(16), np.arange(100, 164), np.array([7, 3, 499])]
        for batch_nodes in seeds:                 # the generator advances
            got = s.sample_block(batch_nodes)
            want = js.sample_block(batch_nodes)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k
        for batch_nodes, (mn, me) in zip(seeds, [(256, 512), (64, 128),
                                                 (32, 8)]):
            got = s.padded_batch(batch_nodes, mn, me)
            want = js.padded_batch(batch_nodes, mn, me)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), k


class TestForward:
    @pytest.mark.parametrize("task", ["node", "graph"])
    def test_logits_match_jax(self, task):
        b, kw = _task(task)
        params, j_cfg, model, _ = _pair(**kw)
        want = _j_logits(params, j_cfg, _j(b), task)
        tb = _t(b)
        tkw = dict(edge_mask=tb["edge_mask"])
        if task == "graph":
            tkw.update(graph_ids=tb["graph_ids"], n_graphs=8)
        with torch.no_grad():
            got = model(tb["x"], tb["edge_index"], **tkw)
            # a plan built once gives the same bits
            plan = segment.gather_plan(tb["edge_index"][0],
                                       tb["edge_index"][1], b["x"].shape[0],
                                       tb["edge_mask"])
            again = model(tb["x"], None, plan=plan,
                          **{k: v for k, v in tkw.items() if k != "edge_mask"})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        assert torch.equal(got, again)

    def test_param_count_and_init(self):
        cfg = configs.get("gin-tu").config
        j_cfg = j_configs.get("gin-tu").config
        assert cfg.param_count() == j_cfg.param_count() == 130_261
        model = gnn.init_params(torch.Generator().manual_seed(0), cfg)
        assert sum(p.numel() for p in model.parameters()) == 130_261
        assert model.layers[0].w1.shape == (1433, 64)
        assert float(model.layers[0].w1.detach().std()) == pytest.approx(
            1433 ** -0.5, rel=0.05)
        assert all(float(layer.eps.detach()) == 0 for layer in model.layers)


class TestTrainStep:
    @pytest.mark.parametrize("task", ["node", "graph"])
    def test_one_step_matches_jax(self, task):
        b, kw = _task(task)
        params, j_cfg, model, _ = _pair(**kw)
        jb = _j(b)

        def j_loss_fn(p):
            from repro.train import losses as j_losses
            return j_losses.softmax_xent(_j_logits(p, j_cfg, jb, task),
                                         jb["labels"], jb["label_mask"])
        j_loss, j_grads = jax.value_and_grad(j_loss_fn)(params)
        tb = _t(b)
        loss = train_step.gin_loss(model, tb, task)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
        grads = train_step.param_grads(model, loss)
        got = _leaves(convert.params_to_jax(grads, "gnn"))
        want = _leaves(j_grads)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=TOL,
                                       atol=TOL * np.abs(w).max(),
                                       err_msg=name)

        opt_cfg = _opt_cfg()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        jnew, jm = jax.jit(j_step.gin_train_step(j_cfg, opt_cfg,
                                                 task=task))(jstate, jb)
        state = train_step.make_train_state(model)
        new, tm = train_step.gin_train_step(
            None, optimizer.AdamWConfig(**dataclasses.asdict(opt_cfg)),
            task=task)(state, tb)
        assert new["step"] == int(jnew["step"]) == 1
        assert set(tm) == set(jm) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        for (name, p), (_, w) in zip(
                _leaves(convert.params_to_jax(
                    dict(model.named_parameters()), "gnn")),
                _leaves(jnew["params"])):
            np.testing.assert_allclose(p, w, rtol=TOL, atol=TOL,
                                       err_msg=name)

    def test_three_steps_match_jax(self):
        b, kw = _task("node")
        params, j_cfg, model, _ = _pair(seed=2, **kw)
        opt_cfg = _opt_cfg()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        jfn = jax.jit(j_step.gin_train_step(j_cfg, opt_cfg))
        state = train_step.make_train_state(model)
        fn = train_step.gin_train_step(
            None, optimizer.AdamWConfig(**dataclasses.asdict(opt_cfg)))
        tb, jb = _t(b), _j(b)
        tb["plan"] = segment.gather_plan(tb["edge_index"][0],
                                         tb["edge_index"][1], 256,
                                         tb["edge_mask"])
        for _ in range(3):
            jstate, jm = jfn(jstate, jb)
            state, tm = fn(state, tb)
            np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                       rtol=TOL)
        got = _leaves(train_step.state_tree(state))
        want = _leaves(jstate)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (name, x), (_, y) in zip(got, want):
            if name.startswith("['params']"):
                np.testing.assert_allclose(x, y, rtol=TOL, atol=TOL,
                                           err_msg=name)

    def test_state_tree_names_and_ranks_are_the_references(self):
        params, _, model, _ = _pair()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, _opt_cfg())
        want = [(jax.tree_util.keystr(p), np.shape(x)) for p, x in
                jax.tree_util.tree_flatten_with_path(jstate)[0]]
        tree = train_step.state_tree(train_step.make_train_state(model))
        assert [(n, tuple(x.shape))
                for n, x in checkpoint.tree_flatten(tree)] == want
        ranks = convert.jax_ranks(dict(model.named_parameters()), "gnn")
        assert ranks["layers.0.eps"] == 0 and ranks["layers.1.b2"] == 1
        assert ranks["layers.2.w1"] == 2 and ranks["head.w"] == 2
        back = convert.params_from_jax(
            convert.params_to_jax(dict(model.named_parameters()), "gnn"),
            "gnn")
        assert set(back) == set(model.state_dict())
        for n, p in model.named_parameters():
            assert torch.equal(back[n], p.detach()), n


def _skewed(n=40, e=600, long_dst=3, long_len=300, seed=0):
    """A zipf-skewed edge list (one src holds most out-edges) with one
    dst of ``long_len`` in-edges, and a mask dropping ~10 %."""
    rng = np.random.default_rng(seed)
    w = rng.zipf(1.5, n).astype(np.float64)
    w /= w.sum()
    src = rng.choice(n, e, p=w)
    dst = rng.integers(0, n, e)
    dst[:long_len] = long_dst
    mask = rng.random(e) < 0.9
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask))


class TestSegmentGatherSum:
    def test_gradcheck_float64(self):
        src, dst, mask = _skewed(n=12, e=400, long_len=150)
        plan = segment.gather_plan(src, dst, 12, mask)
        assert plan.fwd.levels and plan.bwd.levels     # two-level sums
        x = torch.randn((12, 3), dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(
            lambda t: segment.segment_gather_sum(t, plan, chunk_edges=5),
            (x,))

    def test_bit_equal_across_chunks_and_past_one_piece(self):
        src, dst, mask = _skewed(n=40, e=3000, long_len=500)
        plan = segment.gather_plan(src, dst, 40, mask)
        big = int(torch.bincount(dst[mask]).max())
        assert big > segment.PIECE_EDGES and plan.fwd.levels and plan.bwd.levels
        torch.manual_seed(0)
        x = torch.randn((40, 16), requires_grad=True)
        g = torch.randn((40, 16))
        outs, grads = [], []
        for chunk in (1, 7, 64, 1000, segment.CHUNK_EDGES):
            out = segment.segment_gather_sum(x, plan, chunk_edges=chunk)
            gx, = torch.autograd.grad(out, x, g)
            outs.append(out.detach())
            grads.append(gx)
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        assert all(torch.equal(grads[0], o) for o in grads[1:])
        # against float64 sums, relative to the terms' magnitudes
        x64, keep = x.detach().double(), mask
        want = torch.zeros((40, 16), dtype=torch.float64).index_add_(
            0, dst[keep], x64[src[keep]])
        mag = torch.zeros_like(want).index_add_(0, dst[keep],
                                                x64[src[keep]].abs())
        assert bool(((outs[0].double() - want).abs() <= 1e-6 * mag).all())
        want_g = torch.zeros_like(want).index_add_(0, src[keep],
                                                   g.double()[dst[keep]])
        mag_g = torch.zeros_like(want).index_add_(
            0, src[keep], g.double()[dst[keep]].abs())
        assert bool(((grads[0].double() - want_g).abs() <= 1e-6 * mag_g
                     ).all())

    def test_matches_jax_segment_sum_and_drops_masked_edges(self):
        src, dst, mask = _skewed(n=30, e=400, long_len=100, seed=1)
        x = np.random.default_rng(2).normal(size=(30, 5)).astype(np.float32)
        msg = jnp.where(jnp.asarray(mask.numpy())[:, None],
                        jnp.asarray(x)[jnp.asarray(src.numpy())], 0.0)
        want = jax.ops.segment_sum(msg, jnp.asarray(dst.numpy()),
                                   num_segments=30)
        got = segment.segment_gather_sum(
            torch.from_numpy(x), segment.gather_plan(src, dst, 30, mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        none = segment.gather_plan(src, dst, 30, torch.zeros_like(mask))
        assert none.fwd.rows.numel() == 0
        assert segment.segment_gather_sum(torch.from_numpy(x),
                                          none).eq(0).all()
        with pytest.raises(ValueError, match="rows"):
            segment.segment_gather_sum(torch.zeros((31, 5)),
                                       segment.gather_plan(src, dst, 30))

    def test_saves_no_edge_sized_tensor(self):
        """GIN's forward saves node-sized floats and the plan's integers
        for the backward: no (E, d) message tensor."""
        n, e = 50, 5000
        src, dst, _ = _skewed(n=n, e=e, long_len=200)
        _, cfg = _cfgs(d_feat=8)
        model = gnn.init_params(torch.Generator().manual_seed(0), cfg)
        x = torch.randn((n, 8))
        plan = segment.gather_plan(src, dst, n)
        saved = []

        def pack(t):
            saved.append(t)
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = model(x, None, plan=plan).square().sum()
        floats = [t for t in saved if t.is_floating_point()]
        ints = [t for t in saved if not t.is_floating_point()]
        assert floats and ints
        assert max(t.numel() for t in floats) <= n * cfg.d_hidden
        assert max(t.shape[0] for t in floats if t.dim()) <= n
        assert max(t.numel() for t in ints) <= e
        loss.backward()
        assert all(p.grad is not None for p in model.parameters())

    def test_no_atomic_op_on_its_path(self):
        src, dst, mask = _skewed(n=30, e=2000, long_len=400)
        plan = segment.gather_plan(src, dst, 30, mask)
        x = torch.randn((30, 4), requires_grad=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            out = segment.segment_gather_sum(x, plan, chunk_edges=300)
            out.backward(torch.randn((30, 4)))
        names = {e.key for e in prof.key_averages()}
        assert "aten::segment_reduce" in names
        assert not {"aten::index_add_", "aten::scatter_add_",
                    "aten::index_put_", "aten::_index_put_impl_",
                    "aten::scatter_reduce_"} & names, names


class TestCheckpoint:
    def test_reference_checkpoint_restores_in_port(self, tmp_path):
        b, kw = _task("node")
        params, j_cfg, model, _ = _pair(seed=1, **kw)
        opt_cfg = _opt_cfg()
        jstate = j_step.make_train_state(jax.random.PRNGKey(0),
                                         lambda k: params, opt_cfg)
        jstate, _ = jax.jit(j_step.gin_train_step(j_cfg, opt_cfg))(jstate,
                                                                   _j(b))
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
        b, kw = _task("node")
        params, _, model, _ = _pair(seed=2, **kw)
        state = train_step.make_train_state(model)
        state, _ = train_step.gin_train_step(
            None, optimizer.AdamWConfig(lr=1e-3, warmup_steps=1,
                                        total_steps=4))(state, _t(b))
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


class TestLauncher:
    def test_five_steps_match_jax(self, monkeypatch):
        params = _np_tree(_pair(seed=0)[0])

        def init(gen, cfg, device=None):
            model = gnn.GIN(cfg)
            model.load_state_dict(convert.gnn_params_from_jax(params))
            return model.to(device)
        monkeypatch.setattr(gnn, "init_params", init)
        monkeypatch.setattr(j_gnn, "init_params", lambda k, cfg: jax.tree_util
                            .tree_map(jnp.asarray, params))
        want = j_train.run("gin-tu", steps=5, log_every=0)
        got = t_train.run("gin-tu", steps=5, log_every=0, device="cpu")
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL)
        assert got["losses"][-1] < got["losses"][0]

    def test_stop_and_resume_is_bit_exact(self, tmp_path):
        kw = dict(steps=8, log_every=0, device="cpu")
        full = t_train.run("gin-tu", **kw)
        ck = str(tmp_path / "c")
        part = t_train.run("gin-tu", ckpt_dir=ck, ckpt_every=2,
                           stop_after=5, **kw)
        rest = t_train.run("gin-tu", ckpt_dir=ck, **kw)
        assert rest["start"] == 5
        assert part["losses"] + rest["losses"] == full["losses"]
        a = checkpoint.tree_flatten(train_step.state_tree(rest["state"]))
        b = checkpoint.tree_flatten(train_step.state_tree(full["state"]))
        assert [n for n, _ in a] == [n for n, _ in b]
        for (n, x), (_, y) in zip(a, b):
            assert torch.equal(x, y), n

    def test_cli_trains_on_the_cpu(self, monkeypatch, capsys, tmp_path):
        monkeypatch.setattr(sys, "argv", [
            "train", "--arch", "gin-tu", "--steps", "3", "--device", "cpu",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
        t_train.main()
        out = capsys.readouterr().out
        assert "[train] step 0 loss" in out and "final loss" in out
        assert checkpoint.list_steps(str(tmp_path))[-1] == 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_steps_from_one_state_are_bit_equal_on_the_card():
    """chip_smoke's determinism gate at a small size: the aggregation adds
    in the plan's order on the card too, so two steps from the same
    state give the same bits."""
    dev = _card()
    _, cfg = _cfgs(d_feat=8)
    g = gs.synthetic_graph(0, n_nodes=5000, n_edges=200_000, d_feat=8,
                           n_classes=4)
    b = {"x": torch.as_tensor(g.x, device=dev),
         "edge_index": torch.as_tensor(g.edge_index, device=dev),
         "labels": torch.as_tensor(g.labels, device=dev)}
    b["plan"] = segment.gather_plan(b["edge_index"][0], b["edge_index"][1],
                                    g.n_nodes)
    fn = train_step.gin_train_step(cfg, optimizer.AdamWConfig(lr=1e-3))
    outs = []
    for _ in range(2):
        model = gnn.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg)
        state, m = fn(train_step.make_train_state(model), b)
        outs.append((m["loss"], [p.detach().clone()
                                 for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(outs[0][1], outs[1][1]))
