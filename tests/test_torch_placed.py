"""The placed LM train step (``repro_torch.sharding.placed``) on a 2 x 4
``("data", "model")`` mesh of CPU positions, against the JAX reference's
one-device step and the port's own one-device steps.

Part 1 is the counterpart of ``tests/test_sharded_exec.py``'s sharded
step: its config (2 layers, d_model 32, 4 heads / 2 KV, d_ff 64, vocab
64, fp32, no remat), AdamW at lr 1e-3 without warm-up over 10 steps, and
(8, 16) tokens drawn with numpy, one row a position.  The weights are
drawn with numpy in the reference's layout and carried across by
``models.convert``.  The
minitron-4b ``train_4k`` cell is built by ``steps.build_cell`` at that
config and at minitron's smoke config, with its FSDP specs or with every
parameter replicated.

Tolerances: the first step's loss within the reference test's 1e-4 of
the JAX package's jitted one-device step and of the port's ``accum=1``
step; the dense placed step bit-equal, over three steps, to the port's
one-device ``accum=8`` step (loss, gradient norm, every parameter and
both moments).  MoE (granite's smoke config, 8 experts top-2, with the
full config's remat, on 2 x 2 positions with rows of 2,048 tokens, so
that each position holds whole dispatch blocks): the
loss, gradient norm and both aux means within 1e-5 relative of the
one-device ``accum=1`` step, the parameters within 1e-7 where the
gradient clears zero by far (``test_torch_steps.py``'s rule), and the
per-position aux means off the global ones by more than that tolerance
(the coupling the placed step keeps).  ``ep_moe`` bit-equal to the
placed baseline: on the CPU each expert's products do not depend on how
many experts a batched product holds.
"""

import contextlib
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as j_tfm
from repro.train import optimizer as j_opt
from repro.train import train_step as j_step
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import convert
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.sharding import (gather, gather_state, place, place_state,
                                  placed_specs, placed_step)
from repro_torch.sharding import placed as placed_lib
from repro_torch.train import checkpoint, optimizer, train_step

MESH = Mesh([torch.device("cpu")] * 8, ("data", "model"), (2, 4))
# the MoE legs' mesh: rows of 2,048 tokens a position make each position
# a full-length attention, so they take 2 x 2 positions (4 rows)
MOE_MESH = Mesh([torch.device("cpu")] * 4, ("data", "model"), (2, 2))
MINITRON, GRANITE = "minitron-4b", "granite-moe-3b-a800m"
B, S, MOE_B, MOE_S = 8, 16, 4, 2048
LOSS_TOL, MOE_RTOL, P_ATOL = 1e-4, 1e-5, 1e-7
OPT = optimizer.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
J_OPT = j_opt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
# tests/test_sharded_exec.py's config, in both packages
REF = tfm.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, vocab=64,
                   param_dtype=torch.float32, compute_dtype=torch.float32,
                   remat=False)
J_REF = j_tfm.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=2, d_ff=64, vocab=64,
                       param_dtype=jnp.float32, compute_dtype=jnp.float32,
                       remat=False)
CONFIGS = {"reference": REF, "smoke": base.get(MINITRON).smoke}
# granite's smoke config with its full config's remat: each block's
# recomputation must see the placed step's MoE hook
MOE_CFG = dataclasses.replace(base.get(GRANITE).smoke, remat=True)


@contextlib.contextmanager
def _entry(arch, cfg, batch, seq):
    """The registry's ``arch`` at ``cfg`` with ``train_4k`` at batch x
    seq while a cell is built."""
    e = base._REGISTRY[arch]
    shape = dataclasses.replace(e.shapes["train_4k"],
                                dims={"seq_len": seq, "global_batch": batch})
    base._REGISTRY[arch] = dataclasses.replace(
        e, config=cfg, shapes={**e.shapes, "train_4k": shape})
    try:
        yield
    finally:
        base._REGISTRY[arch] = e


def _cell(arch, cfg, batch, seq, variant="baseline", mesh=MESH):
    """(the train_4k cell, materialized from seed 0 on the CPU)."""
    with _entry(arch, cfg, batch, seq):
        cell = steps.build_cell(arch, "train_4k", mesh, variant=variant)
    return cell, steps.materialize(cell, "cpu",
                                   torch.Generator().manual_seed(0))


@functools.lru_cache(maxsize=None)
def _reference_weights():
    """(REF's weights as the reference's tree of numpy arrays, drawn with
    numpy from seed 0: embeddings N(0, 0.02), norm gains 1, matrices
    N(0, 1/in); numpy tokens (B, S); the JAX package's jitted one-device
    step's metrics on them)."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(functools.partial(j_tfm.init_params, cfg=J_REF),
                            jax.random.PRNGKey(0))

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if "ln" in name:
            return np.ones(x.shape, np.float32)
        scale = 0.02 if "embed" in name else x.shape[-2] ** -0.5
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)
    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    tokens = rng.integers(0, REF.vocab, (B, S), dtype=np.int32)
    jstate = j_step.make_train_state(
        jax.random.PRNGKey(0),
        lambda k: jax.tree_util.tree_map(jnp.asarray, tree), J_OPT)
    _, jm = jax.jit(j_step.lm_train_step(J_REF, J_OPT))(
        jstate, {"tokens": jnp.asarray(tokens)})
    return tree, tokens, float(jm["loss"])


def _dense(config, posture, variant="baseline"):
    """(cell, one-device state, batch, placed state, placed batch) of
    the minitron train cell at ``config``; the reference config carries
    the reference's weights and numpy tokens."""
    cell, real = _cell(MINITRON, CONFIGS[config], B, S, variant)
    state, batch = real.args
    if config == "reference":
        tree, tokens, _ = _reference_weights()
        state["params"].load_state_dict(convert.lm_params_from_jax(tree))
        batch = {"tokens": torch.from_numpy(tokens.copy())}
    sspec, bspec = placed_specs(cell)
    if posture == "replicated":
        sspec = steps._replicated(sspec)
    return (cell, state, batch, place_state(state, sspec, MESH),
            place(batch, bspec, MESH))


def _params(state):
    return dict(state["params"].named_parameters())


def _assert_states_equal(state, other):
    got, want = _params(state), _params(other)
    assert list(got) == list(want)
    for n in want:
        assert torch.equal(got[n], want[n]), n
        assert torch.equal(state["opt"].m[n], other["opt"].m[n]), n
        assert torch.equal(state["opt"].v[n], other["opt"].v[n]), n
    assert torch.equal(state["opt"].step, other["opt"].step)
    assert state["step"] == other["step"]


# ------------------------------ placing ------------------------------------

class TestPlace:
    def test_blocks_follow_named_sharding(self):
        """Position (d, m) holds block 4d + m of a dimension over
        ("data", "model"), a copy where the spec replicates, and a dict
        tree and a lone tensor round-trip."""
        x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        y = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        tree = {"x": x, "opt": {"m": y, "step": torch.tensor(3)}}
        specs = {"x": (("data", "model"), None),
                 "opt": {"m": (None, "model"), "step": ()}}
        placed = place(tree, specs, MESH)
        px, py = placed["x"], placed["opt"]["m"]
        for i, (d, m) in enumerate(np.ndindex(2, 4)):
            assert torch.equal(px.pieces[i], x[4 * d + m][None])
            assert torch.equal(py.pieces[i], y[:, m:m + 1])
            assert py.pieces[i] is py.pieces[4 + m if d == 0 else m]
        back = gather(placed)
        assert torch.equal(back["x"], x) and torch.equal(back["opt"]["m"], y)
        assert torch.equal(back["opt"]["step"], torch.tensor(3))
        assert px.pieces[0].data_ptr() != x.data_ptr()
        assert torch.equal(gather(place(y, (None, "model"), MESH)), y)

    @pytest.mark.parametrize("config", list(CONFIGS))
    def test_fsdp_pieces_and_round_trip(self, config):
        """Each piece has the shape its spec gives (the FSDP specs of
        ``lm_param_specs_fsdp`` mapped through the port's layout), and
        ``gather_state`` of the placed state equals the state."""
        cell, state, _, placed, _ = _dense(config, "fsdp")
        spec_tree = cell.in_specs[0]["params"]
        split = 0
        for n, p in placed["params"].items():
            path, layer, transposed = convert.jax_place(n, "lm")
            ref = spec_tree
            for k in path:
                ref = ref[k]
            ref = tuple(ref)[1:] if layer is not None else tuple(ref)
            ref = ref[::-1] if transposed else ref
            want = tuple(size // (1 if a is None else 4 if a == "model"
                                  else 2 if a == "data" else 8)
                         for size, a in zip(p.shape, ref))
            assert all(tuple(x.shape) == want for x in p.pieces), n
            split += want != p.shape
            for i, j in ((0, 4), (1, 5)):
                assert (p.pieces[i] is p.pieces[j]) == (p.blocks[i]
                                                        == p.blocks[j]), n
        assert split == len(placed["params"])
        _assert_states_equal(gather_state(placed, "cpu"), state)

    def test_non_dividing_spec_raises(self):
        with pytest.raises(ValueError, match=r"w.*\(6, 4\).*'model'"):
            place({"w": torch.zeros(6, 4)}, {"w": ("model", None)}, MESH)

    def test_axis_the_mesh_lacks_raises(self):
        """The two-pod cell's batch spec names ``pod``, which the 2 x 4
        mesh lacks; nothing falls back to one device."""
        with _entry(MINITRON, REF, B, S):
            cell = steps.build_cell(MINITRON, "train_4k", MESH,
                                    multi_pod=True)
        with pytest.raises(ValueError, match=r"\['pod'\]"):
            place({"tokens": torch.zeros(B, S, dtype=torch.int32)},
                  cell.in_specs[1], MESH)

    def test_layer_axis_split_raises(self):
        cell, real = _cell(MINITRON, REF, B, S)
        specs = cell.in_specs[0]
        layers = dict(specs["params"]["layers"]) | {"ln1": ("data", None)}
        specs = specs | {"params": specs["params"] | {"layers": layers}}
        with pytest.raises(ValueError, match="layer axis"):
            place_state(real.args[0], specs, MESH)


# ------------------------------ dense step ---------------------------------

class TestDenseStep:
    @pytest.mark.parametrize("posture", ["replicated", "fsdp"])
    def test_loss_within_jax_one_device_step(self, posture):
        """The reference test's check: the placed loss within 1e-4 of the
        JAX package's jitted one-device step, and of the port's accum=1
        step."""
        j_loss = _reference_weights()[2]
        cell, state, batch, placed, pbatch = _dense("reference", posture)
        _, m = placed_step(cell, opt_cfg=OPT)(placed, pbatch)
        _, m1 = train_step.lm_train_step(REF, OPT)(state, batch)
        assert abs(float(m["loss"]) - j_loss) < LOSS_TOL
        assert abs(float(m["loss"]) - float(m1["loss"])) < LOSS_TOL
        assert set(m) >= {"loss", "grad_norm", "lr"}

    @pytest.mark.parametrize("config,posture,variant", [
        ("reference", "replicated", "baseline"),
        ("reference", "fsdp", "baseline"),
        ("smoke", "replicated", "baseline"),
        ("smoke", "fsdp", "baseline"),
        ("smoke", "fsdp", "rs_grads"),
        ("smoke", "fsdp", "attn_remat")])
    def test_bit_equal_to_accum_over_three_steps(self, config, posture,
                                                 variant):
        cell, state, batch, placed, pbatch = _dense(config, posture,
                                                    variant)
        step = placed_step(cell, opt_cfg=OPT)
        one = train_step.lm_train_step(state["params"].cfg, OPT, accum=B)
        for _ in range(3):
            placed, m = step(placed, pbatch)
            state, m1 = one(state, batch)
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(m[k], m1[k]), k
        _assert_states_equal(gather_state(placed, "cpu"), state)

    def test_rs_grads_equals_baseline(self):
        legs = []
        for variant in ("baseline", "rs_grads"):
            cell, _, _, placed, pbatch = _dense("smoke", "fsdp", variant)
            placed, m = placed_step(cell, opt_cfg=OPT)(placed, pbatch)
            legs.append((gather_state(placed, "cpu"), m))
        _assert_states_equal(legs[0][0], legs[1][0])
        assert torch.equal(legs[0][1]["loss"], legs[1][1]["loss"])

    def test_no_mesh_raises(self):
        with _entry(MINITRON, REF, B, S):
            cell = steps.build_cell(MINITRON, "train_4k", None)
        with pytest.raises(ValueError, match="no mesh"):
            placed_step(cell)

    def test_other_cells_raise(self):
        with _entry(MINITRON, REF, B, S):
            cell = steps.build_cell(MINITRON, "prefill_32k", MESH)
        with pytest.raises(ValueError, match="not a train cell"):
            placed_step(cell)

    def test_checkpoint_round_trip(self, tmp_path):
        """A placed state gathered, written by ``train/checkpoint.py``
        through ``train_step.state_tree``, restored and placed again
        equals the state it was written from, and steps on bit-equal."""
        cell, _, _, placed, pbatch = _dense("reference", "fsdp")
        step = placed_step(cell, opt_cfg=OPT)
        placed, _ = step(placed, pbatch)
        tree = train_step.state_tree(gather_state(placed, "cpu"))
        checkpoint.save(str(tmp_path), 1, tree)
        got, restored = checkpoint.restore_latest(str(tmp_path), tree)
        assert got == 1
        back = train_step.load_state_tree(gather_state(placed, "cpu"),
                                          restored)
        again = place_state(back, cell.in_specs[0], MESH)
        _assert_states_equal(gather_state(again, "cpu"),
                             gather_state(placed, "cpu"))
        a, ma = step(placed, pbatch)
        b, mb = step(again, pbatch)
        assert torch.equal(ma["loss"], mb["loss"])
        _assert_states_equal(gather_state(a, "cpu"), gather_state(b, "cpu"))


# ------------------------------ MoE ----------------------------------------

@contextlib.contextmanager
def _coupled_calls():
    """Counts of the placed step's MoE ``ce`` calls that take the expert
    counts summed over the positions, in a forward and in a backward
    (remat's recomputation)."""
    calls = {"forward": 0, "backward": 0}
    ce = placed_lib._Coupling.ce

    def counting(hook, layer, counts, slots):
        if not hook.record:
            calls["forward" if torch._C._current_graph_task_id() == -1
                  else "backward"] += 1
        return ce(hook, layer, counts, slots)
    placed_lib._Coupling.ce = counting
    try:
        yield calls
    finally:
        placed_lib._Coupling.ce = ce


@pytest.fixture(scope="module")
def moe():
    """``MOE_CFG`` at 4 x 2,048 tokens on ``MOE_MESH`` (a
    position's row is one dispatch block): the one-device accum=1 step
    (its aux means recorded from its forward), the placed baseline and
    ``ep_moe`` steps from the same state, and the per-row aux means
    before the step."""
    cfg = MOE_CFG
    cell, real = _cell(GRANITE, cfg, MOE_B, MOE_S, mesh=MOE_MESH)
    ep_cell, _ = _cell(GRANITE, cfg, MOE_B, MOE_S, "ep_moe", MOE_MESH)
    state, batch = real.args
    placed = {c.variant: (c, place_state(state, placed_specs(c)[0],
                                         MOE_MESH)) for c in (cell, ep_cell)}
    pbatch = place(batch, cell.in_specs[1], MOE_MESH)
    model = state["params"]
    with torch.no_grad():
        rows = [train_step.lm_loss_fn(model, r[None])[2]
                for r in batch["tokens"]]
    local = {k: sum(float(a[k]) for a in rows) / MOE_B for k in rows[0]}
    out, calls = {}, {}
    for variant, (c, ps) in placed.items():
        with _coupled_calls() as calls[variant]:
            out[variant] = placed_step(c, opt_cfg=OPT)(ps, pbatch)
    layers = []
    hooks = [layer.moe.register_forward_hook(
        lambda mod, inp, out: layers.append(out[1])) for layer in model.layers]
    state, m1 = train_step.lm_train_step(cfg, OPT)(state, batch)
    for h in hooks:
        h.remove()
    aux = {k: float(torch.stack([a[k].detach() for a in layers]).mean())
           for k in layers[0]}
    return {"state": state, "m1": m1, "aux": aux, "local": local,
            "placed": out, "ep_state": placed["ep_moe"][1], "calls": calls}


class TestMoE:
    def test_within_accum1(self, moe):
        _, m = moe["placed"]["baseline"]
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(moe["m1"][k]),
                                       rtol=MOE_RTOL, err_msg=k)
        for k in ("load_balance", "router_z"):
            np.testing.assert_allclose(float(m[k]), moe["aux"][k],
                                       rtol=MOE_RTOL, err_msg=k)
        got = _params(gather_state(moe["placed"]["baseline"][0], "cpu"))
        for n, want in _params(moe["state"]).items():
            # the clipped gradient, from the first moment after one step
            g = moe["state"]["opt"].m[n].abs() / (1 - OPT.b1)
            hold = (g > 100 * (1e-6 + 1e-4 * g)) | (g == 0)
            assert hold.any(), n
            np.testing.assert_allclose(got[n].detach()[hold].numpy(),
                                       want.detach()[hold].numpy(),
                                       atol=P_ATOL, rtol=0, err_msg=n)

    def test_coupling_is_real(self, moe):
        """Aux losses taken a position at a time (each with its own
        expert counts) are another loss, off by more than the
        tolerance."""
        lb = moe["aux"]["load_balance"]
        assert abs(moe["local"]["load_balance"] - lb) > MOE_RTOL * lb

    def test_backward_takes_the_summed_counts(self, moe):
        """Every layer's ``ce``, in the forward and in remat's
        recomputation in the backward, comes from the counts summed over
        the positions: one call a layer and position in each."""
        n = MOE_CFG.n_layers * MOE_MESH.devices.size
        for variant, calls in moe["calls"].items():
            assert calls == {"forward": n, "backward": n}, variant

    def test_recomputation_on_another_thread_keeps_the_hook(self):
        """The backward, and so a remat block's recomputation, may run on
        another thread (autograd's device thread on the card): it must
        still route through the hook the forward ran under."""
        class Counting(moe_lib.Local):
            calls = 0

            def ce(self, layer, counts, slots):
                self.calls += 1
                return super().ce(layer, counts, slots)

        model = tfm.init_params(torch.Generator().manual_seed(0), MOE_CFG,
                                "cpu")
        tokens = torch.randint(0, MOE_CFG.vocab, (1, 16),
                               generator=torch.Generator().manual_seed(1))
        hook = Counting()
        with moe_lib.coupled(hook):
            total = train_step.lm_loss_fn(model, tokens)[0]
        assert hook.calls == MOE_CFG.n_layers
        t = threading.Thread(target=train_step.param_grads,
                             args=(model, total))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert hook.calls == 2 * MOE_CFG.n_layers

    def test_misaligned_blocks_raise(self):
        """Rows of 16 tokens: the batch's 128 tokens take one block, which
        no position holds whole."""
        cell, real = _cell(GRANITE, base.get(GRANITE).smoke, B, S)
        state, batch = real.args
        step = placed_step(cell, opt_cfg=OPT)
        with pytest.raises(ValueError, match="whole blocks of 2048"):
            step(place_state(state, cell.in_specs[0], MESH),
                 place(batch, cell.in_specs[1], MESH))

    def test_ep_moe_bit_equal_to_placed_baseline(self, moe):
        (base_state, bm), (ep_state, em) = (moe["placed"]["baseline"],
                                            moe["placed"]["ep_moe"])
        for k in bm:
            assert torch.equal(bm[k], em[k]), k
        _assert_states_equal(gather_state(ep_state, "cpu"),
                             gather_state(base_state, "cpu"))

    def test_ep_moe_experts_stay_with_their_owners(self, moe):
        """Each position holds the 4 of 8 experts of its ``model`` index,
        the same piece as the other ``data`` row's position on its
        device, and the step updated those pieces in place."""
        ep_state = moe["ep_state"]
        for n, p in ep_state["params"].items():
            if n.split(".")[-1] not in ("w_gate", "w_up", "w_down"):
                continue
            assert p.spec == (("model",), (), ()), n
            for i, (d, m) in enumerate(np.ndindex(2, 2)):
                assert p.pieces[i].shape[0] == 4 and p.blocks[i][0] == m
                assert p.pieces[i] is p.pieces[(1 - d) * 2 + m]
        assert ep_state["step"] == 0
        assert moe["placed"]["ep_moe"][0]["params"] is ep_state["params"]

    def test_ep_moe_needs_the_expert_split(self):
        """The ep_moe cell's own specs keep the FSDP posture for the
        experts; its step raises on a state placed by them."""
        cell, real = _cell(GRANITE, MOE_CFG, MOE_B, MOE_S, "ep_moe",
                           MOE_MESH)
        state, batch = real.args
        with pytest.raises(ValueError, match="expert-parallel"):
            placed_step(cell, opt_cfg=OPT)(
                place_state(state, cell.in_specs[0], MOE_MESH),
                place(batch, cell.in_specs[1], MOE_MESH))
