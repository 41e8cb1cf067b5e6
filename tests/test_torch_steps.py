"""The cell builders of the PyTorch port against the JAX reference: the
LM, GNN and recsys rule sets, ``make_production_mesh``, every cell of
``ASSIGNED + ["colbert"]`` on the 16 x 16 mesh (kind, skip, the leaves'
shapes, dtypes and specs, model FLOPs, donation), one arch a family and
the variants on the 2 x 16 x 16 mesh, the cells of each family run at
its smoke config in both packages on the same inputs, and
``count_params`` / ``cast_tree``.

The port's cells are built on ``meta`` positions; the reference's on a
mesh of its one CPU device repeated, as ``tests/test_sharded_exec.py``
builds them.  Execution: ``smoke_entries`` swaps each family's registry
entry (in both packages; restored after) for its smoke config with tiny
dims under the reference's shape ids, which the GNN and ColBERT cells
key on, and each cell's materialized arguments are fed to the
reference's cell through ``cell_tree``.  Tolerances are those of the
existing parity tests of the same functions: LM logits 1e-5
(``test_torch_lm``), a train step's loss 1e-6 relative and parameters
1e-7 (``test_torch_lm_train``), CTR probabilities rtol 1e-5 atol 1e-6
(``test_torch_recsys``), the GIN loss 1e-6 relative (``test_torch_gnn``),
encodings and rerank scores 1e-5 (``test_torch_models``), pruning ranks
exact and errors 1e-5 on random unit documents (``test_torch_voronoi``).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro import configs as j_configs
from repro import sharding as j_sh
from repro.configs import base as j_base
from repro.launch import mesh as j_mesh
from repro.launch import steps as j_steps
from repro.models import common as j_common
from repro.models import transformer as j_tfm
from repro.train import losses as j_losses
from repro.train import optimizer as j_opt
from repro_torch import configs, sharding
from repro_torch.configs import base
from repro_torch.launch import mesh, steps
from repro_torch.models import common, convert
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer

ARCHS = configs.ASSIGNED + ["colbert"]
RULE_SETS = ["lm_train_rules", "lm_prefill_rules", "gnn_rules",
             "recsys_rules", "recsys_rules_rowsharded"]


# ------------------------------ helpers -----------------------------------

def _ref_mesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.array(jax.devices() * n)[:n].reshape(shape),
                             axes)


def _port_mesh(multi_pod):
    return mesh.make_production_mesh(multi_pod=multi_pod,
                                     devices=[torch.device("meta")])


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _ref_leaves(cell):
    """{path: (shape, dtype, spec)} of a reference cell's args."""
    flat, _ = jax.tree_util.tree_flatten_with_path(cell.args)
    specs = jax.tree_util.tree_leaves(
        cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(flat) == len(specs)
    return {tuple(_key(k) for k in p): (tuple(x.shape), jnp.dtype(x.dtype).name,
                                        tuple(s.spec))
            for (p, x), s in zip(flat, specs)}


def _port_leaves(cell):
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""), tuple(s))
            for p, t, s in steps.leaves(cell)}


def _assert_cells_equal(got, want):
    assert got.kind == want.kind and got.skip == want.skip
    if want.skip:
        return
    assert got.donate == want.donate
    np.testing.assert_allclose(got.model_flops_per_step,
                               want.model_flops_per_step, rtol=1e-12)
    g, w = _port_leaves(got), _ref_leaves(want)
    assert sorted(g, key=repr) == sorted(w, key=repr)
    for p in w:
        assert g[p] == w[p], (got.arch_id, got.shape_id, p, g[p], w[p])


@pytest.fixture(scope="module")
def ref_cells():
    m = _ref_mesh(False)
    return {(a, s): j_steps.build_cell(a, s, m)
            for a in ARCHS for s in j_configs.get(a).shapes}


# ------------------------------ rules and mesh -----------------------------

class TestRulesAndMesh:
    @pytest.mark.parametrize("multi_pod", [False, True])
    @pytest.mark.parametrize("name", RULE_SETS)
    def test_rule_set_equals_reference(self, name, multi_pod):
        got = getattr(sharding, name)(multi_pod)
        assert type(got) is dict
        assert got == getattr(j_sh, name)(multi_pod)

    @pytest.mark.parametrize("multi_pod", [False, True])
    @pytest.mark.parametrize("batch", [0, 1, 128])
    def test_decode_and_ep_rules_equal_reference(self, multi_pod, batch):
        got = sharding.lm_decode_rules(multi_pod, batch=batch)
        assert got == j_sh.lm_decode_rules(multi_pod, batch=batch)
        assert sharding.lm_rules_ep_moe(got) == j_sh.lm_rules_ep_moe(got)

    @pytest.mark.parametrize("multi_pod", [False, True])
    def test_production_mesh_shape_and_axes(self, multi_pod, monkeypatch):
        monkeypatch.setattr(jax, "make_mesh",
                            lambda shape, axes: (tuple(shape), tuple(axes)))
        shape, axes = j_mesh.make_production_mesh(multi_pod=multi_pod)
        m = _port_mesh(multi_pod)
        assert m.axis_names == axes and m.devices.shape == shape
        assert m.shape == dict(zip(axes, shape)) and m.distinct() == 1
        two = mesh.make_production_mesh(
            multi_pod=multi_pod, devices=[torch.device("cpu")] * 2)
        assert two.devices.size == int(np.prod(shape)) and two.distinct() == 1


# ------------------------------ cell parity --------------------------------

class TestCellParity:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_every_shape_on_16x16(self, arch, ref_cells):
        m = _port_mesh(False)
        for shape in configs.get(arch).shapes:
            got = steps.build_cell(arch, shape, m)
            assert got.mesh == m
            _assert_cells_equal(got, ref_cells[(arch, shape)])
            if not got.skip:
                assert got.out_specs is None or len(got.out_specs) == 2

    @pytest.mark.parametrize("arch", ["minitron-4b", "gin-tu", "dlrm-rm2",
                                      "bert4rec", "colbert"])
    def test_one_arch_a_family_on_2x16x16(self, arch):
        rm, pm = _ref_mesh(True), _port_mesh(True)
        for shape in configs.get(arch).shapes:
            _assert_cells_equal(
                steps.build_cell(arch, shape, pm, multi_pod=True),
                j_steps.build_cell(arch, shape, rm, multi_pod=True))

    @pytest.mark.parametrize("arch,variant,shapes", [
        ("granite-moe-3b-a800m", "ep_moe", ("train_4k", "prefill_32k",
                                            "decode_32k")),
        ("mixtral-8x7b", "ep_moe", ("prefill_32k", "long_500k")),
        ("dlrm-rm2", "zero_tables", ("train_batch", "serve_p99")),
        ("dlrm-rm2", "a2a_lookup", ("train_batch", "serve_p99", "serve_bulk",
                                    "retrieval_cand")),
        ("wide-deep", "a2a_zero", ("train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand")),
        ("minitron-4b", "attn_remat", ("train_4k", "prefill_32k")),
        ("stablelm-3b", "rs_grads", ("train_4k",)),
        ("colbert", "shortlist_topk", ("prune_index",)),
    ])
    @pytest.mark.parametrize("multi_pod", [False, True])
    def test_variants(self, arch, variant, shapes, multi_pod):
        rm, pm = _ref_mesh(multi_pod), _port_mesh(multi_pod)
        for shape in shapes:
            got = steps.build_cell(arch, shape, pm, multi_pod=multi_pod,
                                   variant=variant)
            _assert_cells_equal(got, j_steps.build_cell(
                arch, shape, rm, multi_pod=multi_pod, variant=variant))
            assert got.grads_pinned == (variant in ("rs_grads",
                                                    "zero_tables", "a2a_zero")
                                        and got.kind == "train")

    @pytest.mark.parametrize("variant", ["a2a_lookup", "a2a_zero"])
    def test_a2a_variants_raise_naming_item_7a(self, variant):
        """The a2a variants of every CTR shape equal the reference's
        cells, their rules too (the mesh aside): the lookup routed to
        the exchange, over every axis for ``a2a_zero``."""
        rm, pm = _ref_mesh(False), _port_mesh(False)
        for arch in ("dcn-v2", "wide-deep"):
            for shape in configs.get(arch).shapes:
                got = steps.build_cell(arch, shape, pm, variant=variant)
                want = j_steps.build_cell(arch, shape, rm, variant=variant)
                _assert_cells_equal(got, want)
                assert got.rules["__mesh__"] is pm
                assert ({k: v for k, v in got.rules.items()
                         if k != "__mesh__"}
                        == {k: v for k, v in want.rules.items()
                            if k != "__mesh__"})

    def test_meta_cells_allocate_nothing(self):
        cell = steps.build_cell("qwen2.5-32b", "train_4k", _port_mesh(False))
        assert all(t.device.type == "meta" for p, t, _ in steps.leaves(cell)
                   if p[1:] not in (("step",), ("opt", "step")))
        assert cell.remat and cell.compute_dtype == torch.bfloat16

    def test_materialize_raises_without_a_gpu(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present")
        cell = steps.build_cell("dlrm-rm2", "serve_p99", _port_mesh(False))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            steps.materialize(cell)


# ------------------------------ execution at SMOKE --------------------------

def _smoke_shapes(entry):
    lm = {"seq_len": 16, "global_batch": 2}
    by = {
        "lm": {s: lm for s in ("train_4k", "prefill_32k", "decode_32k")},
        "gnn": {"molecule": {"n_nodes": 6, "n_edges": 10, "batch": 4}},
        "recsys": {"serve_p99": {"batch": 8}, "train_batch": {"batch": 64}},
        "retrieval": {
            "encode_corpus": {"batch": 4, "doc_len": 24},
            "prune_index": {"docs_per_block": 6, "doc_len": 20,
                            "n_samples": 512, "out_dim": 16},
            "rerank": {"n_queries": 2, "n_candidates": 3, "query_len": 8,
                       "doc_len": 12}},
    }[entry.family]
    return {s: dataclasses.replace(entry.shapes[s], dims=d)
            for s, d in by.items()}


SMOKE_ARCHS = ("minitron-4b", "gin-tu", "dlrm-rm2", "colbert")


@contextlib.contextmanager
def smoke_registry():
    """Each family's entry, in both packages, swapped for its smoke
    config with the tiny shapes of :func:`_smoke_shapes`."""
    saved = []
    for reg in (base._REGISTRY, j_base._REGISTRY):
        for a in SMOKE_ARCHS:
            e = reg[a]
            saved.append((reg, a, e))
            reg[a] = dataclasses.replace(e, config=e.smoke,
                                         shapes=_smoke_shapes(e))
    try:
        yield
    finally:
        for reg, a, e in saved:
            reg[a] = e


@pytest.fixture
def smoke_entries():
    with smoke_registry():
        yield


def _np(t):
    """A JAX copy of ``t``: the port's steps update their arguments in
    place, so the reference must not alias their storage."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return jnp.array(t.float().numpy(), dtype=jnp.bfloat16)
    return jnp.array(t.numpy(), copy=True)


def _to_ref(cell, ref_cell):
    """The port cell's materialized arguments as the reference's args
    (its tree structure, ``None`` leaves included)."""
    got = {p: t for p, t, _ in steps.leaves(cell)}
    flat, treedef = jax.tree_util.tree_flatten_with_path(ref_cell.args)
    return jax.tree_util.tree_unflatten(
        treedef, [_np(got[tuple(_key(k) for k in p)]) for p, _ in flat])


def _cells(arch, shape, **kw):
    """(the port's cell materialized on the CPU, the reference's cell,
    the reference's args from the port's)."""
    cell = steps.materialize(
        steps.build_cell(arch, shape, _port_mesh(False), **kw), "cpu",
        torch.Generator().manual_seed(0))
    ref = j_steps.build_cell(arch, shape, _ref_mesh(False), **kw)
    return cell, ref, _to_ref(cell, ref)


@pytest.mark.usefixtures("smoke_entries")
class TestSmokeExecution:
    def test_lm_prefill(self):
        cell, ref, jargs = _cells("minitron-4b", "prefill_32k")
        want = jax.jit(ref.fn)(*jargs)
        got = cell.fn(*cell.args)
        assert got.shape == (2, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)

    def test_lm_decode(self):
        cell, ref, jargs = _cells("minitron-4b", "decode_32k")
        assert cell.args[3] == 15
        w_logits, w_cache = jax.jit(ref.fn)(*jargs)
        logits, cache = cell.fn(*cell.args)
        np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                                   atol=1e-5, rtol=0)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n].numpy(),
                                       np.asarray(w_cache[n]), atol=1e-5)

    def test_lm_train_step(self):
        """Parameters are held where the reference's gradient clears
        zero by far (or is zero), as ``test_torch_lm_train`` holds them:
        AdamW's first update is ~lr x sign(g), so an element whose
        gradient sits at rounding level may move either way."""
        cell, ref, jargs = _cells("minitron-4b", "train_4k")
        cfg = j_configs.get("minitron-4b").config

        def total(p, t):
            logits, aux = j_tfm.forward(p, t, cfg)
            return (j_losses.lm_loss(logits, t)
                    + 0.01 * (aux["load_balance"] + aux["router_z"]))
        j_g = jax.jit(jax.grad(total))(jargs[0]["params"],
                                       jargs[1]["tokens"])
        w_state, w_m = jax.jit(ref.fn)(*jargs)
        state, m = cell.fn(*cell.args)
        np.testing.assert_allclose(float(m["loss"]), float(w_m["loss"]),
                                   rtol=1e-6)
        assert state["step"] == int(w_state["step"]) == 1
        got = {p[2:]: t for p, t, _ in steps.leaves(
            dataclasses.replace(cell, args=(state, cell.args[1])))
            if p[:2] == (0, "params")}
        grads = {tuple(_key(k) for k in p): np.abs(np.asarray(g))
                 for p, g in jax.tree_util.tree_flatten_with_path(j_g)[0]}
        for p, w in jax.tree_util.tree_flatten_with_path(
                w_state["params"])[0]:
            p = tuple(_key(k) for k in p)
            g = grads[p]
            hold = (g > 100 * (1e-6 + 1e-4 * g)) | (g == 0)
            assert hold.any(), p
            np.testing.assert_allclose(got[p].detach().numpy()[hold],
                                       np.asarray(w)[hold], atol=1e-7,
                                       rtol=0, err_msg=str(p))

    def test_ctr_serve(self):
        cell, ref, jargs = _cells("dlrm-rm2", "serve_p99")
        want = np.asarray(jax.jit(ref.fn)(*jargs))
        got = cell.fn(*cell.args).numpy()
        assert got.shape == (8,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_gnn_train_loss(self):
        cell, ref, jargs = _cells("gin-tu", "molecule")
        batch = cell.args[1]
        assert batch["edge_index"].shape == (2, 512)
        assert int(batch["edge_mask"].sum()) == 40
        _, w_m = jax.jit(ref.fn)(*jargs)
        _, m = cell.fn(*cell.args)
        np.testing.assert_allclose(float(m["loss"]), float(w_m["loss"]),
                                   rtol=1e-6)

    def test_colbert_encode(self):
        cell, ref, jargs = _cells("colbert", "encode_corpus")
        w_emb, w_mask = jax.jit(ref.fn)(*jargs)
        emb, mask = cell.fn(*cell.args)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(w_mask))
        np.testing.assert_allclose(emb.numpy(), np.asarray(w_emb), atol=1e-5)

    @pytest.mark.parametrize("variant", ["baseline", "shortlist_topk"])
    def test_colbert_prune_index_ranks(self, variant):
        cell, ref, _ = _cells("colbert", "prune_index", variant=variant)
        rng = np.random.default_rng(0)

        def unit(*shape):
            x = rng.normal(size=shape).astype(np.float32)
            return x / np.linalg.norm(x, axis=-1, keepdims=True)
        e, s = unit(6, 20, 16), unit(512, 16)
        mask = np.arange(20)[None, :] < rng.integers(5, 21, size=6)[:, None]
        want = jax.jit(ref.fn)(jnp.asarray(e), jnp.asarray(mask),
                               jnp.asarray(s))
        got = cell.fn(torch.tensor(e), torch.tensor(mask), torch.tensor(s))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        fin = np.isfinite(np.asarray(want[1]))
        np.testing.assert_array_equal(np.isfinite(got[1].numpy()), fin)
        np.testing.assert_allclose(got[1].numpy()[fin],
                                   np.asarray(want[1])[fin], atol=1e-5)

    def test_colbert_rerank(self):
        cell, ref, jargs = _cells("colbert", "rerank")
        want = np.asarray(jax.jit(ref.fn)(*jargs))
        got = cell.fn(*cell.args).numpy()
        assert got.shape == (2, 3)
        np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------ count_params / cast_tree --------------------

@functools.lru_cache(maxsize=None)
def _j_smoke_lm():
    cfg = j_configs.get("stablelm-3b").smoke
    return cfg, jax.jit(lambda k: j_tfm.init_params(k, cfg))(
        jax.random.PRNGKey(0))


def test_count_params_matches_reference():
    cfg, params = _j_smoke_lm()
    with torch.device("meta"):
        model = tfm.Transformer(configs.get("stablelm-3b").smoke)
    model = model.to_empty(device="cpu")
    model.load_state_dict(convert.lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    want = j_common.count_params(params)
    assert common.count_params(model) == want
    tree = {"p": convert.params_to_jax(dict(model.named_parameters()), "lm"),
            "opt": optimizer.AdamWState(torch.zeros((), dtype=torch.int32),
                                        {}, {})}
    assert common.count_params(tree) == want + 1
    assert want == j_common.count_params(
        {"p": params, "opt": j_opt.AdamWState(jnp.zeros((), jnp.int32),
                                              {}, {})}) - 1


def test_cast_tree_matches_reference():
    cfg, params = _j_smoke_lm()
    sd = convert.lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params))
    tree = {"p": convert.params_to_jax(sd, "lm"),
            "ids": torch.arange(4, dtype=torch.int32)}
    got = common.cast_tree(tree, torch.bfloat16)
    want = j_common.cast_tree({"p": params, "ids": jnp.arange(4, dtype=jnp.int32)},
                              jnp.bfloat16)
    assert got["ids"].dtype == torch.int32 and tree["p"]["embed"].dtype == \
        torch.float32
    for p, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in p:
            node = node[_key(k)]
        assert str(node.dtype).replace("torch.", "") == jnp.dtype(w.dtype).name
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(w, dtype=np.float32))
    with torch.device("meta"):
        model = tfm.Transformer(configs.get("stablelm-3b").smoke)
    cast = common.cast_tree(model, torch.bfloat16)
    assert cast is not model and model.embed.weight.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in cast.parameters())
