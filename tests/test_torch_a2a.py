"""The port's all-to-all lookup (``repro_torch.models.recsys.
alltoall_lookup``) against the JAX reference's.

The reference's ``alltoall_lookup`` is a ``shard_map`` over a mesh, so
it runs once, in one subprocess with eight forced host devices (as
``tests/test_sharded_exec.py`` runs it), on every case of this file:
the module-scoped ``ref`` fixture writes the inputs (seeded numpy) to a
file, the child reads them and writes its outputs and gradients back.
The port runs the same cases on meshes of repeated CPU positions.

Held: where nothing is dropped, the port's rows bit-equal to the
reference's plain ``jnp.take`` lookup and its gradient bit-equal to the
port's per-feature ``take_rows`` gather and within 1e-5 of the
reference's ``jax.grad`` through its exchange (its psum over ``data``
adds in another order); at a capacity factor that forces drops, the
same requests zeroed as the reference's and every other row equal to
it, except the one request the reference's bucket scatter overwrites
(ROADMAP § C); the gradient of the kept requests only; ids outside [0,
V) raise, where the reference reads some row; a mesh whose positions name two devices; the ``fused`` path;
and the a2a cells' train step at SMOKE bit-equal to the baseline's.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as j_recsys
from repro_torch.configs import base
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import recsys
from repro_torch.sharding import axis_rules

from test_torch_steps import smoke_registry

ROOT = os.path.join(os.path.dirname(__file__), "..")
F, V, D, B = 3, 32, 8, 16
AXES = ("data", "model")
# case: (mesh shape, lookup axes or None for the default, capacity factor)
CASES = {
    "m14": ((1, 4), None, 4.0),          # cf = shards: no request drops
    "m24": ((2, 4), None, 4.0),
    "zero": ((2, 4), AXES, 8.0),         # a2a_zero's exchange over both
    "drop": ((2, 4), None, 0.5),         # cap 1: drops
    "drop_zero": ((2, 4), AXES, 0.5),
}

_CHILD = textwrap.dedent('''
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.models.recsys import alltoall_lookup
    from repro.sharding.specs import axis_rules
    data = np.load(sys.argv[1])
    cases = eval(sys.argv[2])
    tables, w = jnp.asarray(data["tables"]), jnp.asarray(data["w"])
    out = {}
    for name, (shape, axes, cf) in cases.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        rules = {"__mesh__": mesh, "__lookup__": "a2a"}
        if axes:
            rules["__lookup_axes__"] = axes
        for ids_key in ("ids", "oob") if name == "m24" else ("ids",):
            ids = jnp.asarray(data[ids_key])

            def loss(t):
                with axis_rules(rules):
                    return (alltoall_lookup(t, ids, capacity_factor=cf)
                            * w).sum()
            with axis_rules(rules):
                rows = jax.jit(lambda t: alltoall_lookup(
                    t, ids, capacity_factor=cf))(tables)
            key = name if ids_key == "ids" else "oob"
            out[key + "/rows"] = np.asarray(rows)
            if ids_key == "ids":
                out[key + "/grad"] = np.asarray(jax.jit(jax.grad(loss))(
                    tables))
    np.savez(sys.argv[3], **out)
''')


def _inputs():
    rng = np.random.default_rng(0)
    tables = rng.normal(size=(F, V, D)).astype(np.float32)
    ids = rng.integers(0, V, size=(B, F)).astype(np.int32)
    oob = ids.copy()
    oob[0, 0], oob[1, 1] = -1, V
    w = rng.normal(size=(B, F, D)).astype(np.float32)
    return {"tables": tables, "ids": ids, "oob": oob, "w": w}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's rows and gradients for every case, from one
    subprocess with eight host devices."""
    d = tmp_path_factory.mktemp("a2a")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", _CHILD, str(d / "in.npz"), repr(CASES),
         str(d / "out.npz")], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(d / "out.npz") as out:
        return inputs, dict(out)


def _mesh(shape, devices=None):
    n = int(np.prod(shape))
    return Mesh(devices or [torch.device("cpu")] * n, AXES, shape)


def _port(inputs, shape, axes, cf, *, ids_key="ids", devices=None,
          backend="reference"):
    """(rows (B, F, D), d sum(rows * w) / d tables (F, V, D), dropped)."""
    rules = {"__mesh__": _mesh(shape, devices), "__lookup__": "a2a"}
    if axes:
        rules["__lookup_axes__"] = axes
    t = torch.tensor(inputs["tables"].reshape(F * V, D), requires_grad=True)
    ids = torch.tensor(inputs[ids_key])
    with axis_rules(rules):
        rows = recsys.alltoall_lookup(t, ids, capacity_factor=cf,
                                      backend=backend)
        dropped = recsys.alltoall_dropped(ids, V, capacity_factor=cf)
    g, = torch.autograd.grad((rows * torch.tensor(inputs["w"])).sum(), t)
    return rows.detach().numpy(), g.numpy().reshape(F, V, D), dropped


def _baseline(inputs):
    """The port's per-feature ``take_rows`` gather and its gradient."""
    t = torch.tensor(inputs["tables"].reshape(F * V, D), requires_grad=True)
    rows = recsys._feature_rows(t, torch.tensor(inputs["ids"]))
    g, = torch.autograd.grad((rows * torch.tensor(inputs["w"])).sum(), t)
    return rows.detach().numpy(), g.numpy().reshape(F, V, D)


@pytest.mark.parametrize("case", ["m14", "m24", "zero"])
def test_rows_and_gradient_where_nothing_drops(ref, case):
    inputs, want = ref
    shape, axes, cf = CASES[case]
    rows, grad, dropped = _port(inputs, shape, axes, cf)
    plain = np.asarray(j_recsys._table_lookup(jnp.asarray(inputs["tables"]),
                                              jnp.asarray(inputs["ids"])))
    assert dropped == 0
    np.testing.assert_array_equal(rows, plain)
    np.testing.assert_array_equal(rows, want[case + "/rows"])
    b_rows, b_grad = _baseline(inputs)
    np.testing.assert_array_equal(rows, b_rows)
    np.testing.assert_array_equal(grad.view(np.int32), b_grad.view(np.int32))
    np.testing.assert_allclose(grad, want[case + "/grad"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["drop", "drop_zero"])
def test_forced_drops_match_the_reference(ref, case):
    inputs, want = ref
    shape, axes, cf = CASES[case]
    rows, grad, dropped = _port(inputs, shape, axes, cf)
    ref_rows = want[case + "/rows"]
    zero = (rows == 0).all(-1)
    assert dropped == zero.sum() > 0
    np.testing.assert_array_equal(zero, (ref_rows == 0).all(-1))
    b_rows, _ = _baseline(inputs)
    np.testing.assert_array_equal(rows[~zero], b_rows[~zero])
    # The reference scatters each dropped request into bucket slot
    # (owner 0, 0) as a 0, so in a position with a drop its first
    # request to owner 0 reads owner 0's row 0 of feature 0; the port
    # writes no dropped request.  Everywhere else the two are equal.
    n_pos = int(np.prod(shape))
    S = int(np.prod([dict(zip(AXES, shape))[a] for a in (axes or ("model",))]))
    owner = inputs["ids"] // (V // S)
    hit = np.zeros_like(zero)
    for p in range(n_pos):
        blk = slice(p * (B // n_pos), (p + 1) * (B // n_pos))
        first = np.argwhere(owner[blk] == 0)
        if zero[blk].any() and len(first):
            hit[blk][tuple(first[0])] = True
    same = ~hit & ~zero
    np.testing.assert_array_equal(rows[same], ref_rows[same])
    # the kept requests' gradient alone
    t = torch.tensor(inputs["tables"].reshape(F * V, D), requires_grad=True)
    kept = torch.tensor(~zero)[..., None]
    sel = torch.where(kept, recsys._feature_rows(t, torch.tensor(
        inputs["ids"])), 0)
    g, = torch.autograd.grad((sel * torch.tensor(inputs["w"])).sum(), t)
    np.testing.assert_array_equal(grad, g.numpy().reshape(F, V, D))


def test_out_of_range_ids_raise(ref):
    """The reference's exchange takes ``id // vsh`` with no wrap rule:
    id V reads some row, where its plain ``jnp.take`` gives NaN (and
    with other ids, in-range requests of the position can read wrong
    rows).  The port raises instead (ROADMAP § C)."""
    inputs, want = ref
    with pytest.raises(ValueError, match="outside"):
        _port(inputs, (2, 4), None, 4.0, ids_key="oob")
    plain = np.asarray(j_recsys._table_lookup(jnp.asarray(inputs["tables"]),
                                              jnp.asarray(inputs["oob"])))
    assert np.isnan(plain[1, 1]).all()
    assert np.isfinite(want["oob/rows"][1, 1]).all()


def test_positions_on_two_devices():
    """Positions that name another device than the table's get their
    shard's rows there (``cpu`` and ``cpu:0`` are two devices to a
    mesh): rows bit-equal, gradients within rounding."""
    inputs = _inputs()
    devs = [torch.device("cpu"), torch.device("cpu", 0)] * 4
    rows, grad, _ = _port(inputs, (2, 4), None, 4.0, devices=devs)
    assert _mesh((2, 4), devs).distinct() == 2
    b_rows, b_grad = _baseline(inputs)
    np.testing.assert_array_equal(rows, b_rows)
    np.testing.assert_allclose(grad, b_grad, atol=1e-6, rtol=0)


def test_fused_answers_with_one_embedding_bag_call(monkeypatch):
    """On ``fused`` with no grad the owners' buckets are one B8 call:
    8 positions x 4 owners x cap 3 bags of one id (cf 2: cap = ceil(2 x
    6 / 4)), the rows the ``reference`` exchange's bit for bit."""
    inputs = _inputs()
    calls = []
    real = recsys.embedding_bag_op
    monkeypatch.setattr(recsys, "embedding_bag_op",
                        lambda t, i, **kw: calls.append(tuple(i.shape)) or
                        real(t, i, **kw))
    rules = {"__mesh__": _mesh((2, 4)), "__lookup__": "a2a"}
    t = torch.tensor(inputs["tables"].reshape(F * V, D))
    ids = torch.tensor(inputs["ids"])
    with axis_rules(rules), torch.no_grad():
        rows = recsys._table_lookup(t, ids, backend="fused")
        want = recsys.alltoall_lookup(t, ids, backend="reference")
    assert calls == [(8 * 4 * 3, 1)]
    np.testing.assert_array_equal(rows.numpy(), want.numpy())


def test_no_mesh_is_the_gather():
    inputs = _inputs()
    t = torch.tensor(inputs["tables"].reshape(F * V, D))
    with axis_rules({"__lookup__": "a2a"}):
        rows = recsys.alltoall_lookup(t, torch.tensor(inputs["oob"]))
    want = recsys._feature_rows(t, torch.tensor(inputs["oob"]))
    np.testing.assert_array_equal(rows.numpy(), want.numpy())


@pytest.mark.parametrize("variant", ["a2a_lookup", "a2a_zero"])
def test_train_step_bit_equal_to_baseline(variant):
    """dlrm-rm2's ``train_batch`` cell at SMOKE (128 rows a table, which
    8 shards split) on a 2 x 4 mesh of CPU positions: one step of the
    a2a cell from the baseline's state and batch gives the same loss and
    every train-state leaf bit for bit (nothing drops at batch 64 and cf
    2 with these ids)."""
    m = _mesh((2, 4))
    out = {}
    with smoke_registry():
        entry = base._REGISTRY["dlrm-rm2"]
        base._REGISTRY["dlrm-rm2"] = dataclasses.replace(
            entry, config=dataclasses.replace(entry.config, table_rows=128))
        for v in ("baseline", variant):
            cell = steps.materialize(steps.build_cell(
                "dlrm-rm2", "train_batch", m, variant=v), "cpu",
                torch.Generator().manual_seed(0))
            if v != "baseline":
                with axis_rules(cell.rules):
                    assert recsys.alltoall_dropped(
                        cell.args[1]["sparse_ids"],
                        cell.args[0]["params"].cfg.table_rows) == 0
            state, metrics = cell.fn(*cell.args)
            out[v] = (metrics["loss"], {p: t for p, t, _ in steps.leaves(
                dataclasses.replace(cell, args=(state, cell.args[1])))})
    (l0, s0), (l1, s1) = out["baseline"], out[variant]
    assert torch.equal(l0, l1)
    assert s0.keys() == s1.keys()
    for p in s0:
        assert torch.equal(s0[p], s1[p]), p
