"""The dry run's collective count (``repro_torch.launch.roofline``)
against the reference's compiled HLO.

The reference counts a cell's collectives from the optimized HLO of its
step (``repro.launch.roofline.parse_hlo_costs``).  Its dry run builds a
mesh with ``jax.make_mesh``, whose axes are Explicit under recent JAX,
and its ``constrain`` refuses them, so the child here builds an
Auto-axis 2 x 4 (``data``, ``model``) ``jax.sharding.Mesh`` over eight
forced host devices, compiles each reduced cell as
``repro.launch.dryrun.run_cell`` does (``jax.jit`` with the cell's
shardings and donation) and prints each cell's bytes a device by
collective type (three children side by side).  The port counts the
same cells, with the same reductions, on a 2 x 4 mesh of ``meta``
positions.

Reductions (both packages alike): narrow widths, with head counts that
divide the 4-way ``model`` axis, short sequences and eight LM layers
(the layers' collectives then outweigh the embedding lookups', which the
port leaves out, as at full size);
the MoE cells keep enough tokens for two (prefill) and eight (train)
dispatch blocks of 2,048, so that the block axis shards as at full
size.  Held: each cell's total within 15 % of the reference's, and each
collective type that makes up at least 10 % of the reference's total
within 15 % of it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import base
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import Mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 0.15

_LM = dict(n_layers=8, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
           d_ff=256, vocab=512)
_MOE = dict(n_layers=8, d_model=128, n_heads=8, n_kv_heads=4, head_dim=16,
            d_ff=64, vocab=250, moe_experts=8, moe_top_k=2)
_COLBERT = dict(vocab=512, n_layers=2, d_model=64, n_heads=4, d_ff=128,
                out_dim=32)
# (arch, shape, variant, config overrides, shape-dim overrides)
CELLS = [
    ("minitron-4b", "train_4k", "baseline", _LM,
     {"seq_len": 64, "global_batch": 8}),
    ("minitron-4b", "prefill_32k", "baseline", _LM,
     {"seq_len": 64, "global_batch": 8}),
    ("minitron-4b", "decode_32k", "baseline", _LM,
     {"seq_len": 64, "global_batch": 8}),
    ("granite-moe-3b-a800m", "prefill_32k", "baseline", _MOE,
     {"seq_len": 512, "global_batch": 8}),
    ("granite-moe-3b-a800m", "train_4k", "baseline", _MOE,
     {"seq_len": 2048, "global_batch": 8}),
    ("gin-tu", "full_graph_sm", "baseline", {}, {}),
    ("gin-tu", "molecule", "baseline", {}, {}),
    ("dlrm-rm2", "train_batch", "baseline", {"table_rows": 4096},
     {"batch": 512}),
    ("dlrm-rm2", "train_batch", "a2a_lookup", {"table_rows": 4096},
     {"batch": 512}),
    ("dlrm-rm2", "serve_bulk", "baseline", {"table_rows": 4096},
     {"batch": 2048}),
    ("bert4rec", "serve_p99", "baseline", {"n_items": 10_000},
     {"batch": 512, "seq_len": 32}),
    ("colbert", "encode_corpus", "baseline", _COLBERT,
     {"batch": 64, "doc_len": 32}),
    ("colbert", "train_contrastive", "baseline", _COLBERT,
     {"batch": 64, "query_len": 8, "doc_len": 32}),
]

_CHILD = textwrap.dedent('''
    import dataclasses, json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import base
    from repro.launch import roofline, steps
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    for arch, shape, variant, cfg, dims in json.loads(sys.argv[1]):
        e = base._REGISTRY[arch]
        s = e.shapes[shape]
        base._REGISTRY[arch] = dataclasses.replace(
            e, config=dataclasses.replace(e.config, **cfg),
            shapes=dict(e.shapes, **{shape: dataclasses.replace(
                s, dims=dict(s.dims, **dims))}))
        try:
            cell = steps.build_cell(arch, shape, mesh, variant=variant)
            with mesh:
                text = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                               out_shardings=cell.out_shardings,
                               donate_argnums=cell.donate).lower(
                    *cell.args).compile().as_text()
        finally:
            base._REGISTRY[arch] = e
        print(json.dumps([arch, shape, variant, roofline.parse_hlo_costs(
            text)["collective_breakdown"]]), flush=True)
''')


@pytest.fixture(scope="module")
def reference():
    """{(arch, shape, variant): bytes a device by collective type} of
    the reference's compiled cells, from three child processes side by
    side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    children = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, json.dumps(CELLS[i::3])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(3)]
    out = {}
    for child in children:
        stdout, stderr = child.communicate(timeout=600)
        assert child.returncode == 0, stderr[-3000:]
        for line in stdout.splitlines():
            arch, shape, variant, br = json.loads(line)
            out[(arch, shape, variant)] = br
    return out


def _port(arch, shape, variant, cfg, dims) -> dict:
    e = base._REGISTRY[arch]
    s = e.shapes[shape]
    base._REGISTRY[arch] = dataclasses.replace(
        e, config=dataclasses.replace(e.config, **cfg),
        shapes=dict(e.shapes, **{shape: dataclasses.replace(
            s, dims=dict(s.dims, **dims))}))
    try:
        mesh = Mesh([torch.device("meta")] * 8, ("data", "model"), (2, 4))
        cell = steps.build_cell(arch, shape, mesh, variant=variant,
                                backend="reference")
        _, costs = roofline.count_costs(cell.fn, *cell.args, mesh=mesh)
        return roofline.collectives(cell, costs)
    finally:
        base._REGISTRY[arch] = e


@pytest.mark.parametrize("case", CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_cell_within_15_percent_of_the_reference_hlo(reference, case):
    want = reference[case[:3]]
    got = _port(*case)
    total = sum(want.values())
    assert total > 0
    assert sum(got.values()) == pytest.approx(total, rel=TOL), (got, want)
    for kind, b in want.items():
        if b >= 0.1 * total:
            assert got[kind] == pytest.approx(b, rel=TOL), (kind, got, want)


def test_the_record_names_every_collective_type():
    """The record takes the reference's five types, ``collective-permute``
    included, and says what it counted."""
    case = CELLS[7]
    e = base._REGISTRY[case[0]]
    cfg = dataclasses.replace(e.config, **case[3])
    base._REGISTRY[case[0]] = dataclasses.replace(e, config=cfg)
    try:
        mesh = Mesh([torch.device("meta")] * 8, ("data", "model"), (2, 4))
        for variant, kinds in (("baseline", "state+activations"),
                               ("a2a_lookup", "state+activations+a2a")):
            cell = steps.build_cell(case[0], "serve_p99", mesh,
                                    variant=variant, backend="reference")
            _, costs = roofline.count_costs(cell.fn, *cell.args, mesh=mesh)
            a = roofline.analyze(cell, costs, 8)
            assert tuple(a["collective_breakdown"]) == roofline.COLLECTIVES
            assert a["collectives"] == kinds
            assert a["collective_bytes_per_device"] == pytest.approx(
                sum(a["collective_breakdown"].values()))
    finally:
        base._REGISTRY[case[0]] = e
