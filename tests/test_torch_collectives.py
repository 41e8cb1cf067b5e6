"""The dry run's collective count (``repro_torch.launch.roofline``)
against the reference's compiled HLO.

The reference counts a cell's collectives from the optimized HLO of its
step (``repro.launch.roofline.parse_hlo_costs``).  Its dry run builds a
mesh with ``jax.make_mesh``, whose axes are Explicit under recent JAX,
and its ``constrain`` refuses them, so the children here build an
Auto-axis ``jax.sharding.Mesh`` over eight forced host devices for each
case: 2 x 4 (``data``, ``model``), or, for the multi-pod rule sets, 2 x
2 x 2 or 2 x 1 x 4 (``pod``, ``data``, ``model``).  Each reduced cell is
compiled as ``repro.launch.dryrun.run_cell`` does (``jax.jit`` with the
cell's shardings and donation), and each child prints its cells' bytes a
device by collective type (three children side by side).  The port
counts the same cells, with the same reductions, on a mesh of the same
shape of ``meta`` positions.

Reductions (both packages alike): narrow widths, with head counts that
divide the ``model`` axis where the full-size cell's do, short sequences
and eight LM layers (the layers' collectives then outweigh the embedding
lookups', which the port leaves out, as at full size); the MoE cells
keep enough tokens for two (prefill) and eight (train) dispatch blocks
of 2,048, so that the block axis shards as at full size, and the
multi-pod MoE train cell keeps the experts' ffn wider than the model, as
mixtral's and granite's products are partitioned at full size.  The
multi-pod train cells split the sequence into query chunks over the
``model`` axis: on 2 x 2 x 2 each chunk's rows stay whole, on 2 x 1 x 4
they split two ways, with a query group of two (queries gathered) and
three (keys and values gathered).  BERT4Rec's retrieval cell keeps a
catalog of 100,000 items: on 2 x 2 x 2 its FSDP and candidate ways are
equal (XLA reshards it by all-to-all), on 2 x 4 they are not (XLA
gathers it).  Held: each cell's total within 15 % of the reference's,
and each collective type that makes up at least 10 % of the reference's
total within 15 % of it.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

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
_LM_SP = dict(_LM, attn_chunk=32)          # query chunks of the seq split
_MOE_SP = dict(_MOE, d_ff=256, attn_chunk=1024)
_MOE_DEC = dict(_MOE, attn_window_serving=64)
_MIXTRAL = dict(_MOE, n_heads=16, n_kv_heads=2, vocab=256, moe_experts=4,
                window=64, attn_chunk=32)
_B4R = {"n_items": 10_000}
POD = (2, 2, 2)
# (arch, shape, variant, config overrides, shape-dim overrides[, mesh])
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
    ("minitron-4b", "train_4k", "baseline", _LM_SP,
     {"seq_len": 64, "global_batch": 8}, POD),
    ("minitron-4b", "train_4k", "baseline", _LM_SP,
     {"seq_len": 64, "global_batch": 8}, (2, 1, 4)),
    ("minitron-4b", "train_4k", "baseline", dict(_LM_SP, n_heads=12),
     {"seq_len": 64, "global_batch": 8}, (2, 1, 4)),
    ("granite-moe-3b-a800m", "train_4k", "baseline", _MOE_SP,
     {"seq_len": 2048, "global_batch": 8}, POD),
    ("granite-moe-3b-a800m", "decode_32k", "baseline", _MOE_DEC,
     {"seq_len": 64, "global_batch": 16}),
    ("granite-moe-3b-a800m", "decode_32k", "baseline", _MOE_DEC,
     {"seq_len": 64, "global_batch": 16}, POD),
    ("granite-moe-3b-a800m", "long_500k", "baseline", _MOE_DEC,
     {"seq_len": 256}),
    ("granite-moe-3b-a800m", "long_500k", "baseline", _MOE_DEC,
     {"seq_len": 256}, POD),
    ("mixtral-8x7b", "prefill_32k", "baseline", _MIXTRAL,
     {"seq_len": 512, "global_batch": 8}),
    ("bert4rec", "train_batch", "baseline", _B4R,
     {"batch": 512, "seq_len": 32}),
    ("bert4rec", "train_batch", "baseline", _B4R,
     {"batch": 512, "seq_len": 32}, POD),
    ("bert4rec", "serve_bulk", "baseline", _B4R,
     {"batch": 4096, "seq_len": 32}, POD),
    ("bert4rec", "retrieval_cand", "baseline", {"n_items": 100_000}, {}),
    ("bert4rec", "retrieval_cand", "baseline", {"n_items": 100_000}, {},
     POD),
    ("dlrm-rm2", "retrieval_cand", "baseline", {"table_rows": 4096}, {}),
    ("colbert", "prune_index", "baseline", _COLBERT,
     {"docs_per_block": 16, "doc_len": 24, "n_samples": 64,
      "out_dim": 32}),
]

_CHILD = textwrap.dedent('''
    import dataclasses, json, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs import base
    from repro.launch import roofline, steps
    for i, arch, shape, variant, cfg, dims, grid in json.loads(sys.argv[1]):
        names = ("data", "model") if len(grid) == 2 else ("pod", "data",
                                                           "model")
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(grid), names)
        e = base._REGISTRY[arch]
        s = e.shapes[shape]
        base._REGISTRY[arch] = dataclasses.replace(
            e, config=dataclasses.replace(e.config, **cfg),
            shapes=dict(e.shapes, **{shape: dataclasses.replace(
                s, dims=dict(s.dims, **dims))}))
        try:
            cell = steps.build_cell(arch, shape, mesh, variant=variant,
                                    multi_pod=len(grid) == 3)
            with mesh:
                text = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                               out_shardings=cell.out_shardings,
                               donate_argnums=cell.donate).lower(
                    *cell.args).compile().as_text()
        finally:
            base._REGISTRY[arch] = e
        print(json.dumps([i, roofline.parse_hlo_costs(
            text)["collective_breakdown"]]), flush=True)
''')
N_CHILDREN = 3


def _grid(case) -> tuple:
    return tuple(case[5]) if len(case) > 5 else (2, 4)


def _id(case) -> str:
    grid = _grid(case)
    tail = "" if grid == (2, 4) else "-" + "x".join(map(str, grid))
    if grid == (2, 1, 4):       # two query groups on the same mesh
        tail += f"-g{case[3]['n_heads'] // case[3]['n_kv_heads']}"
    return f"{case[0]}-{case[1]}-{case[2]}{tail}"


class _Reference:
    """The reference's compiled cells, from child processes side by side:
    ``get(i)`` waits for the case at position ``i`` of ``CELLS`` (bytes
    a device by collective type) while the others still compile, so the
    port's counts run beside the children."""

    def __init__(self, children, errs, timeout=600.0):
        self.children, self.errs = children, errs
        self.deadline = time.monotonic() + timeout
        self.out = {}
        self.done = threading.Condition()
        self.readers = [threading.Thread(target=self._read, args=(c,),
                                         daemon=True) for c in children]
        for r in self.readers:
            r.start()

    def _read(self, child):
        for line in child.stdout:
            i, br = json.loads(line)
            with self.done:
                self.out[i] = br
                self.done.notify_all()
        child.wait()
        with self.done:
            self.done.notify_all()

    def get(self, i):
        with self.done:
            while i not in self.out:
                if not any(r.is_alive() for r in self.readers):
                    for child, err in zip(self.children, self.errs):
                        err.seek(0)
                        assert child.returncode == 0, err.read()[-3000:]
                    raise AssertionError(f"no reference figures for {i}")
                assert time.monotonic() < self.deadline, "children timed out"
                self.done.wait(timeout=5)
            return self.out[i]


@pytest.fixture(scope="module")
def reference():
    """The reference's figures (:class:`_Reference`), from
    ``N_CHILDREN`` child processes (their warnings to files: a full pipe
    would stall them).  The collectives are fixed by XLA's HLO passes;
    the children skip LLVM's optimisation of the host code after them,
    which halves their CPU time and leaves every figure as it was."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8"
               " --xla_backend_optimization_level=0"
               " --xla_llvm_disable_expensive_passes=true",
               JAX_PLATFORMS="cpu")
    cases = [[i] + list(c[:5]) + [list(_grid(c))]
             for i, c in enumerate(CELLS)]
    errs = [tempfile.TemporaryFile(mode="w+") for _ in range(N_CHILDREN)]
    children = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, json.dumps(cases[k::N_CHILDREN])],
        env=env, stdout=subprocess.PIPE, stderr=err, text=True)
        for k, err in enumerate(errs)]
    yield _Reference(children, errs)
    for child, err in zip(children, errs):
        child.kill()
        child.wait()
        err.close()


def _port(arch, shape, variant, cfg, dims, grid=(2, 4)) -> dict:
    e = base._REGISTRY[arch]
    s = e.shapes[shape]
    base._REGISTRY[arch] = dataclasses.replace(
        e, config=dataclasses.replace(e.config, **cfg),
        shapes=dict(e.shapes, **{shape: dataclasses.replace(
            s, dims=dict(s.dims, **dims))}))
    try:
        names = ("data", "model") if len(grid) == 2 else ("pod", "data",
                                                           "model")
        mesh = Mesh([torch.device("meta")] * 8, names, tuple(grid))
        cell = steps.build_cell(arch, shape, mesh, variant=variant,
                                multi_pod=len(grid) == 3,
                                backend="reference")
        _, costs = roofline.count_costs(cell.fn, *cell.args, mesh=mesh)
        return roofline.collectives(cell, costs)
    finally:
        base._REGISTRY[arch] = e


@pytest.mark.parametrize("case", CELLS, ids=_id)
def test_cell_within_15_percent_of_the_reference_hlo(reference, case):
    want = reference.get(CELLS.index(case))
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
