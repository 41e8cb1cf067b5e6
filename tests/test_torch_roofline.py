"""The port's roofline counts and dry run (``launch.roofline``,
``launch.dryrun``): ``roofline_terms`` against hand values, the op
rules of ``count_costs`` (a product's 2mnk by operand dtype, the
gather, scatter and view byte rules), equal counts on ``meta`` and on
the CPU for the smoke prefill cell, the state collectives of a train
cell and the a2a cells' exchange, ``run_cell`` on meta for a full-size
cell of each status, the upper-bound rule of the data-dependent steps
(exact on all-distinct ids, a bound on a real graph), and the counted
recomputation of ``attn_remat``.
No JAX: the counts have no reference counterpart (the reference parses
compiled HLO).
"""

import dataclasses
import json

import pytest
import torch

from repro_torch import configs, sharding
from repro_torch.configs import base
from repro_torch.launch import dryrun, mesh, roofline, steps
from repro_torch.models import recsys
from repro_torch.train import train_step
from test_torch_steps import smoke_registry


def _meta_mesh():
    return mesh.make_production_mesh(devices=[torch.device("meta")])


def test_roofline_terms_hand_values():
    t = roofline.roofline_terms({"bf16": 989e12, "fp32": 67e12}, 3.35e12,
                                450e9)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute_s"
    assert t["step_time_bound_s"] == pytest.approx(2.0)
    assert t["roofline_fraction"] == pytest.approx(1.0)
    t = roofline.roofline_terms(989e12, 6.7e12, 0.0)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["dominant"] == "memory_s"
    assert t["roofline_fraction"] == pytest.approx(0.5)
    assert roofline.roofline_terms(0.0, 0.0, 0.0)["roofline_fraction"] == 0


@pytest.mark.parametrize("dtype,part", [(torch.float32, "fp32"),
                                        (torch.bfloat16, "bf16")])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_flops_by_dtype(dtype, part, device):
    m, k, n = 6, 5, 7
    a = torch.ones((m, k), dtype=dtype, device=device)
    b = torch.ones((k, n), dtype=dtype, device=device)
    _, c = roofline.count_costs(torch.matmul, a, b)
    assert c.flops[part] == 2 * m * n * k
    assert sum(c.flops.values()) == 2 * m * n * k
    assert c.bytes == (m * k + k * n + m * n) * a.element_size()
    assert c.top_ops()["by_flops"][0]["op"] == "aten.mm"


def test_gather_scatter_and_view_bytes():
    table = torch.randn(100, 8)
    idx = torch.tensor([3, 1, 3, 7])
    _, c = roofline.count_costs(table.index_select, 0, idx)
    assert c.bytes == 2 * 4 * 8 * 4                    # 2 x output
    out, src = torch.zeros(10, 8), torch.randn(4, 8)
    _, c = roofline.count_costs(out.index_add_, 0, idx, src)
    assert c.bytes == 2 * src.numel() * 4              # 2 x update
    _, c = roofline.count_costs(lambda: table.view(50, 16).t()[:, :3])
    assert c.bytes == 0 and c.ops                      # views move nothing
    x = torch.randn(16, 4)
    _, c = roofline.count_costs(torch.add, x, x)
    assert c.bytes == 3 * x.numel() * 4                # operands + output


def test_meta_and_cpu_counts_equal_for_the_smoke_prefill():
    with smoke_registry():
        cell = steps.build_cell("minitron-4b", "prefill_32k", _meta_mesh(),
                                backend="reference")
        _, on_meta = roofline.count_costs(cell.fn, *cell.args)
        real = steps.materialize(cell, "cpu", torch.Generator().manual_seed(0))
        _, on_cpu = roofline.count_costs(real.fn, *real.args)
    assert on_meta.flops == on_cpu.flops and on_meta.bytes == on_cpu.bytes
    assert on_meta.ops == on_cpu.ops
    assert on_meta.flops["fp32"] > 0 and on_meta.flops["bf16"] == 0


def test_state_collectives_of_a_train_cell():
    """The parameters' collectives at the reference HLO's width (4 bytes
    a float): pure FSDP shards every leaf over all 256 positions; the
    layer stack is gathered in the forward and again in the backward,
    the embedding and head once; each gradient is all-reduced (or, with
    ``rs_grads``, reduce-scattered) once.  A prefill cell gathers each
    leaf over ``data`` (its batch axis), keeping its ``model`` split."""
    m = _meta_mesh()
    base = steps.build_cell("stablelm-3b", "train_4k", m)
    pinned = steps.build_cell("stablelm-3b", "train_4k", m,
                              variant="rs_grads")
    leaves = [(p, t.numel() * 4) for p, t, _ in steps.leaves(base)
              if p[:2] == (0, "params")]
    params = sum(b for _, b in leaves)
    layers = sum(b for p, b in leaves if "layers" in p)
    got, rs = (roofline.param_collectives(c) for c in (base, pinned))
    assert got["all-gather"] == rs["all-gather"] == params + layers
    assert got["all-reduce"] == 2 * params and got["reduce-scatter"] == 0
    assert rs["reduce-scatter"] == params and rs["all-reduce"] == 0
    serve = steps.build_cell("stablelm-3b", "prefill_32k", m)
    want = 0.0
    for p, t, spec in steps.leaves(serve):
        axes = [a for part in spec if part for a in
                ((part,) if isinstance(part, str) else part)]
        if p[0] == 0 and "data" in axes:
            want += t.numel() * 4 / (16 if "model" in axes else 1)
    got = roofline.param_collectives(serve)
    assert got["all-gather"] == want > 0
    assert sum(got.values()) == want


def test_run_cell_prefill_on_meta():
    rec = dryrun.run_cell("minitron-4b", "prefill_32k", multi_pod=False,
                          verbose=False)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    a = rec["analysis"]
    cfg = configs.get("minitron-4b").config
    D, L, V, F = cfg.d_model, cfg.n_layers, cfg.vocab, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    # sharded 256 ways: embed (model, data), every layer matrix (data,
    # model); replicated: the norms; tokens (32, 32768) int32 over data
    sharded = (V * D + L * (2 * D * q + 2 * D * kv + 3 * D * F)) * 2 / 256
    replicated = (2 * L * D + D) * 2
    tokens = 32 * 32768 * 4 / 16
    assert a["argument_bytes_per_device"] == pytest.approx(
        sharded + replicated + tokens, rel=1e-12)
    assert a["model_flops"] == pytest.approx(2.0 * cfg.active_param_count()
                                             * 32 * 32768)
    assert (a["counted_on"] == "reference"
            and a["collectives"] == "state+activations")
    # the attention's output and the MLP's down projections contract the
    # 16-way heads / ffn axis: an all-reduce of the (2, 32768, 3072)
    # block a device (fp32 in the reference's HLO) each, every layer
    br = a["collective_breakdown"]
    assert br["all-reduce"] == 2 * L * 2 * (2 * 32768 * D * 4)
    # the reference's compiled HLO: 2.134e11 bytes a device (24 query
    # heads padded to 32 and 8 KV heads on the 16-way axis; its
    # collective-permutes are left out)
    assert a["collective_bytes_per_device"] == pytest.approx(2.134e11,
                                                             rel=0.15)
    assert a["model_bound_s"] == pytest.approx(
        a["model_flops"] / (256 * roofline.PEAK_BF16_FLOPS))
    assert a["flops"] > a["model_flops"]
    assert {r["op"] for r in a["top_ops"]["by_flops"]} >= {"aten.bmm"}


@pytest.mark.parametrize("arch,shape,op", [
    ("dlrm-rm2", "train_batch", "aten.unique_consecutive"),
    ("gin-tu", "ogb_products", "aten.index"),
])
def test_run_cell_data_dependent(arch, shape, op):
    """A step that reads a value of its data (``take_rows``' backward,
    the GNN gather plan) is counted at the upper bound of its shapes,
    and its record names the ops that took the bound."""
    rec = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
    assert rec["status"] == "ok"
    a = rec["analysis"]
    assert a["counted_by"].startswith("upper bound on meta") and op in \
        a["counted_by"]
    assert a["model_flops"] > 0 and a["argument_bytes_per_device"] > 0
    assert a["flops"] > 0 and a["bytes"] > 0


def _grad_costs(cell, loss):
    """The costs of the cell's loss and gradients on its arguments
    (the optimizer, which takes CPU square roots in fp64, left out)."""
    state, batch = cell.args
    model = state["params"]
    with sharding.axis_rules(cell.rules):
        return roofline.count_costs(
            lambda: train_step.param_grads(model, loss(model, batch)))[1]


@pytest.mark.parametrize("variant", ["baseline", "a2a_lookup"])
def test_ctr_train_count_on_meta_equals_cpu_on_distinct_ids(variant):
    """With every id distinct, the upper-bound rule is exact: the meta
    count of dlrm-rm2's SMOKE train step equals the CPU count on real
    arguments (FLOPs, bytes, every op's tally).  Under ``a2a_lookup``
    the gradient also runs over the owners' unfilled bucket slots, which
    all read one row an owner: there the bound holds (the same FLOPs, no
    fewer bytes) and is not exact."""
    def loss(model, batch):
        return train_step.ctr_loss(recsys.ctr_forward, model, batch)
    with smoke_registry():
        entry = base._REGISTRY["dlrm-rm2"]
        base._REGISTRY["dlrm-rm2"] = dataclasses.replace(
            entry, config=dataclasses.replace(entry.config, table_rows=128))
        on = {}
        for dev in ("meta", "cpu"):
            m = mesh.Mesh([torch.device(dev)] * 8, ("data", "model"), (2, 4))
            cell = steps.build_cell("dlrm-rm2", "train_batch", m,
                                    variant=variant)
            if dev == "cpu":
                cell = steps.materialize(cell, "cpu",
                                         torch.Generator().manual_seed(0))
                ids = torch.stack([torch.randperm(128)[:64]
                                   for _ in range(26)], 1).int()
                cell.args[1]["sparse_ids"] = ids
            on[dev] = _grad_costs(cell, loss)
    meta, cpu = on["meta"], on["cpu"]
    assert meta.bounded == {"aten.unique_consecutive": 1} and not cpu.bounded
    assert meta.flops == cpu.flops
    if variant == "baseline":
        assert meta.bytes == cpu.bytes and meta.ops == cpu.ops
    else:
        assert cpu.bytes < meta.bytes and meta.ops.keys() == cpu.ops.keys()


def test_gnn_count_on_meta_bounds_the_cpu_count():
    """gin-tu's SMOKE ``molecule`` step: the CPU count on a real graph
    is at most the meta count, and the meta count at most 3 times it
    (FLOPs and bytes; every edge kept and 4 levels of runs bounded)."""
    with smoke_registry():
        cell = steps.build_cell("gin-tu", "molecule", _meta_mesh())
        real = steps.materialize(cell, "cpu", torch.Generator().manual_seed(0))

        def loss(model, batch):
            return train_step.gin_loss(model, batch, "graph")
        meta, cpu = _grad_costs(cell, loss), _grad_costs(real, loss)
    assert set(meta.bounded) == {"aten.index", "aten.unique_consecutive"}
    for m, c in ((sum(meta.flops.values()), sum(cpu.flops.values())),
                 (meta.bytes, cpu.bytes)):
        assert c <= m <= 3 * c, (m, c)


def test_a2a_records_count_the_exchange():
    """The a2a cells' all-to-all bytes a device by the reference's
    convention, and the tables' gradients: an all-reduce of the shard
    over ``data`` (a2a_lookup), none (a2a_zero); no table all-gather.
    The retrieval cell's user tower reads the row-sharded tables in
    place: one all-reduce of its 26 looked-up rows over ``model``; its
    top-k gathers the candidate scores, split over ``model``, whole
    (XLA's TopK is not partitioned)."""
    m = _meta_mesh()
    cfg = configs.get("dlrm-rm2").config
    table = 26 * cfg.table_rows * 64 * 4
    for variant, shards in (("a2a_lookup", 16), ("a2a_zero", 256)):
        cell = steps.build_cell("dlrm-rm2", "train_batch", m, variant=variant)
        got = roofline.collectives(cell)
        n_req = 65_536 // 256 * 26
        cap = -(-2 * n_req // shards)
        slots = shards * cap
        assert got["all-to-all"] == 2 * slots * 4 + 2 * slots * 64 * 4
        mlp = sum(t.numel() * t.element_size() for p, t, _ in
                  steps.leaves(cell) if p[:2] == (0, "params")
                  and p[2] != "tables")
        shard_reduce = 2 * table / 16 if variant == "a2a_lookup" else 0
        assert got["all-reduce"] == pytest.approx(shard_reduce + 2 * mlp)
        assert got["all-gather"] == got["reduce-scatter"] == 0
        serve = steps.build_cell("dlrm-rm2", "serve_p99", m, variant=variant)
        assert roofline.collectives(serve)["all-to-all"] > 0
        retrieval = steps.build_cell("dlrm-rm2", "retrieval_cand", m,
                                     variant=variant, backend="reference")
        _, costs = roofline.count_costs(retrieval.fn, *retrieval.args,
                                        mesh=m)
        got = roofline.collectives(retrieval, costs)
        assert got["all-reduce"] == 2 * 26 * 64 * 4
        assert got["all-gather"] == cfg.table_rows * 4
        assert sum(got.values()) == got["all-reduce"] + got["all-gather"]


def test_attn_remat_counts_the_recomputed_chunks():
    """minitron-4b's SMOKE train step with 4-token attention chunks of
    16: ``attn_remat`` counts more FLOPs than the baseline (each chunk's
    scores recomputed in the backward pass)."""
    flops = {}
    with smoke_registry():
        entry = base._REGISTRY["minitron-4b"]
        base._REGISTRY["minitron-4b"] = dataclasses.replace(
            entry, config=dataclasses.replace(entry.config, attn_chunk=4,
                                              remat=True))
        for v in ("baseline", "attn_remat"):
            cell = steps.build_cell("minitron-4b", "train_4k", _meta_mesh(),
                                    variant=v, backend="reference")
            flops[v] = sum(roofline.count_costs(cell.fn, *cell.args)[1]
                           .flops.values())
    assert flops["attn_remat"] > flops["baseline"]


def test_cli_writes_records(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "colbert", "--shape", "rerank",
                     "--out-dir", str(tmp_path), "--table"])
    assert e.value.code == 0
    assert "| colbert, pod16x16 | `rerank` ok, " in capsys.readouterr().out
    rec = json.loads((tmp_path / "colbert__rerank__pod16x16__baseline.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["analysis"]["dominant"] in ("compute_s", "memory_s")
