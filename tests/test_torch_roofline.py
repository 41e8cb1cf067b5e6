"""The port's roofline counts and dry run (``launch.roofline``,
``launch.dryrun``): ``roofline_terms`` against hand values, the op
rules of ``count_costs`` (a product's 2mnk by operand dtype, the
gather, scatter and view byte rules), equal counts on ``meta`` and on
the CPU for the smoke prefill cell, the state collectives of a train
cell, and ``run_cell`` on meta for a full-size cell of each status.
No JAX: the counts have no reference counterpart (the reference parses
compiled HLO).
"""

import json

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, mesh, roofline, steps
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
    m = _meta_mesh()
    base = steps.build_cell("stablelm-3b", "train_4k", m)
    pinned = steps.build_cell("stablelm-3b", "train_4k", m,
                              variant="rs_grads")
    params = sum(t.numel() * t.element_size()
                 for p, t, _ in steps.leaves(base) if p[:2] == (0, "params"))
    got, rs = (roofline.state_collectives(c) for c in (base, pinned))
    # pure FSDP shards every leaf; remat gathers each one twice
    assert got["all-gather"] == rs["all-gather"] == 2 * params
    assert got["all-reduce"] == 2 * params and got["reduce-scatter"] == 0
    assert rs["reduce-scatter"] == params and rs["all-reduce"] == 0
    serve = steps.build_cell("stablelm-3b", "prefill_32k", m)
    assert sum(roofline.state_collectives(serve).values()) == 0


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
    assert a["counted_on"] == "reference" and a["collectives"] == "state"
    assert a["model_bound_s"] == pytest.approx(
        a["model_flops"] / (256 * roofline.PEAK_BF16_FLOPS))
    assert a["flops"] > a["model_flops"]
    assert {r["op"] for r in a["top_ops"]["by_flops"]} >= {"aten.bmm"}


@pytest.mark.parametrize("arch,shape,op", [
    ("dlrm-rm2", "train_batch", "aten.unique_consecutive"),
    ("gin-tu", "ogb_products", "aten.index"),
])
def test_run_cell_data_dependent(arch, shape, op):
    rec = dryrun.run_cell(arch, shape, multi_pod=False, verbose=False)
    assert rec["status"] == "data_dependent" and rec["op"] == op
    assert rec["model_flops"] > 0 and rec["argument_bytes_per_device"] > 0
    assert "analysis" not in rec


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
