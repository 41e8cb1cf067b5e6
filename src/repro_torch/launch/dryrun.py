"""Dry run: count every (architecture x input shape x mesh x variant)
cell on the ``meta`` device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --include-colbert [--table]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-4b \\
        --shape prefill_32k [--multi-pod | --both-meshes] [--variant V]

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 forced host devices.  Here each cell is built by
``launch.steps.build_cell`` on the production mesh over 256 (or 512)
``meta`` positions, its ``fn`` runs once on the ``reference`` backend
under ``launch.roofline.count_costs`` (nothing is allocated: full
configs run on a CPU-only host in seconds), and the record goes to
``build/dryrun/<arch>__<shape>__<mesh>__<variant>.json`` (``--out-dir``
to change it); ``--table`` prints the records as a markdown table at
the end.  There is no ``--reanalyze``: the port has no HLO to re-read.

Statuses: ``ok`` (with ``analysis``, ``roofline.analyze``'s record),
``skipped`` (the reference's documented skips) and ``error`` (with the
op that raised).  A step that reads a value of its data (the GNN gather
plan's kept edges and segment counts, ``take_rows``' backward grouping
a gather's repeated rows: the CTR, BERT4Rec and MoE train steps) is
counted at the upper bound its shapes fix, and its record says so
(``analysis["counted_by"]``; ``launch/roofline.py``).  The CLI exits 1
when any cell fails.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import roofline, steps
from repro_torch.launch.mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")

def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def cell_path(arch, shape, mesh, variant, out_dir=OUT_DIR):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}__{variant}.json")


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             variant: str = "baseline", verbose: bool = True) -> dict:
    """Build and count one cell; its record (module docstring)."""
    name = mesh_name(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")])
    n_dev = int(mesh.devices.size)
    t0 = time.perf_counter()
    cell = steps.build_cell(arch, shape, mesh, multi_pod=multi_pod,
                            variant=variant, backend="reference")
    record = {"arch": arch, "shape": shape, "mesh": name,
              "variant": variant, "n_chips": n_dev, "kind": cell.kind}
    tag = f"[{arch} x {shape} x {name} x {variant}]"
    if cell.skip:
        record.update(status="skipped", skip_reason=cell.skip)
        return record
    try:
        _, costs = roofline.count_costs(cell.fn, *cell.args,
                                         mesh=cell.mesh)
        analysis = roofline.analyze(cell, costs, n_dev)
    except Exception as e:
        failed = getattr(getattr(e, "costs", None), "failed_op", None)
        record.update(status="error", op=failed,
                      error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"{tag} FAILED at {failed}: {e}")
        return record
    record.update(status="ok", count_s=round(time.perf_counter() - t0, 2),
                  analysis=analysis)
    if verbose:
        a = analysis
        print(f"{tag} OK  flops={a['flops']:.3e}  bytes={a['bytes']:.3e}  "
              f"coll/dev={a['collective_bytes_per_device']:.3e}  "
              f"args/dev={a['argument_bytes_per_device']:.3e}  "
              f"dominant={a['dominant']}  "
              f"bound={a['step_time_bound_s']:.3e}s  "
              f"model_bound={a['model_bound_s']:.3e}s")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--include-colbert", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--table", action="store_true",
                    help="print a markdown table of the records at the end")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.all:
        archs = list(configs.ASSIGNED)
        if args.include_colbert:
            archs.append("colbert")
        targets = [(a, s) for a in archs for s in configs.get(a).shapes]
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        entry = configs.get(args.arch)
        shapes = [args.shape] if args.shape else list(entry.shapes)
        targets = [(args.arch, s) for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures, paths = 0, []
    for multi_pod in meshes:
        name = mesh_name(multi_pod)
        for arch, shape in targets:
            path = cell_path(arch, shape, name, args.variant, args.out_dir)
            paths.append(path)
            if args.skip_done and os.path.exists(path):
                try:
                    with open(path) as f:
                        prev = json.load(f)
                except (OSError, ValueError):
                    prev = {}
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[{arch} x {shape} x {name}] cached, skipping")
                    continue
            rec = run_cell(arch, shape, multi_pod=multi_pod,
                           variant=args.variant)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            failures += rec["status"] == "error"
    if args.table:
        print(table(paths))
    raise SystemExit(1 if failures else 0)


def table(paths) -> str:
    """A markdown table of dry-run records, one row an (arch, mesh,
    variant unless baseline) and one column a shape: status (with the op
    that stopped a failed cell; "bound" where the upper-bound rule
    counted it), argument GB a device and whether they fit the card's 80
    GB, the plain path's counted TFLOP, the bound's seconds and its
    dominant term, and the collectives' GB a device where there are
    any."""
    by, width = {}, 0
    for path in paths:
        with open(path) as f:
            r = json.load(f)
        key = (r["arch"], r["mesh"]) + ((r["variant"],) if r.get(
            "variant", "baseline") != "baseline" else ())
        row = by.setdefault(key, [])
        a = r.get("analysis", {})
        arg = a.get("argument_bytes_per_device",
                    r.get("argument_bytes_per_device"))
        cell = f"`{r['shape']}` {r['status']}"
        if r.get("op"):
            cell += f" at `{r['op']}`"
        if a.get("counted_by", "shapes") != "shapes":
            cell += " (bound)"
        if arg is not None:
            cell += (f", {arg / 1e9:.3g} GB "
                     f"({'fits' if arg <= 80e9 else 'over'})")
        if a:
            cell += (f", {a['flops'] / 1e12:.3g} TFLOP, "
                     f"{a['step_time_bound_s']:.3g} s "
                     f"{a['dominant'][:-2]}")
            if a["collective_bytes_per_device"]:
                cell += (f", {a['collective_bytes_per_device'] / 1e9:.3g} GB "
                         f"of {a['collectives']} collectives a device")
        row.append(cell)
        width = max(width, len(row))
    head = "| arch, mesh[, variant] | " + " | ".join(
        f"shape {i + 1}" for i in range(width)) + " |"
    rows = [head, "|" + " --- |" * (width + 1)]
    rows += [f"| {', '.join(key)} | " + " | ".join(cells) + " |"
             for key, cells in by.items()]
    return "\n".join(rows)


if __name__ == "__main__":
    main()
