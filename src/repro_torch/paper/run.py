"""The paper's tables and figures on the port: one module per driver.

    PYTHONPATH=src python -m repro_torch.paper.run table1 fig6 \\
        [--scale bench|full] [--device cuda|cpu] [--cache DIR]

Prints the reference harness's ``name,us_per_call,derived`` CSV and the
``CLAIM_*`` lines (counterpart of ``benchmarks/run.py`` for the paper's
drivers).  With no module named, runs them all.  ``--scale bench`` is
the reference's CPU-scaled encoders and corpus, ``full`` the full
``colbert`` config on a 4x corpus (``common.FULL``); ``--cache`` keeps
the trained encoders as checkpoints there.  ``speedup`` also runs the
pruning-backend and ragged-pruning sweeps (the main path's shapes at
``full``), ``kernels`` the kernel micro-benchmarks at the reference's
shapes.  Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.paper import (common, fig1_geometry, fig3_aggressive,
                               fig45_positions, fig6_me_ndcg, kernels,
                               speedup, table1_indomain, table2_ablation,
                               table3_beir)

MODULES = {
    "fig1": fig1_geometry,
    "table1": table1_indomain,
    "table2": table2_ablation,
    "table3": table3_beir,
    "fig3": fig3_aggressive,
    "fig45": fig45_positions,
    "fig6": fig6_me_ndcg,
    "speedup": speedup,
    "kernels": kernels,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper.run")
    ap.add_argument("modules", nargs="*", metavar="module",
                    help="any of: " + " ".join(MODULES))
    ap.add_argument("--scale", choices=["bench", "full"], default="bench")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--cache", default=None,
                    help="directory for the trained encoders' checkpoints")
    args = ap.parse_args(argv)
    unknown = set(args.modules) - set(MODULES)
    if unknown:
        ap.error(f"unknown module(s) {sorted(unknown)}; choose from "
                 f"{list(MODULES)}")
    scale = common.FULL if args.scale == "full" else common.BENCH
    print("name,us_per_call,derived", flush=True)
    failures = 0
    for name, mod in MODULES.items():
        if args.modules and name not in args.modules:
            continue
        try:
            mod.main(scale=scale, device=args.device, cache_dir=args.cache)
        except Exception as e:      # report the module, run the rest
            failures += 1
            print(f"{name}/HARNESS_ERROR,0.0,{type(e).__name__}:{e}",
                  flush=True)
            traceback.print_exc(file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
