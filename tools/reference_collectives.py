"""The reference's collective bytes a device, from its compiled HLO, for
every cell on one production mesh (or one cell).

    PYTHONPATH=src python tools/reference_collectives.py [--multi-pod] \
        [--arch ARCH [--shape SHAPE]] [--variant V]

The reference's own dry run builds its mesh with ``jax.make_mesh``,
whose Explicit axes its ``constrain`` refuses under recent JAX, so each
cell is built here with ``repro.launch.steps.build_cell`` on an
Auto-axis ``jax.sharding.Mesh`` over forced host devices, 16 x 16
(``data``, ``model``) or, with ``--multi-pod``, 2 x 16 x 16 (``pod``,
``data``, ``model``); compiled with its shardings and donation under the
mesh, as ``repro.launch.dryrun.run_cell`` does; and read by
``repro.launch.roofline.parse_hlo_costs``.  One JSON line a cell:
``[arch, shape, "ok", {collective: bytes a device}, compile s]`` or
``[arch, shape, "skip", reason]``.  These are the figures
``chip_smoke.py``'s ``REF_COLLECTIVES`` and ``PERF.md`` § 6 hold the
port's dry run (``python -m repro_torch.launch.dryrun``) against; a
cell compiles in 0.3-15 s on a CPU host.
"""

import argparse
import json
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="reference_collectives")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)
    grid = (2, 16, 16) if args.multi_pod else (16, 16)
    n = 1
    for d in grid:
        n *= d
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro import configs
    from repro.launch import roofline, steps

    names = ("pod", "data", "model") if args.multi_pod else ("data", "model")
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(grid), names)
    archs = [args.arch] if args.arch else list(configs.ASSIGNED) + ["colbert"]
    for arch in archs:
        shapes = ([args.shape] if args.shape
                  else list(configs.get(arch).shapes))
        for shape in shapes:
            t0 = time.perf_counter()
            cell = steps.build_cell(arch, shape, mesh,
                                    multi_pod=args.multi_pod,
                                    variant=args.variant)
            if cell.skip:
                print(json.dumps([arch, shape, "skip", str(cell.skip)]),
                      flush=True)
                continue
            with mesh:
                text = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                               out_shardings=cell.out_shardings,
                               donate_argnums=cell.donate).lower(
                    *cell.args).compile().as_text()
            br = roofline.parse_hlo_costs(text)["collective_breakdown"]
            print(json.dumps([arch, shape, "ok", br,
                              round(time.perf_counter() - t0, 1)]),
                  flush=True)


if __name__ == "__main__":
    main()
