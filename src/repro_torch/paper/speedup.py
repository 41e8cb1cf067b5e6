"""Paper §6.1.1: Voronoi Pruning against LP-Pruning wall-clock (the
~120x claim; paper: 12.0 s against 1474.3 s per 10k docs with 10^4
samples).

Counterpart of ``benchmarks/bench_speedup.py::run``, at the paper's
geometry: 180-token documents, 128-d ball-geometry embeddings (norm
0.8), 10^4 samples, on the same device for both methods.  As in the
reference, VP runs the exact dense shortlist path (``shortlist=True``,
the ``shortlist`` backend: a cached score tensor rescanned by a stable
sort, no kernel), and LP is the batched subgradient ascent of
``core.lp``, not a simplex solver.  The data are random (a generator
seeded with 0, the samples with 7).
"""

from __future__ import annotations

import torch

from repro_torch.core import baselines, voronoi
from repro_torch.core.backend import resolve_device
from repro_torch.paper import common


def data(n_docs: int, m: int, dim: int, n_samples: int, device):
    g = torch.Generator(device=device).manual_seed(0)
    d = torch.randn((n_docs, m, dim), generator=g, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) * 0.8
    masks = torch.ones((n_docs, m), dtype=torch.bool, device=device)
    return d, masks, common.samples(n_samples, dim, 7, device)


def run(n_docs: int = 8, m: int = 180, dim: int = 128,
        n_samples: int = 10_000, lp_iters: int = 400, *, device=None):
    """(VP seconds, LP seconds, n_docs)."""
    device = resolve_device(device)
    d, masks, samples = data(n_docs, m, dim, n_samples, device)

    def vp():
        return voronoi.pruning_order_batch(d, masks, samples,
                                           shortlist=True)[0]

    t_vp, _ = common.timeit(vp, repeat=1, device=device)

    def lpp():
        return baselines.lp_prune(d, masks, theta=0.7, n_iters=lp_iters)

    t_lp, _ = common.timeit(lpp, repeat=1, device=device)
    return t_vp, t_lp, n_docs


def claims(out):
    t_vp, t_lp, _ = out
    ratio = t_lp / max(t_vp, 1e-9)
    return {"vp_order_of_magnitude_faster":
            (ratio > 5, f";ratio={ratio:.1f}x vs the batched LP ascent "
                        f"(paper reports 120x vs scipy simplex)")}


def report(out, lp_iters: int = 400):
    t_vp, t_lp, n = out
    common.csv_line("speedup/voronoi_pruning", t_vp / n * 1e6,
                    f"docs_per_s={n / t_vp:.2f};s_per_10k_docs="
                    f"{t_vp / n * 1e4:.2f} (180-tok docs, 10k samples)")
    common.csv_line("speedup/lp_pruning", t_lp / n * 1e6,
                    f"docs_per_s={n / t_lp:.2f};s_per_10k_docs="
                    f"{t_lp / n * 1e4:.2f} ({lp_iters}-iter maximin ascent)")
    for claim, (ok, detail) in claims(out).items():
        common.csv_line(f"speedup/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(n_docs=8 if scale is common.BENCH else 1024, device=device))


if __name__ == "__main__":
    main()
