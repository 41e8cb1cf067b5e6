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

:func:`run_pruning_backends` and :func:`run_ragged_pruning` are the
counterparts of ``bench_speedup.py``'s pruning-throughput sweeps: docs/s
of Alg. 1 per backend on full-length docs, and flat padding against the
length-bucketed pipeline on a ragged corpus.  ``--scale bench`` takes
the reference's shapes (4 docs x 48 tokens; ragged 16 docs of 4-48
tokens; 2,048 samples), ``--scale full`` the main path's (1,024 docs x
180 tokens, dim 128, 2,048 samples; ragged 1,024 docs of 4-180 tokens).
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


# backend name -> pruning_order_batch keywords (the reference's rows)
BACKEND_RUNS = {
    "reference": dict(backend="reference"),
    "fused": dict(backend="fused"),
    "shortlist": dict(shortlist=True),
    "shortlist_topk": dict(backend="shortlist_topk"),
    "bucketed_shortlist": dict(shortlist=True, bucketed=True),
}
FULL_SWEEP = dict(n_docs=1024, m=180, dim=128, n_samples=2048)


def run_pruning_backends(n_docs: int = 4, m: int = 48, dim: int = 128,
                         n_samples: int = 2048, *, device=None,
                         backends=tuple(BACKEND_RUNS)):
    """End-to-end pruning throughput per backend on full-length docs
    (one timed call after a warm-up): ``{backend: docs_per_s, "shape":
    {...}}``.  ``bucketed_shortlist`` is the corpus pipeline, a pass-
    through on this full-length corpus (it prices the pipeline's
    overhead; :func:`run_ragged_pruning` shows raggedness)."""
    device = resolve_device(device)
    d, masks, samples = data(n_docs, m, dim, n_samples, device)
    out = {}
    for name in backends:
        kw = BACKEND_RUNS[name]
        t, _ = common.timeit(
            lambda kw=kw: voronoi.pruning_order_batch(d, masks, samples,
                                                      **kw)[0],
            repeat=1, device=device)
        out[name] = n_docs / t
    out["shape"] = dict(n_docs=n_docs, m=m, dim=dim, n_samples=n_samples,
                        device=str(device))
    return out


def run_ragged_pruning(n_docs: int = 16, m: int = 48, dim: int = 128,
                       n_samples: int = 2048, seed: int = 3, *,
                       device=None):
    """Ragged-corpus pruning on the dense shortlist path: flat padding
    to ``m`` against the length-bucketed pipeline.  Doc lengths are
    uniform in [4, m] (a generator seeded with ``seed`` draws the docs,
    then the lengths).  Returns docs/s of both and the speedup."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn((n_docs, m, dim), generator=g, device=device)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True) * 0.8
    n_real = torch.randint(4, m + 1, (n_docs,), generator=g, device=device)
    masks = torch.arange(m, device=device)[None, :] < n_real[:, None]
    samples = common.samples(n_samples, dim, 7, device)
    t_flat, _ = common.timeit(
        lambda: voronoi.pruning_order_batch(d, masks, samples,
                                            shortlist=True)[0],
        repeat=1, device=device)
    t_buck, _ = common.timeit(
        lambda: voronoi.pruning_order_batch(d, masks, samples,
                                            shortlist=True,
                                            bucketed=True)[0],
        repeat=1, device=device)
    return {
        "flat": n_docs / t_flat,
        "bucketed": n_docs / t_buck,
        "speedup_bucketed_over_flat": t_flat / t_buck,
        "shape": dict(n_docs=n_docs, m=m, dim=dim, n_samples=n_samples,
                      mean_len=float(n_real.float().mean()),
                      device=str(device)),
    }


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


def report_backends(bk):
    sh = bk["shape"]
    for name in BACKEND_RUNS:
        if name in bk:
            common.csv_line(
                f"speedup/pruning_backend_{name}", 1e6 / bk[name],
                f"docs_per_s={bk[name]:.2f} ({sh['n_docs']} docs x "
                f"{sh['m']} tok, {sh['n_samples']} samples, {sh['device']})")


def ragged_claims(rg):
    sp = rg["speedup_bucketed_over_flat"]
    return {"bucketed_pipeline_beats_flat_on_ragged": (
        sp > 1.0, f";speedup={sp:.2f}x;flat_docs_per_s={rg['flat']:.2f};"
                  f"bucketed_docs_per_s={rg['bucketed']:.2f} (mean_len="
                  f"{rg['shape']['mean_len']:.1f}/{rg['shape']['m']}, "
                  f"{rg['shape']['n_docs']} docs, {rg['shape']['device']})")}


def report_ragged(rg):
    for claim, (ok, detail) in ragged_claims(rg).items():
        common.csv_line(f"speedup/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    bench = scale is common.BENCH
    report(run(n_docs=8 if bench else 1024, device=device))
    report_backends(run_pruning_backends(
        **({} if bench else FULL_SWEEP), device=device))
    report_ragged(run_ragged_pruning(
        **({} if bench else FULL_SWEEP), device=device))


if __name__ == "__main__":
    main()
