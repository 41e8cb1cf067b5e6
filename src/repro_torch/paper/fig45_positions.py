"""Paper Figs. 4 and 5: token-position analyses.

Counterpart of ``benchmarks/bench_fig45_positions.py``.  Fig. 4: per
position bin, how often a token is the best match of a sampled query
(its cell's share) and its mean Eq. 8 error; the paper's point is that
the error is much less position-skewed than the wins.  Fig. 5: the
distribution of the normalized pruning rank by position percentile
(lower = pruned earlier).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import voronoi
from repro_torch.paper import common

N_SAMPLES = 2048


def encode(sphere, scale: common.Scale = common.BENCH):
    return common.encode_all(sphere, common.corpus(scale))


def rows(enc, n_samples: int = N_SAMPLES):
    """[(bin, win_freq, mean_err, rank_median, rank_q25, rank_q75)]."""
    d_emb, d_mask = enc.d_emb, enc.d_mask
    B, m = d_mask.shape
    samples = common.samples(n_samples, d_emb.shape[-1], 3, d_emb.device)
    st = voronoi.assign_cells(d_emb, d_mask, samples)
    wins = torch.zeros((B, m), device=d_emb.device).scatter_add_(
        1, st.bi.long(), torch.ones_like(st.best)) / n_samples
    errs = torch.where(d_mask, voronoi.token_errors(st, d_mask, n_samples),
                       0.0)
    ranks, _, _ = voronoi.pruning_order_batch(d_emb, d_mask, samples)

    n_real = d_mask.sum(1)
    span = (n_real[:, None] - 1).clamp_min(1)
    pos_pct = torch.arange(m, device=d_emb.device)[None, :] / span
    rank_pct = ranks / span
    mask = d_mask.cpu().numpy()
    pp = pos_pct.cpu().numpy()[mask]
    ww = wins.cpu().numpy()[mask]
    ee = errs.cpu().numpy()[mask]
    rr = np.clip(rank_pct.cpu().numpy()[mask], 0, 1)
    bins = np.linspace(0, 1.0001, 6)
    out = []
    for i in range(5):
        sel = (pp >= bins[i]) & (pp < bins[i + 1])
        out.append((f"pos_{i * 20}_{(i + 1) * 20}", float(ww[sel].mean()),
                    float(ee[sel].mean()), float(np.median(rr[sel])),
                    float(np.quantile(rr[sel], 0.25)),
                    float(np.quantile(rr[sel], 0.75))))
    return out


def run(*, scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    sphere, _ = common.train_encoder(scale.sphere, scale=scale,
                                     device=device, cache_dir=cache_dir)
    return rows(encode(sphere, scale))


def claims(rows_):
    wins = [r[1] for r in rows_]
    errs = [r[2] for r in rows_]
    # skew = the first bin's share relative to a uniform share
    win_skew = wins[0] / max(sum(wins) / len(wins), 1e-9)
    err_skew = errs[0] / max(sum(errs) / len(errs), 1e-9)
    return {"mean_error_less_skewed_than_wins":
            (abs(err_skew - 1) <= abs(win_skew - 1) + 0.05,
             f";win_skew={win_skew:.3f};err_skew={err_skew:.3f}")}


def report(rows_):
    for name, win, err, med, q25, q75 in rows_:
        common.csv_line(f"fig45/{name}", 0.0,
                        f"win_freq={win:.5f};mean_err={err:.6f};"
                        f"rank_median={med:.3f};rank_iqr={q25:.3f}-{q75:.3f}")
    for claim, (ok, detail) in claims(rows_).items():
        common.csv_line(f"fig45/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
