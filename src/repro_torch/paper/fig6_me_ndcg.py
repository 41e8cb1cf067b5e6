"""Paper Fig. 6 / §6.4: Mean Error is a linear proxy for nDCG@10.

Counterpart of ``benchmarks/bench_fig6_me_ndcg.py``: sweep the pruning
budget, record (ME, nDCG@10), fit a line and report R^2.  Claim:
R^2 > 0.9 (paper: 0.99 on TREC-DL, 0.91 on TREC-COVID), so an ME
threshold can drive budget selection.
"""

from __future__ import annotations

from repro_torch.core import metrics, voronoi
from repro_torch.paper import common
from repro_torch.serve.retrieval import TokenIndex

BUDGETS = (0.9, 0.75, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1)
N_SAMPLES = 2048


def encode(sphere, scale: common.Scale = common.BENCH):
    return common.encode_all(sphere, common.corpus(scale))


def rows(enc, n_samples: int = N_SAMPLES):
    """([(budget, mean_error, ndcg10, mrr10, remain_pct)], fit)."""
    d_emb, d_mask = enc.d_emb, enc.d_mask
    index = TokenIndex.build(d_emb, d_mask)
    samples = common.samples(n_samples, d_emb.shape[-1], 5, d_emb.device)
    ranks, errs, _ = voronoi.pruning_order_batch(d_emb, d_mask, samples)
    out = []
    for b in BUDGETS:
        keep = voronoi.global_keep_masks(ranks, errs, d_mask, b)
        me = float(voronoi.mean_error_batch(d_emb, d_mask, keep,
                                            samples).mean())
        mrr, ndcg, remain = common.quality(index.with_keep(keep), enc.q_emb,
                                           enc.q_mask, enc.rel)
        out.append((b, me, ndcg, mrr, remain))
    fit = metrics.linear_fit([r[1] for r in out], [r[2] for r in out])
    return out, fit


def run(*, scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    sphere, _ = common.train_encoder(scale.sphere, scale=scale,
                                     device=device, cache_dir=cache_dir)
    return rows(encode(sphere, scale))


def claims(out):
    _, fit = out
    return {"linear_me_ndcg": (fit["r2"] > 0.9, "")}


def report(out):
    rows_, fit = out
    for b, me, nd, mrr, remain in rows_:
        common.csv_line(f"fig6/budget_{int(b * 100)}pct", 0.0,
                        f"mean_error={me:.5f};ndcg10={nd:.4f};"
                        f"mrr10={mrr:.4f};remain_pct={remain:.1f}")
    common.csv_line("fig6/linear_fit", 0.0,
                    f"slope={fit['slope']:.4f};"
                    f"intercept={fit['intercept']:.4f};r2={fit['r2']:.4f}")
    for claim, (ok, detail) in claims(out).items():
        common.csv_line(f"fig6/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
