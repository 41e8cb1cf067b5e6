"""Paper Fig. 1: geometry diagnostics of query token embeddings.

Counterpart of ``benchmarks/bench_fig1_geometry.py``: (a) one
dimension's marginal against the uniform-sphere density
(1 - x^2)^{(n-3)/2}; (b) the pairwise correlations between dimensions.
Claim: the encoder's query embeddings are near-uniform enough on
S^{n-1} that uniform Monte-Carlo sampling is a sound estimator basis.
"""

from __future__ import annotations

from repro_torch.core.sampling import embedding_uniformity_report
from repro_torch.paper import common


def encode(sphere, scale: common.Scale = common.BENCH):
    return common.encode_all(sphere, common.corpus(scale))


def rows(enc):
    """(report, marginal L1 distance)."""
    rep = embedding_uniformity_report(
        enc.q_emb.reshape(-1, enc.q_emb.shape[-1]))
    l1 = float((rep["observed_density"]
                - rep["expected_density"]).abs().mean())
    return rep, l1


def run(*, scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    sphere, _ = common.train_encoder(scale.sphere, scale=scale,
                                     device=device, cache_dir=cache_dir)
    return rows(encode(sphere, scale))


def claims(out):
    rep, _ = out
    return {"weak_dim_correlations":
            (float(rep["mean_abs_off_corr"]) < 0.25, "")}


def report(out):
    rep, l1 = out
    common.csv_line(
        "fig1/query_embedding_uniformity", 0.0,
        f"marginal_l1_dist={l1:.4f};"
        f"mean_abs_offdiag_corr={float(rep['mean_abs_off_corr']):.4f};"
        f"max_abs_offdiag_corr={float(rep['max_abs_off_corr']):.4f}")
    for claim, (ok, detail) in claims(out).items():
        common.csv_line(f"fig1/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
