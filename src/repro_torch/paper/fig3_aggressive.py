"""Paper Fig. 3: degradation under aggressive pruning, VP against
LP-pruning and random, down to ~6 % of the tokens.

Counterpart of ``benchmarks/bench_fig3_aggressive.py`` (ball encoder).
The LP margins are computed once; each budget cuts them at its own
quantile (the paper's theta sweep).  Claim: VP degrades gracefully at
the extreme budgets where LP-pruning collapses.
"""

from __future__ import annotations

import torch

from repro_torch.core import lp
from repro_torch.paper import common
from repro_torch.serve.retrieval import TokenIndex

BUDGETS = (0.75, 0.5, 0.25, 0.12, 0.06)
LP_ITERS = 60


def encode(ball, scale: common.Scale = common.BENCH):
    return common.encode_all(ball, common.corpus(scale))


def margins(enc, lp_iters: int = LP_ITERS):
    return lp.dominance_margin(enc.d_emb, enc.d_mask, n_iters=lp_iters)


def rows(enc, lp_iters: int = LP_ITERS):
    """[(budget, vp ndcg10, lp ndcg10, random ndcg10, vp remain,
    lp remain, random remain)]."""
    d_emb, d_mask = enc.d_emb, enc.d_mask
    index = TokenIndex.build(d_emb, d_mask)
    marg = margins(enc, lp_iters)
    flat = marg[d_mask]
    first = torch.cumsum(d_mask.int(), -1) == 1          # min 1 token
    out = []
    for b in BUDGETS:
        keep_vp = common.vp_keep(d_emb, d_mask, b)
        theta = common.quantile(flat, 1 - b)
        keep_lp = (d_mask & (marg >= theta)) | first
        keep_rnd = common.random_keep(d_mask, b, 1)
        q = [common.quality(index.with_keep(k), enc.q_emb, enc.q_mask,
                            enc.rel) for k in (keep_vp, keep_lp, keep_rnd)]
        out.append((b,) + tuple(x[1] for x in q) + tuple(x[2] for x in q))
    return out


def run(*, scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    ball, _ = common.train_encoder(scale.ball, reg="sim", alpha=0.1,
                                   scale=scale, device=device,
                                   cache_dir=cache_dir)
    return rows(encode(ball, scale))


def claims(rows_):
    extreme = [r for r in rows_ if r[0] <= 0.12]
    ok = all(r[1] >= r[2] - 1e-6 for r in extreme)
    gap = min(r[1] - r[2] for r in extreme)
    return {"vp_graceful_at_extreme": (ok, f";min_gap_at_le12pct={gap:.4f}")}


def report(rows_):
    for b, vp, lpp, rnd, r_vp, r_lp, r_rnd in rows_:
        common.csv_line(f"fig3/remain_{int(b * 100)}pct", 0.0,
                        f"vp_ndcg={vp:.4f};lpp_ndcg={lpp:.4f};"
                        f"random_ndcg={rnd:.4f};remain_pct_vp={r_vp:.1f};"
                        f"remain_pct_lpp={r_lp:.1f};"
                        f"remain_pct_random={r_rnd:.1f}")
    for claim, (ok, detail) in claims(rows_).items():
        common.csv_line(f"fig3/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
