"""Paper Table 1: in-domain retrieval under pruning strategies.

Counterpart of ``benchmarks/bench_table1_indomain.py``.  Learning-free
rows (sphere encoder, post-hoc pruning at 50 %): unpruned / first-p /
IDF / stopwords / attention-score / random / VP.  Learned rows (ball
encoder fine-tuned with the doc-sim regularizer): Norm-Pruning /
LP-Pruning / VP.  Claim: VP is the best learning-free method at equal
budget and matches the dominance-based learned methods on the
regularized encoder.

As in the reference, the LP row's ``theta`` is the norm quantile that
the Norm row uses (a 50 % norm budget), not a margin threshold.
"""

from __future__ import annotations

import torch

from repro_torch.core import baselines
from repro_torch.paper import common
from repro_torch.serve.retrieval import TokenIndex

LP_ITERS = 60


def encode(sphere, ball, scale: common.Scale = common.BENCH):
    """The in-domain corpus through both encoders, with the sphere
    encoder's layer-0 received attention: (enc, enc_ball, recv)."""
    c = common.corpus(scale)
    dev = next(sphere.parameters()).device
    with torch.no_grad():
        d_emb, d_mask, recv = sphere.encode_docs_with_attention(
            torch.as_tensor(c.doc_ids, device=dev))
        q_emb, q_mask = sphere.encode_queries(torch.as_tensor(c.q_ids,
                                                              device=dev))
    enc = common.Encoded(c, d_emb.float(), d_mask, q_emb.float(), q_mask)
    return enc, common.encode_all(ball, c), recv


def rows(enc, enc_ball, recv, budget: float = 0.5,
         lp_iters: int = LP_ITERS):
    """[(name, us, mrr10, ndcg10, remain_pct)]."""
    c, d_emb, d_mask = enc.corpus, enc.d_emb, enc.d_mask
    dev = d_emb.device
    rel = enc.rel
    index = TokenIndex.build(d_emb, d_mask)
    out = []

    def add(name, idx, keep, q_emb, q_mask, t_us=0.0):
        out.append((name, t_us) + common.quality(idx.with_keep(keep), q_emb,
                                                 q_mask, rel))

    ids = torch.as_tensor(c.doc_ids, device=dev)
    q, qm = enc.q_emb, enc.q_mask
    add("unpruned", index, d_mask, q, qm)
    add("first_p", index, baselines.first_k(d_mask, budget), q, qm)
    add("idf", index, baselines.idf_prune(
        ids, d_mask, torch.as_tensor(c.idf, device=dev), budget), q, qm)
    add("stopwords", index, baselines.stopword_prune(
        ids, d_mask, torch.as_tensor(c.stopword_set, device=dev)), q, qm)
    add("attention_score", index,
        baselines.attention_prune(recv, d_mask, budget), q, qm)
    add("random", index, common.random_keep(d_mask, budget, 0), q, qm)
    t, keep = common.timeit(lambda: common.vp_keep(d_emb, d_mask, budget),
                            repeat=1, device=dev)
    add("voronoi_pruning", index, keep, q, qm, t * 1e6)

    # learned / regularized section (ball geometry)
    db, mb = enc_ball.d_emb, enc_ball.d_mask
    qb, qmb = enc_ball.q_emb, enc_ball.q_mask
    index_b = TokenIndex.build(db, mb)
    add("ball_unpruned", index_b, mb, qb, qmb)
    norms = torch.linalg.vector_norm(db, dim=-1)
    theta = common.quantile(norms[mb], 1 - 0.5)  # 50 % norm budget
    add("norm_pruning", index_b, baselines.norm_prune(db, mb, theta=theta),
        qb, qmb)
    t, keep = common.timeit(lambda: baselines.lp_prune(
        db, mb, theta=theta, n_iters=lp_iters), repeat=1, device=dev)
    add("lp_pruning", index_b, keep, qb, qmb, t * 1e6)
    t, keep = common.timeit(lambda: common.vp_keep(db, mb, 0.5), repeat=1,
                            device=dev)
    add("voronoi_pruning_ball", index_b, keep, qb, qmb, t * 1e6)
    return out


def run(budget: float = 0.5, *, scale: common.Scale = common.BENCH,
        device=None, cache_dir=None):
    sphere, _ = common.train_encoder(scale.sphere, scale=scale,
                                     device=device, cache_dir=cache_dir)
    ball, _ = common.train_encoder(scale.ball, reg="sim", alpha=0.1,
                                   scale=scale, device=device,
                                   cache_dir=cache_dir)
    return rows(*encode(sphere, ball, scale), budget)


def claims(rows_):
    """{claim: (holds, detail)}."""
    vp = next(r for r in rows_ if r[0] == "voronoi_pruning")
    free = [r for r in rows_ if r[0] in
            ("first_p", "idf", "stopwords", "attention_score", "random")]
    return {"vp_best_learning_free":
            (all(vp[2] >= r[2] - 1e-6 for r in free), "")}


def report(rows_):
    base = next(r for r in rows_ if r[0] == "unpruned")
    for name, t_us, mrr, ndcg, remain in rows_:
        common.csv_line(
            f"table1/{name}", t_us,
            f"mrr10={mrr:.4f};ndcg10={ndcg:.4f};remain_pct={remain:.1f};"
            f"rel_to_unpruned={mrr / max(base[2], 1e-9):.3f}")
    for claim, (ok, detail) in claims(rows_).items():
        common.csv_line(f"table1/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
