"""Paper Table 3: zero-shot (out-of-domain) pruning on BEIR-style shifted
domains.

Counterpart of ``benchmarks/bench_table3_beir.py``.  The sphere encoder
is trained on the in-domain corpus, then evaluated without retraining on
three domain-shifted token corpora (new topic geometry, more
stopwords).  Claim: VP beats the learning-free baselines (first-p /
random / IDF) on average at 75 % and 50 % budgets.
"""

from __future__ import annotations

import torch

from repro_torch.core import baselines
from repro_torch.data import synthetic
from repro_torch.paper import common
from repro_torch.serve.retrieval import TokenIndex

DOMAINS = {"D1": 11, "D2": 23, "D3": 37}
BUDGETS = (0.75, 0.5)


def shifted_corpus(seed, scale: common.Scale = common.BENCH):
    cfg = scale.sphere
    return synthetic.token_corpus(seed, n_docs=scale.domain_docs,
                                  n_q=scale.domain_q, vocab=cfg.vocab,
                                  m=cfg.doc_len, l=cfg.query_len,
                                  n_topics=12, stop_rate=0.5)


def encode(sphere, scale: common.Scale = common.BENCH):
    """{domain: Encoded}."""
    return {dom: common.encode_all(sphere, shifted_corpus(seed, scale))
            for dom, seed in DOMAINS.items()}


def rows(encs):
    """[(domain, budget, name, ndcg10, mrr10, remain_pct)]."""
    out = []
    for dom, enc in encs.items():
        c, d_emb, d_mask = enc.corpus, enc.d_emb, enc.d_mask
        dev = d_emb.device
        index = TokenIndex.build(d_emb, d_mask)
        ids = torch.as_tensor(c.doc_ids, device=dev)
        idf = torch.as_tensor(c.idf, device=dev)

        def add(budget, name, keep):
            mrr, ndcg, remain = common.quality(
                index.with_keep(keep), enc.q_emb, enc.q_mask, enc.rel)
            out.append((dom, budget, name, ndcg, mrr, remain))

        for budget in BUDGETS:
            add(budget, "unpruned", d_mask)
            add(budget, "first_p", baselines.first_k(d_mask, budget))
            add(budget, "random", common.random_keep(d_mask, budget, 0))
            add(budget, "idf", baselines.idf_prune(ids, d_mask, idf, budget))
            add(budget, "vp", common.vp_keep(d_emb, d_mask, budget))
    return out


def run(*, scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    sphere, _ = common.train_encoder(scale.sphere, scale=scale,
                                     device=device, cache_dir=cache_dir)
    return rows(encode(sphere, scale))


def _avg(rows_, budget, name):
    vals = [r[3] for r in rows_ if r[1] == budget and r[2] == name]
    return sum(vals) / len(vals)


def claims(rows_):
    out = {}
    for budget in BUDGETS:
        a = {n: _avg(rows_, budget, n) for n in ("vp", "first_p", "idf",
                                                 "random")}
        ok = all(a["vp"] >= a[n] - 1e-6 for n in ("first_p", "random",
                                                   "idf"))
        out[f"vp_best_zeroshot_{int(budget * 100)}"] = (
            ok, f";vp={a['vp']:.4f};first_p={a['first_p']:.4f};"
                f"idf={a['idf']:.4f};random={a['random']:.4f}")
    return out


def report(rows_):
    for dom, budget, name, ndcg, mrr, remain in rows_:
        common.csv_line(f"table3/{dom}/{int(budget * 100)}pct/{name}", 0.0,
                        f"ndcg10={ndcg:.4f};mrr10={mrr:.4f};"
                        f"remain_pct={remain:.1f}")
    for claim, (ok, detail) in claims(rows_).items():
        common.csv_line(f"table3/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
