"""Quickstart on the PyTorch port: Voronoi Pruning on a planted-relevance
embedding corpus.

The counterpart of ``examples/quickstart.py``, step for step and at its
sizes, on ``repro_torch``: no training needed — documents are bags of
token *vectors* with planted topical structure:

  1. build a token-level index,
  2. estimate per-token Voronoi-cell pruning errors (Eq. 8),
  3. iteratively prune to a 50% budget, corpus-wide (Alg. 1 + global),
  4. compare retrieval quality against random and first-k pruning at
     equal budget.

On the card the pruning runs the shortlist top-k kernel and the scoring
the MaxSim kernel; ``--device cpu`` runs their plain PyTorch versions.
Random draws come from ``torch.Generator``s seeded here.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import baselines, metrics, voronoi
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.serve.retrieval import TokenIndex, maxsim_scores


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="quickstart_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = backend_lib.resolve_device(None if args.device == "cuda"
                                     else args.device)
    print("== Voronoi Pruning quickstart (PyTorch port) ==")
    c = synthetic.embedding_corpus(seed=0, n_docs=192, n_q=48, dim=24,
                                   m=32, stop_frac=0.5, noise=0.5,
                                   n_topics=24)
    d_embs = torch.as_tensor(c.d_embs, device=dev)
    d_masks = torch.as_tensor(c.d_masks, device=dev)
    q_embs = torch.as_tensor(c.q_embs, device=dev)
    rel = torch.as_tensor(c.rel, device=dev)
    gains = torch.as_tensor(c.gains, device=dev)
    index = TokenIndex.build(d_embs, d_masks)
    print(f"corpus: {index.storage()}")

    # Monte-Carlo sample the query sphere (Eq. 8)
    samples = sample_sphere(torch.Generator(dev).manual_seed(1), 4096, 24)

    # one document's error profile, for intuition
    errs = voronoi.estimate_errors(d_embs[0], d_masks[0], samples)
    real = errs[d_masks[0]]
    print(f"doc0 token errors: min={float(real.min()):.5f} "
          f"median={float(real.median()):.5f} "
          f"max={float(real.max()):.5f}")

    # corpus-level iterative pruning to 50%
    ranks, errs_all, _ = voronoi.pruning_order_batch(d_embs, d_masks,
                                                     samples)
    keep = voronoi.global_keep_masks(ranks, errs_all, d_masks, 0.5)
    pruned = index.with_keep(keep)
    print(f"pruned: {pruned.storage()}")

    def quality(idx, name):
        scores = maxsim_scores(idx, q_embs)
        mrr = float(metrics.mrr_at_k(scores, rel, 10))
        ndcg = float(metrics.ndcg_at_k(scores, gains, 10))
        print(f"{name:>16}: MRR@10={mrr:.4f}  nDCG@10={ndcg:.4f}")
        return {"mrr10": mrr, "ndcg10": ndcg, "scores": scores}

    full = quality(index, "unpruned")
    vp = quality(pruned, "voronoi @50%")
    keep_rnd = baselines.random_prune(torch.Generator(dev).manual_seed(2),
                                      d_masks, 0.5)
    rnd = quality(index.with_keep(keep_rnd), "random @50%")
    keep_fk = baselines.first_k(d_masks, 0.5)
    fk = quality(index.with_keep(keep_fk), "first-k @50%")

    m_full, m_vp = full["ndcg10"], vp["ndcg10"]
    m_rnd, m_fk = rnd["ndcg10"], fk["ndcg10"]
    print(f"\nVP keeps {100 * m_vp / m_full:.1f}% of unpruned nDCG at half "
          f"the storage (random keeps {100 * m_rnd / m_full:.1f}%, "
          f"first-k {100 * m_fk / m_full:.1f}%).")
    assert m_vp >= m_rnd, "Voronoi pruning should beat random pruning"
    assert m_vp >= m_fk, "Voronoi pruning should beat first-k pruning"
    print("OK")
    return {"device": str(dev), "d_embs": d_embs, "d_masks": d_masks,
            "q_embs": q_embs, "pruned": pruned,
            "unpruned": full, "voronoi": vp,
            "random": rnd, "first_k": fk, "samples": samples,
            "ranks": ranks, "errs": errs_all, "keep": keep,
            "remain_pct": pruned.storage()["remain_pct"]}


if __name__ == "__main__":
    main()
