"""End-to-end training on the PyTorch port: train a ColBERT encoder from
scratch on the planted-relevance token corpus with the paper's doc-sim
regularizer, with checkpoint/restart, then encode, prune and serve.

The counterpart of ``examples/train_colbert.py``, step for step:
``repro_torch.launch.train.run("colbert", ...)`` trains (a CPU-scale
encoder by default; ``--full`` the paper's 12L/768 configuration, the
same code path), checkpointing every 50 steps into ``--ckpt-dir`` and
resuming from its latest checkpoint (kill and rerun to see it); the
trained encoder then embeds a token corpus, MRR@10 is measured by exact
MaxSim, and again after Voronoi pruning to 50 %.

On the card the scoring runs the MaxSim kernel and the pruning the
shortlist top-k kernel (training runs the plain path: no kernel has a
backward); ``--device cpu`` runs the plain versions.  Random draws come
from ``torch.Generator``s seeded here (and the trainer's own seed).

Run:  PYTHONPATH=src python examples/train_colbert_torch.py [--steps 300]
      [--full] [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from repro_torch import configs
from repro_torch.core import backend as backend_lib
from repro_torch.core import metrics, voronoi
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.launch import train as train_lib
from repro_torch.serve.retrieval import TokenIndex, maxsim_scores


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="train_colbert_torch")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="use the paper-scale 12L/768 config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "colbert_example_ckpt_torch"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = backend_lib.resolve_device(None if args.device == "cuda"
                                     else args.device)

    preset = "full" if args.full else "smoke"
    out = train_lib.run("colbert", preset=preset, steps=args.steps,
                           batch=8, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                           lr=2e-3, device=dev)
    print(f"trained to loss {out['final_loss']:.4f} in {out['wall_s']:.1f}s"
          f" (resumed from step {out['start']})")

    entry = configs.get("colbert")
    cfg = entry.config if args.full else entry.smoke
    model = out["state"]["params"].eval()
    corpus = synthetic.token_corpus(0, n_docs=256, n_q=64, vocab=cfg.vocab,
                                    m=cfg.doc_len, l=cfg.query_len)
    rel = torch.as_tensor(corpus.rel, device=dev)
    with torch.no_grad():
        d_emb, d_mask = model.encode_docs(
            torch.as_tensor(corpus.doc_ids, device=dev))
        q_emb, q_mask = model.encode_queries(
            torch.as_tensor(corpus.q_ids, device=dev))
    d_emb, q_emb = d_emb.float(), q_emb.float()
    index = TokenIndex.build(d_emb, d_mask)

    scores = maxsim_scores(index, q_emb, q_mask)
    mrr = float(metrics.mrr_at_k(scores, rel, 10))
    print(f"unpruned MRR@10 = {mrr:.4f}  ({index.storage()['tokens_kept']} "
          f"token vectors)")

    samples = sample_sphere(torch.Generator(dev).manual_seed(1), 2048,
                            cfg.out_dim)
    ranks, errs, _ = voronoi.pruning_order_batch(d_emb, d_mask, samples)
    keep = voronoi.global_keep_masks(ranks, errs, d_mask, 0.5)
    pruned = index.with_keep(keep)
    scores_p = maxsim_scores(pruned, q_emb, q_mask)
    mrr_p = float(metrics.mrr_at_k(scores_p, rel, 10))
    st = pruned.storage()
    print(f"VP @{st['remain_pct']:.0f}% MRR@10 = {mrr_p:.4f} "
          f"({st['tokens_kept']} token vectors, "
          f"{100 * mrr_p / max(mrr, 1e-9):.1f}% of unpruned)")
    return {"device": str(dev), "final_loss": out["final_loss"],
            "start": out["start"], "wall_s": out["wall_s"],
            "mrr10": mrr, "mrr10_pruned": mrr_p,
            "remain_pct": st["remain_pct"], "scores": scores,
            "scores_pruned": scores_p, "samples": samples, "ranks": ranks,
            "errs": errs, "keep": keep, "d_emb": d_emb, "d_mask": d_mask,
            "q_emb": q_emb, "q_mask": q_mask, "rel": rel}


if __name__ == "__main__":
    main()
