"""Paper Table 2: ablation of pruning design choices at a 50 % budget.

Counterpart of ``benchmarks/bench_table2_ablation.py``.  Rows: VP (full,
global, iterative, step 1) / beam 3 / local (per-document) pruning /
step size 3 / non-iterative.  Claims: iterative beats non-iterative;
global >= local; step 3 is faster; beam gives no gain.

As in the reference, the beam row keeps ``doc_len // 2`` tokens in
every document (its per-document budget goes unused), so its remain %
is not the other rows' 50 %.  On the card the full, local and beam
orders run ``shortlist_topk`` (``maxsim_topk``) and step 3 runs
``fused`` (``maxsim_top2``); the beam search and the one-shot errors
are plain torch, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.core import voronoi
from repro_torch.paper import common
from repro_torch.serve.retrieval import TokenIndex

N_SAMPLES = 2048


def encode(sphere, scale: common.Scale = common.BENCH):
    return common.encode_all(sphere, common.corpus(scale))


def rows(enc, budget: float = 0.5, n_samples: int = N_SAMPLES):
    """[(name, seconds, mrr10, ndcg10, remain_pct)]."""
    d_emb, d_mask = enc.d_emb, enc.d_mask
    dev = d_emb.device
    doc_len = d_mask.shape[1]
    index = TokenIndex.build(d_emb, d_mask)
    samples = common.samples(n_samples, d_emb.shape[-1], 1, dev)
    out = []

    def add(name, t, keep):
        out.append((name, t) + common.quality(
            index.with_keep(keep), enc.q_emb, enc.q_mask, enc.rel))

    def vp_full():
        ranks, errs, _ = voronoi.pruning_order_batch(d_emb, d_mask, samples)
        return voronoi.global_keep_masks(ranks, errs, d_mask, budget)

    add("voronoi_full", *common.timeit(vp_full, repeat=1, device=dev))
    n_keep = torch.ceil(torch.tensor(budget, device=dev)
                        * d_mask.sum(1).float()).to(torch.int32)

    def vp_beam():
        return voronoi.beam_pruning_order(d_emb, d_mask, samples, beam=3,
                                          target=doc_len // 2)[0]

    add("beam_3", *common.timeit(vp_beam, repeat=1, device=dev))

    def vp_local():
        ranks, _, _ = voronoi.pruning_order_batch(d_emb, d_mask, samples)
        return voronoi.keep_mask_from_order(ranks, d_mask, n_keep)

    add("local_pruning", *common.timeit(vp_local, repeat=1, device=dev))

    def vp_step3():
        ranks, errs, _ = voronoi.pruning_order_batch(d_emb, d_mask, samples,
                                                     step_size=3)
        return voronoi.global_keep_masks(ranks, errs, d_mask, budget)

    add("step_size_3", *common.timeit(vp_step3, repeat=1, device=dev))

    def vp_oneshot():
        errs = voronoi.estimate_errors(d_emb, d_mask, samples)
        order = torch.sort(torch.where(d_mask, errs, torch.inf), dim=-1,
                           stable=True).indices
        rank = torch.argsort(order, dim=-1)
        n_prune = (d_mask.sum(-1) - n_keep).clamp_min(0)
        return d_mask & (rank >= n_prune[:, None])

    add("non_iterative", *common.timeit(vp_oneshot, repeat=1, device=dev))
    return out


def run(budget: float = 0.5, *, scale: common.Scale = common.BENCH,
        device=None, cache_dir=None):
    sphere, _ = common.train_encoder(scale.sphere, scale=scale,
                                     device=device, cache_dir=cache_dir)
    return rows(encode(sphere, scale), budget)


def claims(rows_):
    by = {r[0]: r for r in rows_}
    full, s3 = by["voronoi_full"], by["step_size_3"]
    return {
        "iterative_beats_noniterative":
            (full[2] >= by["non_iterative"][2], ""),
        "global_ge_local": (full[2] >= by["local_pruning"][2] - 0.005, ""),
        "step3_faster": (s3[1] < full[1],
                         f";speedup={full[1] / max(s3[1], 1e-9):.2f}"),
        "beam_no_gain": (by["beam_3"][2] <= full[2] + 0.005, ""),
    }


def report(rows_):
    for name, t, mrr, ndcg, remain in rows_:
        common.csv_line(f"table2/{name}", t * 1e6,
                        f"mrr10={mrr:.4f};ndcg10={ndcg:.4f};"
                        f"remain_pct={remain:.1f}")
    for claim, (ok, detail) in claims(rows_).items():
        common.csv_line(f"table2/CLAIM_{claim}", 0.0, f"holds={ok}{detail}")


def main(scale: common.Scale = common.BENCH, device=None, cache_dir=None):
    report(run(scale=scale, device=device, cache_dir=cache_dir))


if __name__ == "__main__":
    main()
