"""Retrieval serving on the PyTorch port: build -> prune -> pack -> save ->
serve -> upsert / delete -> compact -> recover.

The counterpart of ``examples/prune_and_serve.py``, step for step and at
its sizes, on ``repro_torch``: the embedding-level corpus (no training
needed) through the whole index lifecycle — two-stage retrieval (pooled
first stage + exact MaxSim rerank), global Voronoi pruning at the
largest budget whose corpus Mean Error stays under a threshold (paper
§6.4), compaction into the packed serving artifact (and its int8 form),
a disk roundtrip under a ``tempfile`` directory, a batched
``RetrievalServer`` over the loaded artifact, and the live mutation
lifecycle on it: WAL-covered upsert + delete served from delta buckets
without restart, compaction into the next epoch (bit-identical
serving), and recovery of a torn write.

On the card the pruning runs the shortlist top-k kernel, the first stage
and the exact route the MaxSim kernels and the rerank its rerank kernel;
``--device cpu`` runs their plain PyTorch versions.  Random draws come
from ``torch.Generator``s seeded here.

Run:  PYTHONPATH=src python examples/prune_and_serve_torch.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import metrics, voronoi
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.serve import index_io, mutation
from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex, search,
                                         topk_search)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="prune_and_serve_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = backend_lib.resolve_device(None if args.device == "cuda"
                                     else args.device)
    c = synthetic.embedding_corpus(seed=3, n_docs=256, n_q=64, dim=24, m=40)
    d_embs = torch.as_tensor(c.d_embs, device=dev)
    d_masks = torch.as_tensor(c.d_masks, device=dev)
    q_embs = torch.as_tensor(c.q_embs, device=dev)
    rel = torch.as_tensor(c.rel, device=dev)
    index = TokenIndex.build(d_embs, d_masks)
    samples = sample_sphere(torch.Generator(dev).manual_seed(0), 4096, 24)
    ranks, errs, _ = voronoi.pruning_order_batch(d_embs, d_masks, samples)

    # ME-guided budget selection (paper §6.4): largest pruning ratio whose
    # corpus mean error stays under a threshold.
    target_me = 0.02
    budget = None
    for frac in (0.2, 0.3, 0.4, 0.5, 0.6, 0.8):
        keep = voronoi.global_keep_masks(ranks, errs, d_masks, frac)
        me = float(voronoi.mean_error_batch(d_embs, d_masks, keep,
                                            samples).mean())
        print(f"budget {frac:.0%}: mean error {me:.4f}")
        if me <= target_me:
            budget = frac
            break
    budget = budget or 0.8
    keep = voronoi.global_keep_masks(ranks, errs, d_masks, budget)
    pruned = index.with_keep(keep)
    st = pruned.storage()
    print(f"selected budget {budget:.0%} -> {st['remain_pct']:.1f}% tokens, "
          f"{st['bytes_fp32'] / 1e6:.2f} MB (from "
          f"{st['bytes_fp32_unpruned'] / 1e6:.2f} MB) — reported only")

    # Compact: the packed artifact actually holds ~budget x the bytes.
    # Multiple-of-4 capacities instead of pow2: a few more shapes, much
    # less padding at a mild budget.
    packed = pruned.pack(granularity=4, min_width=4)
    pst = packed.storage()
    print(f"packed: {pst['bytes_stored'] / 1e6:.2f} MB measured in "
          f"{pst['n_buckets']} buckets (cap_max {pst['cap_max']}, "
          f"{pst['padding_overhead']:.2f}x padding)")
    p8 = pruned.pack(granularity=4, min_width=4, compression="int8")
    int8_mb = p8.storage()["bytes_stored"] / 1e6
    print(f"packed int8: {int8_mb:.2f} MB")

    # quality check: two-stage search, masked vs packed parity
    _, _, full = search(packed, q_embs, k=10, n_first=64)
    mrr = float(metrics.mrr_at_k(full, rel, 10))
    _, _, full_m = search(pruned, q_embs, k=10, n_first=64)
    mrr_m = float(metrics.mrr_at_k(full_m, rel, 10))
    _, _, full0 = search(index, q_embs, k=10, n_first=64)
    mrr0 = float(metrics.mrr_at_k(full0, rel, 10))
    print(f"two-stage MRR@10: unpruned {mrr0:.4f} -> pruned {mrr_m:.4f} "
          f"(masked) == {mrr:.4f} (packed)")

    out = {"device": str(dev), "d_embs": d_embs, "d_masks": d_masks,
           "q_embs": q_embs, "packed": packed,
           "budget": budget, "samples": samples,
           "ranks": ranks, "errs": errs, "keep": keep,
           "remain_pct": st["remain_pct"],
           "packed_mb": pst["bytes_stored"] / 1e6, "int8_mb": int8_mb,
           "mrr10_unpruned": mrr0, "mrr10_pruned": mrr_m,
           "mrr10_packed": mrr, "full_packed": full, "batch_ms": {}}
    # persistence roundtrip: serve the artifact a pruning job would ship
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "index")
        index_io.save_index(path, packed)
        loaded = index_io.load_index(path, device=dev)
        print(f"saved + loaded packed index "
              f"({loaded.storage()['bytes_stored'] / 1e6:.2f} MB on disk "
              f"by layout)")

        # batched serving over the loaded artifact
        server = RetrievalServer(loaded, k=10, n_first=64)
        for batch_size in (8, 32, 64):
            q = q_embs[:batch_size]
            t0 = time.perf_counter()
            idx, scores = server.query_batch(q)
            dt = time.perf_counter() - t0
            out["batch_ms"][batch_size] = dt * 1e3
            print(f"batch {batch_size:>3}: {dt * 1e3:7.1f} ms total, "
                  f"{dt / batch_size * 1e3:6.2f} ms/query, "
                  f"top1 doc of q0 = {int(idx[0, 0])}")

        # live mutation lifecycle: durable WAL-covered upsert + delete
        # on the shipped artifact, served from delta buckets without
        # restart
        fresh = torch.randn((4, 40, 24), generator=torch.Generator(
            dev).manual_seed(7), device=dev)
        fmask = torch.ones((4, 40), dtype=torch.bool, device=dev)
        ids = [5, 17, 256, 257]        # two updates, two brand-new docs
        delta = mutation.append_upsert(path, fresh, fmask, ids,
                                       granularity=4, min_width=4)
        mutation.append_delete(path, [9, 256])  # one old doc, one fresh
        log = mutation.load_state(path, device=dev)
        server.apply_mutation(log.view())
        idx, scores = server.query_batch(q_embs[:8])
        print(f"live view (delta {delta}): {len(log.deltas)} delta leaf, "
              f"{len(log.tombstones)} tombstones, n_live={log.n_live}, "
              f"top1 doc of q0 = {int(idx[0, 0])}")
        ref_idx, ref_scores = topk_search(server.index, q_embs[:8],
                                          k=10, mutation=log.view())

        # compact: fold the delta log into the next epoch beside the
        # live one — the root-manifest rename is the swap, and the new
        # epoch serves bit-identically to the view it replaces
        compacted = mutation.Compactor(path, granularity=4, min_width=4,
                                       device=dev).run()
        server.swap_index(index_io.load_index(path, device=dev))
        idx2, scores2 = topk_search(server.index, q_embs[:8], k=10)
        same = bool(torch.equal(ref_idx, idx2)
                    and torch.equal(ref_scores, scores2))
        epoch = index_io.load_epoch(path)
        print(f"compacted to epoch {epoch} "
              f"({len(compacted.buckets)} buckets): bit-identical "
              f"serving: {same}")

        # recover: a crash between WAL intent and commit leaves a torn
        # write; recover() rolls it back (or forward, if every covered
        # artifact write landed) and collects orphans — idempotent
        index_io.wal_append(path, {"op": "compact", "seq": 99,
                                   "epoch": 2, "deltas": []})
        report = index_io.recover(path)
        print(f"recover after torn compact intent: {report}")
    assert same, "the compacted epoch must serve as the view it replaces"
    out.update(n_live=log.n_live, epoch=epoch, compacted_identical=same,
               recover=report, top1_live=int(idx[0, 0]))
    print("OK")
    return out


if __name__ == "__main__":
    main()
