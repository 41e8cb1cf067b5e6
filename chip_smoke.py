"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints on its own lines; the last line is the JSON
``{"ok": true, "device": {...}}`` and appears only when every phase
passed — any failure exits non-zero):

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: compile the six kernels from ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a`` (one process per source), timed.
3. Main path at the full ``colbert`` config (12 layers, width 768,
   bf16, random weights from seed 0): encode 4,096 synthetic docs of
   length 180 and 64 queries, prune at keep 0.5 on the default
   ``shortlist_topk`` backend (2,048 sphere samples), pack (bf16, as
   the encoder emits it), serve top-10 two-stage (``n_first=64``), then
   e2e (``n_first=n_docs``).  Launch counts are zeroed just before and
   read just after.  Both top-10s are held against the ``reference``
   backend on the card.
4. Compressed and routed path on the main path's pruned corpus: pack
   ``int8``, ``residual`` 4-bit and ``residual`` 2-bit (8 centroids),
   serve top-10 e2e and two-stage on ``fused``, build a
   ``RoutingIndex`` (4 centroids) on the 4-bit index and serve it
   ``bounded`` (must equal the exhaustive top-10 bit for bit) and
   ``nprobe=1`` (recall@10 against exhaustive).  Launch counts are
   zeroed just before and read just after; every top-10 is then held
   against the ``reference`` backend.
5. Kernels against their plain PyTorch versions on the card, on the
   paths' own tensors: max abs error, index agreement, kernel and plain
   times (CUDA events), and each kernel's bound.  B3/B4 run on fp32 and
   on bf16 docs; B5/B6 at 4 and 2 bits and at 8 and 127 centroids.
   These launches do not count.
6. Fused pruning leg: the first 256 docs on ``backend="fused"``
   (``maxsim_top2``) against ``shortlist_topk``; B1's launch count is
   read from this leg.
7. The ``kernels`` JSON line.

Tolerances: values within 1e-5 abs (unit-norm fp32 inputs, dim 128);
token/doc ids equal wherever the gap to the runner-up exceeds 1e-5.
Empty-doc sentinel scores (l x -1e30) are compared relatively (1e-6).
A kernel row's ``max_abs_err`` is the largest over the variants held.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ATOL = 1e-5
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
N_DOCS, N_QUERIES, FUSED_DOCS = 4096, 64, 256


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def score_err(out, ref):
    """Max abs error over real scores; max relative error over the
    empty-doc sentinel scores (l x -1e30)."""
    real = ref > -1e29
    abs_err = (out - ref)[real].abs().max().item() if real.any() else 0.0
    rel = ((out - ref) / ref)[~real].abs()
    return abs_err, (rel.max().item() if rel.numel() else 0.0)


def ids_ok(ids, ref_ids, ref_sorted):
    """Position-wise id agreement of a top-k list; a mismatch passes
    when the reference value there is within ATOL of a neighbour
    (``ref_sorted`` holds k + 1 reference values, descending)."""
    k = ids.shape[-1]
    gap_prev = torch.full_like(ref_sorted[..., :k], float("inf"))
    gap_prev[..., 1:] = ref_sorted[..., 1:k] - ref_sorted[..., :k - 1]
    gap_next = ref_sorted[..., :k] - ref_sorted[..., 1:k + 1]
    tie = (gap_prev.abs() <= ATOL) | (gap_next.abs() <= ATOL)
    bad = (ids != ref_ids) & ~tie
    return (ids == ref_ids).float().mean().item(), int(bad.sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import colbert_base
    from repro_torch.core import pruning_pipeline
    from repro_torch.kernels import build
    from repro_torch.kernels.colbert_maxsim import ops as cm_ops
    from repro_torch.kernels.colbert_maxsim import ref as cm_ref
    from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
    from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
    from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
    from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref
    from repro_torch.launch.serve import serve_retrieval
    from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex,
                                             _streaming_first_stage, search,
                                             topk_search)
    from repro_torch.serve.routing import RoutingIndex
    from repro_torch.core.backend import shortlist_knobs

    failures = []

    def expect(cond, what):
        if not cond:
            failures.append(what)
            log(f"[check] FAIL: {what}")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    secs = build.build_all(force=True)
    log(f"[build] 3 sources (6 kernels) built in {secs:.2f} s")

    # 3. main path
    counters = {"maxsim_top2": maxsim_top2_op,
                "maxsim_topk": maxsim_topk_op,
                "colbert_maxsim_multi": cm_ops.colbert_maxsim_multi_op,
                "colbert_maxsim_rerank": cm_ops.colbert_maxsim_rerank_op,
                "colbert_maxsim_residual_multi":
                    cm_ops.colbert_maxsim_residual_multi_op,
                "colbert_maxsim_residual_rerank":
                    cm_ops.colbert_maxsim_residual_rerank_op}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        for fn in (cm_ops.colbert_maxsim_multi_op,
                   cm_ops.colbert_maxsim_rerank_op):
            fn.bf16_launches = 0

    def read_counts():
        """Launches by kernel row: the dense B3/B4 split by doc dtype."""
        out = {n: fn.launches for n, fn in counters.items()}
        for n in ("colbert_maxsim_multi", "colbert_maxsim_rerank"):
            bf16 = counters[n].bf16_launches
            out[n + "_bf16"] = bf16
            out[n] -= bf16
        return out

    zero_counts()
    t0 = time.perf_counter()
    res = serve_retrieval(colbert_base.CONFIG, keep_fraction=0.5,
                          n_queries=N_QUERIES, seed=0, n_first=64,
                          n_docs=N_DOCS)
    packed, q_emb = res.packed, res.q_emb
    e2e = RetrievalServer(packed, k=10, n_first=packed.n_docs)
    t = time.perf_counter()
    e2e_idx, e2e_scores = e2e.query_batch(q_emb)
    e2e_s = time.perf_counter() - t
    main_s = time.perf_counter() - t0
    launches = read_counts()
    log(f"[main] stages (s): {json.dumps(res.timings)} e2e_serve_s: "
        f"{e2e_s:.4f} total_s: {main_s:.2f}")
    log(f"[main] storage: {json.dumps(packed.storage())}")
    log(f"[main] backends: prune=shortlist_topk serve={res.server.backend}"
        f" index dtype={packed.buckets[0].embs.dtype}")
    log(f"[main] launches: {json.dumps(launches)}")
    for name in ("maxsim_topk", "colbert_maxsim_multi_bf16",
                 "colbert_maxsim_rerank_bf16"):
        expect(launches[name] > 0, f"{name} not launched on the main path")
    for name, (i, s) in {"two-stage": (res.idx, res.scores),
                         "e2e": (e2e_idx, e2e_scores)}.items():
        expect(i.shape == (N_QUERIES, 10) and s.shape == (N_QUERIES, 10),
               f"{name} top-k shape {i.shape}")
        expect(bool((i >= 0).all() and (i < N_DOCS).all()),
               f"{name} ids out of range")
        expect(bool(np.isfinite(s).all()), f"{name} scores not finite")

    def hold_to_reference(tag, index, n_first, i, s):
        """A served top-10 against the reference backend's top-11 (the
        11th score tells a tie at rank 10 apart)."""
        ri, rs = search(index, q_emb, k=11, n_first=n_first,
                        backend="reference", return_full=False)
        err = (torch.as_tensor(s) - rs[:, :10].cpu()).abs().max().item()
        agree, bad = ids_ok(torch.as_tensor(i), ri[:, :10].cpu(), rs.cpu())
        log(f"{tag} top-10 vs reference backend: ids equal {agree:.4f}, "
            f"untied mismatches {bad}, max |score err| {err:.3e}")
        expect(bad == 0 and err <= ATOL,
               f"{tag} top-10 disagrees with the reference backend")

    hold_to_reference("[main] e2e", packed, packed.n_docs, e2e_idx,
                      e2e_scores)
    hold_to_reference("[main] two-stage", packed, 64, res.idx, res.scores)

    # 4. compressed and routed path on the main path's pruned corpus
    pruned = TokenIndex.build(res.d_emb, res.d_mask).with_keep(res.keep)
    codecs = {"int8": {"compression": "int8"},
              "residual4": {"compression": "residual", "residual_bits": 4},
              "residual2": {"compression": "residual", "residual_bits": 2}}
    zero_counts()
    t0 = time.perf_counter()
    packs, served = {}, {}
    for name, kw in codecs.items():
        t = time.perf_counter()
        packs[name] = p = pruned.pack(**kw)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t
        st = p.storage()
        log(f"[compressed] {name} pack {pack_s:.3f} s storage "
            f"{json.dumps(st)}")
        log(f"[compressed] {name} bytes_stored {st['bytes_stored']}: "
            f"{st['bytes_stored'] / st['bytes_fp32']:.4f} of fp32 kept "
            f"tokens, {st['bytes_stored'] / st['bytes_dense_fp32']:.4f} of "
            f"dense fp32, {st['bytes_stored'] / packed.storage()['bytes_stored']:.4f}"
            f" of the bf16 index")
        for route, n_first in (("e2e", p.n_docs), ("two-stage", 64)):
            server = RetrievalServer(p, k=10, n_first=n_first,
                                     backend="fused")
            t = time.perf_counter()
            served[name, route] = server.query_batch(q_emb)
            log(f"[compressed] {name} {route} serve "
                f"{time.perf_counter() - t:.4f} s")
    p4 = packs["residual4"]
    t = time.perf_counter()
    table = RoutingIndex.build(p4, n_centroids=4)
    torch.cuda.synchronize()
    log(f"[routing] RoutingIndex(n_centroids=4) on residual4: "
        f"{table.n_buckets} buckets, built in "
        f"{time.perf_counter() - t:.3f} s; radius "
        f"{[round(float(r), 4) for r in table.radius]}")
    bounded = RetrievalServer(p4, k=10, route="bounded", routing=table,
                              backend="fused")
    t = time.perf_counter()
    b_idx, b_scores = bounded.query_batch(q_emb)
    log(f"[routing] bounded serve {time.perf_counter() - t:.4f} s")
    bst = {}
    topk_search(p4, q_emb, k=10, backend="fused", route="bounded",
                routing=table, route_stats=bst)
    st = {}
    t = time.perf_counter()
    n_idx, _ = topk_search(p4, q_emb, k=10, backend="fused", route="nprobe",
                           routing=table, n_probe=1, route_stats=st)
    torch.cuda.synchronize()
    log(f"[routing] nprobe=1 serve {time.perf_counter() - t:.4f} s")
    comp_s = time.perf_counter() - t0
    comp_launches = read_counts()
    log(f"[compressed] total_s {comp_s:.2f} launches: "
        f"{json.dumps(comp_launches)}")
    for name in ("colbert_maxsim_multi", "colbert_maxsim_rerank",
                 "colbert_maxsim_residual_multi",
                 "colbert_maxsim_residual_rerank"):
        expect(comp_launches[name] > 0,
               f"{name} not launched on the compressed path")
    for (name, route), (i, s) in served.items():
        expect(i.shape == (N_QUERIES, 10) and bool(np.isfinite(s).all()),
               f"{name} {route} top-k malformed")
        hold_to_reference(f"[compressed] {name} {route}", packs[name],
                          packs[name].n_docs if route == "e2e" else 64, i, s)
    ex_idx, ex_scores = served["residual4", "e2e"]
    exact = (np.array_equal(b_idx, ex_idx)
             and np.array_equal(b_scores, ex_scores))
    log(f"[routing] bounded top-10 equals exhaustive bit for bit: {exact}"
        f", route_stats {json.dumps(bst)}")
    expect(exact, "bounded routed top-10 differs from exhaustive")
    n_idx = n_idx.cpu().numpy()
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(n_idx, ex_idx)])
    log(f"[routing] nprobe=1 recall@10 vs exhaustive {recall:.4f}, "
        f"route_stats {json.dumps(st)}")

    # 5. kernels against their plain versions, on the paths' tensors
    samples, d_mask = res.samples, res.d_mask
    d_emb = res.d_emb.float()
    plan = pruning_pipeline.bucket_plan(
        pruning_pipeline.effective_lengths(d_mask), d_mask.shape[1])
    big = max(plan, key=lambda b: len(b.indices) * b.width)
    idx = torch.as_tensor(big.indices, device=d_emb.device)
    tok = d_emb[idx, :big.width].contiguous()
    alive = d_mask[idx, :big.width].contiguous()
    B, m, dim = tok.shape
    N = samples.shape[0]
    K, _ = shortlist_knobs(m)
    rows = []

    def row(name, source, replaces, max_err, ms, plain_ms, flops, nb):
        b_ms, b_by = bound(flops, nb)
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": None,
                     "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
        log(f"[kernel] {name}: max_abs_err {max_err:.3e} kernel {ms:.3f} ms "
            f"plain {plain_ms:.3f} ms bound {b_ms:.3f} ms ({b_by})")

    flops = 2.0 * B * N * m * dim
    # B2 maxsim_topk — the first shortlist rescan of the widest bucket
    v, i = maxsim_topk_op(samples, tok, alive, k=K)
    rv, ri = maxsim_topk_ref(samples, tok, alive, K + 1)
    err = (v - rv[..., :K]).abs().max().item()
    agree, bad = ids_ok(i, ri[..., :K], rv)
    log(f"[kernel] maxsim_topk B={B} N={N} m={m} k={K}: ids equal "
        f"{agree:.6f}, untied mismatches {bad}")
    expect(err <= ATOL and bad == 0, "maxsim_topk disagrees with plain")
    row("maxsim_topk", "src/repro_torch/kernels/csrc/maxsim_topk.cu",
        "src/repro/kernels/maxsim_topk/maxsim_topk.py:104", err,
        cuda_ms(lambda: maxsim_topk_op(samples, tok, alive, k=K)),
        cuda_ms(lambda: maxsim_topk_ref(samples, tok, alive, K), reps=2),
        flops, nbytes(samples, tok, alive) + B * N * K * 8)
    del rv, ri
    # B1 maxsim_top2 — the fused path's first cell assignment
    out = maxsim_top2_op(samples, tok, alive)
    ref = maxsim_top2_ref(samples, tok, alive)
    err = max((out[0] - ref[0]).abs().max().item(),
              (out[1] - ref[1]).abs().max().item())
    top3, _ = maxsim_topk_ref(samples, tok, alive, 3)
    bi_ok = (out[2] == ref[2]) | ((top3[..., 0] - top3[..., 1]) <= ATOL)
    si_ok = (out[3] == ref[3]) | ((top3[..., 1] - top3[..., 2]) <= ATOL) | (
        (top3[..., 0] - top3[..., 1]) <= ATOL)
    log(f"[kernel] maxsim_top2 B={B} N={N} m={m}: argbest equal "
        f"{(out[2] == ref[2]).float().mean().item():.6f}, argsecond equal "
        f"{(out[3] == ref[3]).float().mean().item():.6f}")
    expect(err <= ATOL and bool(bi_ok.all() and si_ok.all()),
           "maxsim_top2 disagrees with plain")
    del top3
    row("maxsim_top2", "src/repro_torch/kernels/csrc/maxsim_top2.cu",
        "src/repro/kernels/maxsim_top2/maxsim_top2.py:109", err,
        cuda_ms(lambda: maxsim_top2_op(samples, tok, alive)),
        cuda_ms(lambda: maxsim_top2_ref(samples, tok, alive), reps=2),
        flops, nbytes(samples, tok, alive) + B * N * 16)
    del out, ref
    # B3 colbert_maxsim_multi — the e2e sweep of the widest packed bucket,
    # on the main path's bf16 docs and on the same docs widened to fp32
    pb = max(packed.buckets, key=lambda b: b.n_docs * b.cap)
    l = q_emb.shape[1]
    for name, embs in (("colbert_maxsim_multi", pb.embs.float()),
                       ("colbert_maxsim_multi_bf16", pb.embs)):
        o = cm_ops.colbert_maxsim_multi_op(q_emb, embs, pb.masks)
        r = cm_ref.colbert_maxsim_multi_ref(q_emb, embs, pb.masks)
        err, rel = score_err(o, r)
        log(f"[kernel] {name} n_q={N_QUERIES} l={l} n_docs={pb.n_docs} "
            f"m={pb.cap} docs {embs.dtype}: sentinel rel err {rel:.2e}")
        expect(err <= ATOL and rel <= 1e-6, f"{name} disagrees with plain")
        row(name, "src/repro_torch/kernels/csrc/colbert_maxsim.cu",
            "src/repro/kernels/colbert_maxsim/colbert_maxsim.py:125", err,
            cuda_ms(lambda: cm_ops.colbert_maxsim_multi_op(q_emb, embs,
                                                            pb.masks)),
            cuda_ms(lambda: cm_ref.colbert_maxsim_multi_ref(q_emb, embs,
                                                             pb.masks),
                    reps=2),
            2.0 * N_QUERIES * l * pb.n_docs * pb.cap * dim,
            nbytes(q_emb, embs, pb.masks) + N_QUERIES * pb.n_docs * 4)
    # B4 colbert_maxsim rerank — the two-stage rerank's candidate blocks
    cand = _streaming_first_stage(packed, q_emb, 64).long()
    g_embs, g_masks = packed.padded()
    m_sub = g_masks[cand]
    for name, d_sub in (("colbert_maxsim_rerank", g_embs[cand].float()),
                        ("colbert_maxsim_rerank_bf16", g_embs[cand])):
        o = cm_ops.colbert_maxsim_rerank_op(q_emb, d_sub, m_sub)
        r = cm_ref.colbert_maxsim_rerank_ref(q_emb, d_sub, m_sub)
        err, rel = score_err(o, r)
        log(f"[kernel] {name} n_q={N_QUERIES} n_cand=64 "
            f"m={g_masks.shape[1]} docs {d_sub.dtype}: sentinel rel err "
            f"{rel:.2e}")
        expect(err <= ATOL and rel <= 1e-6, f"{name} disagrees with plain")
        row(name, "src/repro_torch/kernels/csrc/colbert_maxsim.cu",
            "src/repro/kernels/colbert_maxsim/colbert_maxsim.py:69", err,
            cuda_ms(lambda: cm_ops.colbert_maxsim_rerank_op(q_emb, d_sub,
                                                             m_sub)),
            cuda_ms(lambda: cm_ref.colbert_maxsim_rerank_ref(q_emb, d_sub,
                                                              m_sub),
                    reps=2),
            2.0 * N_QUERIES * l * d_sub.shape[1] * d_sub.shape[2] * dim,
            nbytes(q_emb, d_sub, m_sub) + N_QUERIES * d_sub.shape[1] * 4)
    # B5/B6 — the residual sweeps, on the widest bucket (B5) and the
    # two-stage candidates (B6) of each residual index; the row is the
    # path's 4-bit, 8-centroid index, the others are held and logged
    packs["residual4_c127"] = pruned.pack(compression="residual",
                                          residual_bits=4, n_centroids=127)
    b5, b6 = {}, {}
    for name in ("residual4", "residual2", "residual4_c127"):
        p = packs[name]
        rb = max(p.buckets, key=lambda b: b.n_docs * b.cap)
        v = rb.residual_view(p.dim)
        a5 = (q_emb, v.codes, v.resq, v.scale, v.codebook, rb.masks)
        cand = _streaming_first_stage(p, q_emb, 64).long()
        codes, resq, bucket_of, r_masks, cbs, scales = p.padded_residual()
        a6 = (q_emb, codes[cand], resq[cand], scales[cand], cbs,
              bucket_of[cand], r_masks[cand])
        for tag, store, op, ref, args, n_docs, m_ in (
                ("colbert_maxsim_residual_multi", b5,
                 cm_ops.colbert_maxsim_residual_multi_op,
                 cm_ref.colbert_maxsim_residual_multi_ref, a5, rb.n_docs,
                 rb.cap),
                ("colbert_maxsim_residual_rerank", b6,
                 cm_ops.colbert_maxsim_residual_rerank_op,
                 cm_ref.colbert_maxsim_residual_rerank_ref, a6, 64,
                 p.cap_max)):
            o = op(*args, bits=v.bits)
            r = ref(*args, bits=v.bits)
            err, rel = score_err(o, r)
            ms = cuda_ms(lambda: op(*args, bits=v.bits))
            plain = cuda_ms(lambda: ref(*args, bits=v.bits), reps=2)
            log(f"[kernel] {tag} {name} (bits {v.bits}, C "
                f"{v.codebook.shape[0]}) n_q={N_QUERIES} n_docs={n_docs} "
                f"m={m_}: max_abs_err {err:.3e} sentinel rel err {rel:.2e} "
                f"kernel {ms:.3f} ms plain {plain:.3f} ms")
            expect(err <= ATOL and rel <= 1e-6,
                   f"{tag} {name} disagrees with plain")
            store[name] = (err, ms, plain,
                           2.0 * N_QUERIES * l * n_docs * m_ * dim,
                           nbytes(*args) + N_QUERIES * n_docs * 4)
    for tag, store, line in (("colbert_maxsim_residual_multi", b5, 217),
                             ("colbert_maxsim_residual_rerank", b6, 294)):
        _, ms, plain, flops, nb = store["residual4"]
        row(tag, "src/repro_torch/kernels/csrc/colbert_maxsim.cu",
            f"src/repro/kernels/colbert_maxsim/colbert_maxsim.py:{line}",
            max(v[0] for v in store.values()), ms, plain, flops, nb)

    # 6. fused pruning leg
    e, mk = d_emb[:FUSED_DOCS], d_mask[:FUSED_DOCS]
    maxsim_top2_op.launches = 0
    t = time.perf_counter()
    rf, ef, of = pruning_pipeline.pruning_order_bucketed(
        e, mk, samples, backend="fused")
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t
    launches["maxsim_top2"] = maxsim_top2_op.launches
    t = time.perf_counter()
    rs_, es_, os_ = pruning_pipeline.pruning_order_bucketed(
        e, mk, samples, backend="shortlist_topk")
    torch.cuda.synchronize()
    short_s = time.perf_counter() - t
    real = mk
    share = (rf == rs_)[real].float().mean().item()
    log(f"[fused] {FUSED_DOCS} docs: fused {fused_s:.3f} s "
        f"({launches['maxsim_top2']} maxsim_top2 launches), shortlist_topk "
        f"{short_s:.3f} s; equal ranks {share:.6f}")
    diff = (of != os_).any(dim=1).nonzero()
    if len(diff):
        d = int(diff[0])
        s = int((of[d] != os_[d]).nonzero()[0])
        a, b = int(of[d, s]), int(os_[d, s])
        log(f"[fused] first difference: doc {d} step {s}: fused removes "
            f"{a} (err {ef[d, a].item():.9g}), shortlist_topk removes {b} "
            f"(err {es_[d, b].item():.9g}); error gap "
            f"{abs(ef[d, a].item() - es_[d, b].item()):.3e}")
    else:
        log("[fused] no difference in removal orders")
    expect(share >= 0.99, f"fused vs shortlist_topk equal ranks {share}")
    expect(launches["maxsim_top2"] > 0, "maxsim_top2 not launched")

    # 7. kernels line: launches from the run of the path each kernel is on
    for r_ in rows:
        r_["launches"] = (launches if r_["name"] in (
            "maxsim_top2", "maxsim_topk", "colbert_maxsim_multi_bf16",
            "colbert_maxsim_rerank_bf16") else comp_launches)[r_["name"]]
    log(json.dumps({"kernels": rows}))
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(f"[device] {smi}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
