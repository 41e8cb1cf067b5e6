"""Quick card check of the Hopper score kernels (B1-B6).

    PYTHONPATH=src python -m repro_torch.kernels.score_check

Builds the kernels, prints the ptxas report of ``maxsim_top2``,
``maxsim_topk`` and ``colbert_maxsim``, then runs each once at the
``colbert`` paths' timed shapes on random unit-norm inputs (seed 0)
against its plain version, and times it with CUDA events (mean of 5
after a warm-up):

* B1: 2,048 fp32 samples against 2,908 docs x 180 bf16-exact tokens
  (doc 0 all dead, doc 1 one alive token) and against the fused
  pruning leg's bucket of 128 docs;
* B2: the same, at k 4 and 16;
* B3: 64 queries x 32 bf16-exact tokens against 3,695 bf16 docs x 128
  (doc 5 all masked), with those queries (one bf16 term) and with them
  scaled by 1 + 2^-12 (three terms);
* B5: the same queries against a residual bucket of 3,695 docs x 128
  (4-bit, 8 centroids; 2-bit; 4-bit with 127 centroids and codes out of
  range, clamped), one- and three-term queries; then B5 and its plain
  version against a float64 MaxSim where the centroids are far from unit
  norm (randn, norm ~11; scores up to ~90), 6 queries x 32 against 37
  docs x 130 at 2 and 4 bits and 8 and 127 centroids: the codebooks,
  codes, residuals and masks of ``tests/test_torch_kernels.py``'s
  residual case with unit-norm fp32 queries (printed, not gated);
* B3 on fp32 docs: the same queries against the bf16 docs as int8
  values times per-token fp32 scales (the int8 index's dense view, three
  terms) and widened (one term), the split pre-pass timed alone; then
  docs of norm ~11 against a float64 MaxSim (gated at 1e-5);
* B6: 64 queries x 64 candidates x 128 of their own, 4-bit with 8
  centroids and 2-bit with 127, four tables, codes and bucket ids out of
  range in some candidates (clamped); then tables of norm ~11 against a
  float64 MaxSim (gated at 1e-5);
* B4: the same queries against 64 candidates x 128 of their own (one
  all masked), bf16 and fp32 (int8 values times per-token fp32 scales,
  three terms), and one query against 1,024 bf16 candidates; the two
  64-query kernels' device time alone from ``torch.profiler``; then
  candidates of norm ~11 against a float64 MaxSim (gated at 1e-5);
* the accumulation of B1, B2 and bf16 B3, which keep a k16 step sum in
  the tensor cores' accumulator: unit samples against 5 docs x 180
  tokens of norm ~11 (randn; fp32 and bf16-exact), B2's top-16 and B1's
  best and second values, and unit queries (fp32 and bf16-exact) against
  37 bf16 docs x 130 of norm ~11, against float64 (gated at 1e-5), the
  fp32 plain version's error beside.

It needs a CUDA device and exits non-zero on a disagreement past the
1e-5 gate.  ``chip_smoke.py`` holds the same kernels on the paths' own
tensors; this is the short first call after a kernel change.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.colbert_maxsim import ops as cm
from repro_torch.kernels.colbert_maxsim import ref as cm_ref
from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_op
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_ref
from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref
from repro_torch.train.compress import dequantize_residual, quantize_residual

ATOL = 1e-5


def _ms(fn, reps=5):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("score_check: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    names = ("maxsim_top2", "maxsim_topk", "colbert_maxsim")
    secs = build.build_all(names, force=True)
    print(f"build {secs:.2f} s")
    for name in names:
        print(f"{name} ptxas: {build.ptxas_report(name)}")
    g = torch.Generator(device="cuda").manual_seed(0)

    def unit(*shape):
        x = torch.randn(*shape, device="cuda", generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    ok = True
    S = unit(2048, 128)
    T = unit(2908, 180, 128).bfloat16().float()
    A = torch.rand(2908, 180, device="cuda", generator=g) < 0.8
    A[0] = False
    v, i = maxsim_topk_op(S, T, A, k=16)
    rv, ri = maxsim_topk_ref(S, T, A, 17)
    err = (v - rv[..., :16]).abs().max().item()
    tied = (rv[..., :16] - rv[..., 1:]).abs() <= ATOL
    tied[..., 1:] |= tied[..., :-1].clone()
    bad = int(((i != ri[..., :16]) & ~tied).sum())
    ok &= err <= ATOL and bad == 0
    del rv, ri
    times = "; ".join(
        f"k {k} {_ms(lambda: maxsim_topk_op(S, T, A, k=k)):.3f} ms"
        for k in (4, 16))
    print(f"B2 maxsim_topk: max abs err {err:.3e}, untied id mismatches "
          f"{bad}; {times}")

    A[1] = False
    A[1, 77] = True
    for tag, n_docs in (("2,908 docs", 2908), ("the fused leg's 128", 128)):
        t, a = T[:n_docs], A[:n_docs]
        out = maxsim_top2_op(S, t, a)
        ref = maxsim_top2_ref(S, t, a)
        top3, _ = maxsim_topk_ref(S, t, a, 3)
        err = max((out[0] - ref[0]).abs().max().item(),
                  (out[1] - ref[1]).abs().max().item())
        gap1 = top3[..., 0] - top3[..., 1]
        gap2 = top3[..., 1] - top3[..., 2]
        bad = int(((out[2] != ref[2]) & (gap1 > ATOL)).sum()
                  + ((out[3] != ref[3]) & (gap1 > ATOL) & (gap2 > ATOL)).sum())
        # the all-dead doc: best and second token 0 at -1e30; the doc of
        # one alive token: best token 77, second token 0 at -1e30
        edge = (all(torch.equal(o[:2], r[:2])
                    for o, r in zip(out[1:], ref[1:]))
                and torch.equal(out[0][0], ref[0][0]))
        ok &= err <= ATOL and bad == 0 and edge
        del ref, top3
        print(f"B1 maxsim_top2 {tag} x 180: max abs err {err:.3e}, untied id "
              f"mismatches {bad}, all-dead and one-alive docs equal {edge}; "
              f"{_ms(lambda: maxsim_top2_op(S, t, a)):.3f} ms")

    q = unit(64, 32, 128).bfloat16().float()
    D = unit(3695, 128, 128).bfloat16()
    M = torch.rand(3695, 128, device="cuda", generator=g) < 0.7
    M[5] = False
    for tag, qq in (("one term", q), ("three terms", q * (1 + 2.0 ** -12))):
        o = cm.colbert_maxsim_multi_op(qq, D, M)
        r = cm_ref.colbert_maxsim_multi_ref(qq, D, M)
        real = r > -1e29
        err = (o - r)[real].abs().max().item()
        rel = ((o - r) / r)[~real].abs().max().item()
        ok &= err <= ATOL and rel <= 1e-6
        print(f"B3 colbert_maxsim_multi bf16 docs, queries {tag}: max abs "
              f"err {err:.3e}, sentinel rel err {rel:.1e}; "
              f"{_ms(lambda: cm.colbert_maxsim_multi_op(qq, D, M)):.3f} ms")

    codes = torch.randint(0, 8, (3695, 128), device="cuda", generator=g,
                          dtype=torch.int8)
    for bits, C in ((4, 8), (2, 8), (4, 127)):
        cb = unit(C, 128)
        x = cb[codes.long() % C] + 0.2 * unit(3695, 128, 128)
        resq, scale = quantize_residual(x - cb[codes.long() % C], bits)
        cds = codes.clone()
        if C == 127:
            cds[7, :9] = 127          # out of range: clamped to C - 1
            cds[8, :9] = -3           # clamped to 0
        for tag, qq in (("one term", q),
                        ("three terms", q * (1 + 2.0 ** -12))):
            args = (qq, cds, resq, scale, cb, M)
            o = cm.colbert_maxsim_residual_multi_op(*args, bits=bits)
            r = cm_ref.colbert_maxsim_residual_multi_ref(
                qq, cds.clamp(0, C - 1), resq, scale, cb, M, bits=bits)
            real = r > -1e29
            err = (o - r)[real].abs().max().item()
            rel = ((o - r) / r)[~real].abs().max().item()
            ok &= err <= ATOL and rel <= 1e-6
            ms = _ms(lambda: cm.colbert_maxsim_residual_multi_op(*args,
                                                                 bits=bits))
            print(f"B5 colbert_maxsim_residual_multi {bits}-bit C {C}, "
                  f"queries {tag}: max abs err {err:.3e}, sentinel rel err "
                  f"{rel:.1e}; {ms:.3f} ms")

    for bits in (2, 4):
        for C in (8, 127):
            cg = torch.Generator().manual_seed(0)
            cb = torch.randn(C, 128, generator=cg)
            cds = torch.randint(0, C, (37, 130), generator=cg,
                                dtype=torch.int8)
            x = cb[cds.long()] + 0.3 * torch.randn((37, 130, 128),
                                                   generator=cg)
            resq, scale = quantize_residual(x - cb[cds.long()], bits)
            dm = torch.rand((37, 130), generator=cg) < 0.8
            dm[1] = False
            args = [t.cuda() for t in (unit(6, 32, 128).cpu(), cds, resq,
                                       scale, cb, dm)]
            o = cm.colbert_maxsim_residual_multi_op(*args, bits=bits)
            r = cm_ref.colbert_maxsim_residual_multi_ref(*args, bits=bits)
            qq, cds, resq, scale, cb, dm = args
            d = dequantize_residual(resq, scale, cds, cb, bits)
            s = torch.einsum("qld,nmd->qnlm", qq.double(), d.double())
            e = torch.where(dm[None, :, None, :], s, -1e30).amax(-1).sum(-1)
            real = e > -1e29
            print(f"B5 {bits}-bit C {C}, centroids of norm ~11 (|score| <= "
                  f"{e[real].abs().max().item():.1f}) against float64: kernel "
                  f"{(o - e)[real].abs().max().item():.2e} (mean "
                  f"{(o - e)[real].mean().item():+.1e}), plain "
                  f"{(r - e)[real].abs().max().item():.2e} (mean "
                  f"{(r - e)[real].mean().item():+.1e}), kernel vs plain "
                  f"{(o - r)[real].abs().max().item():.2e}")

    # B3 on fp32 docs
    n, mm = D.shape[:2]
    scl = D.float().abs().amax(-1, keepdim=True) / 127
    D8 = (D.float() / scl).round().to(torch.int8).float() * scl
    for tag, dd in (("int8 x scale, three terms", D8),
                    ("bf16 widened, one term", D.float())):
        o = cm.colbert_maxsim_multi_op(q, dd, M)
        r = cm_ref.colbert_maxsim_multi_ref(q, dd, M)
        real = r > -1e29
        err = (o - r)[real].abs().max().item()
        rel = ((o - r) / r)[~real].abs().max().item()
        ok &= err <= ATOL and rel <= 1e-6
        print(f"B3 colbert_maxsim_multi fp32 docs ({tag}): max abs err "
              f"{err:.3e}, sentinel rel err {rel:.1e}; "
              f"{_ms(lambda: cm.colbert_maxsim_multi_op(q, dd, M)):.3f} ms")
    planes = torch.empty((3, n * mm, 128), dtype=torch.bfloat16,
                         device="cuda")
    flags = torch.empty((n,), dtype=torch.int32, device="cuda")
    split_ms = _ms(lambda: build.launch(
        "colbert_maxsim", "colbert_maxsim_split_planes", D8.device,
        D8.data_ptr(), n * mm, 128, mm, planes.data_ptr(), flags.data_ptr(),
        build.stream_ptr(D8)))
    print(f"B3 fp32 split pre-pass alone (three-term docs): {split_ms:.3f} "
          f"ms")
    del D8, planes, flags

    def exact(eq, qq, dd, dm, qm):
        s = torch.einsum(eq, qq.double(), dd.double())
        s = torch.where(dm[..., None, :], s, -1e30)
        return torch.where(qm[:, None, :], s.amax(-1), 0.0).sum(-1)

    def near(tag, o, e, plain=None):
        """o within 1e-5 of float64 e; the plain version's error beside."""
        real = e > -1e29
        err = (o.double() - e)[real].abs().max().item()
        rel = ((o.double() - e) / e)[~real].abs().max().item()
        beside = ("" if plain is None else
                  f"; the plain version "
                  f"{(plain.double() - e)[real].abs().max().item():.2e}")
        print(f"{tag} (|score| <= {e[real].abs().max().item():.1f}) against "
              f"float64: {err:.2e}, sentinel rel err {rel:.1e}{beside}")
        return err <= ATOL and rel <= 1e-6

    qq = unit(6, 32, 128)
    qm = torch.rand(6, 32, device="cuda", generator=g) < 0.9
    dd = torch.randn(37, 130, 128, device="cuda", generator=g)
    dm = torch.rand(37, 130, device="cuda", generator=g) < 0.8
    dm[1] = False
    ok &= near("B3 fp32 docs of norm ~11",
               cm.colbert_maxsim_multi_op(qq, dd, dm, qm),
               exact("qld,nmd->qnlm", qq, dd, dm, qm))

    # B6
    for bits, C in ((4, 8), (2, 127)):
        tab = unit(4, C, 128)
        cds = torch.randint(0, C, (64, 64, 128), device="cuda", generator=g,
                            dtype=torch.int8)
        bo = torch.randint(0, 4, (64, 64), device="cuda", generator=g,
                           dtype=torch.int32)
        resq, scale = quantize_residual(0.2 * unit(64, 64, 128, 128), bits)
        rm = torch.rand(64, 64, 128, device="cuda", generator=g) < 0.7
        rm[:, 3] = False
        bad, bad_bo = cds.clone(), bo.clone()
        bad[5, 7, :9], bad[6, 8, :9] = 127, -3
        bad_bo[9, 10], bad_bo[11, 12] = 9, -1
        args = (q, bad, resq, scale, tab, bad_bo, rm)
        o = cm.colbert_maxsim_residual_rerank_op(*args, bits=bits)
        r = cm_ref.colbert_maxsim_residual_rerank_ref(
            q, bad.clamp(0, C - 1), resq, scale, tab, bad_bo.clamp(0, 3), rm,
            bits=bits)
        real = r > -1e29
        err = (o - r)[real].abs().max().item()
        rel = ((o - r) / r)[~real].abs().max().item()
        ok &= err <= ATOL and rel <= 1e-6
        ms = _ms(lambda: cm.colbert_maxsim_residual_rerank_op(*args,
                                                              bits=bits))
        print(f"B6 colbert_maxsim_residual_rerank {bits}-bit C {C}, 64 q x "
              f"64 cand x 128: max abs err {err:.3e}, sentinel rel err "
              f"{rel:.1e}; {ms:.3f} ms")
    tab = torch.randn(3, 127, 128, device="cuda", generator=g)
    cds = torch.randint(0, 127, (6, 37, 130), device="cuda", generator=g,
                        dtype=torch.int8)
    bo = torch.randint(0, 3, (6, 37), device="cuda", generator=g,
                       dtype=torch.int32)
    resq, scale = quantize_residual(
        0.3 * torch.randn(6, 37, 130, 128, device="cuda", generator=g), 4)
    rm = torch.rand(6, 37, 130, device="cuda", generator=g) < 0.8
    rm[:, 1] = False
    dec = dequantize_residual(resq, scale, bo.long()[..., None] * 127
                              + cds.long(), tab.reshape(-1, 128), 4)
    ok &= near("B6 tables of norm ~11", cm.colbert_maxsim_residual_rerank_op(
        qq, cds, resq, scale, tab, bo, rm, qm, bits=4),
        exact("qld,qnmd->qnlm", qq, dec, rm, qm))
    # B4
    cand = unit(64, 64, 128, 128).bfloat16()
    cmask = torch.rand(64, 64, 128, device="cuda", generator=g) < 0.7
    cmask[:, 3] = False
    scl = cand.float().abs().amax(-1, keepdim=True) / 127
    c8 = (cand.float() / scl).round() * scl
    for tag, dd, dm_, qq_ in (
            ("bf16, 64 q x 64 cand x 128", cand, cmask, q),
            ("fp32 (int8 x scale, three terms), 64 q x 64 cand x 128", c8,
             cmask, q),
            ("bf16, 1 q x 1,024 cand x 128", cand[:16].reshape(1, 1024, 128,
                                                               128),
             cmask[:16].reshape(1, 1024, 128), q[:1])):
        o = cm.colbert_maxsim_rerank_op(qq_, dd, dm_)
        r = cm_ref.colbert_maxsim_rerank_ref(qq_, dd, dm_)
        real = r > -1e29
        err = (o - r)[real].abs().max().item()
        rel = ((o - r) / r)[~real].abs().max().item()
        ok &= err <= ATOL and rel <= 1e-6
        ms = _ms(lambda: cm.colbert_maxsim_rerank_op(qq_, dd, dm_))
        print(f"B4 colbert_maxsim_rerank {tag}: max abs err {err:.3e}, "
              f"sentinel rel err {rel:.1e}; {ms:.3f} ms")
    # the kernels' device time alone: a ~0.1 ms launch does not hide the
    # wrapper's host work (scratch, tensor maps), which the event times
    # above include
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            cm.colbert_maxsim_rerank_op(q, cand, cmask)
            cm.colbert_maxsim_rerank_op(q, c8, cmask)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "rerank_dense" in ev.key or "split_planes" in ev.key:
            name = ev.key.replace("(anonymous namespace)::", "")
            print(f"B4 device time (torch.profiler), "
                  f"{name.split('(')[0].removeprefix('void ')}: "
                  f"{ev.count} launches, {ev.device_time:.1f} us each")
    del cand, cmask, c8
    d11 = torch.randn(6, 37, 130, 128, device="cuda", generator=g)
    m11 = torch.rand(6, 37, 130, device="cuda", generator=g) < 0.8
    m11[:, 1] = False
    for tag, dd in (("fp32", d11), ("bf16", d11.bfloat16())):
        ok &= near(f"B4 {tag} candidates of norm ~11",
                   cm.colbert_maxsim_rerank_op(qq, dd, m11, qm),
                   exact("qld,qnmd->qnlm", qq, dd, m11, qm),
                   cm_ref.colbert_maxsim_rerank_ref(qq, dd, m11, qm))

    # the accumulation of B1, B2 and bf16 B3 on tokens of norm ~11
    S = unit(300, 128)
    al = torch.rand(5, 180, device="cuda", generator=g) < 0.8
    for tag, T in (("fp32", torch.randn(5, 180, 128, device="cuda",
                                        generator=g)),
                   ("bf16-exact", torch.randn(5, 180, 128, device="cuda",
                                              generator=g).bfloat16()
                    .float())):
        ex = torch.where(al[:, None], torch.einsum(
            "nd,bmd->bnm", S.double(), T.double()), -1e30).topk(16).values
        b1, b1r = maxsim_top2_op(S, T, al), maxsim_top2_ref(S, T, al)
        for name, got, plain, want in (
                ("B2 top-16", maxsim_topk_op(S, T, al, k=16)[0],
                 maxsim_topk_ref(S, T, al, 16)[0], ex),
                ("B1 best", b1[0], b1r[0], ex[..., 0]),
                ("B1 second", b1[1], b1r[1], ex[..., 1])):
            err = (got.double() - want).abs().max().item()
            ok &= err <= ATOL
            print(f"{name}, unit samples vs {tag} tokens of norm ~11 "
                  f"(|value| <= {want.abs().max().item():.1f}) against "
                  f"float64: kernel {err:.2e}, plain "
                  f"{(plain.double() - want).abs().max().item():.2e}")
    db = torch.randn(37, 130, 128, device="cuda", generator=g).bfloat16()
    for tag, qq_ in (("fp32", qq), ("bf16-exact", qq.bfloat16().float())):
        ok &= near(f"B3 bf16 docs of norm ~11, {tag} queries",
                   cm.colbert_maxsim_multi_op(qq_, db, dm, qm),
                   exact("qld,nmd->qnlm", qq_, db, dm, qm),
                   cm_ref.colbert_maxsim_multi_ref(qq_, db, dm, qm))
    print("score_check: " + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
