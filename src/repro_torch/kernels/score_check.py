"""Quick card check of the two Hopper score kernels (B2, bf16 B3).

    PYTHONPATH=src python -m repro_torch.kernels.score_check

Builds the kernels, prints the ptxas report of ``maxsim_topk`` and
``colbert_maxsim``, then runs each once at the ``colbert`` main path's
timed shapes on random unit-norm inputs (seed 0) against its plain
version, and times it with CUDA events (mean of 5 after a warm-up):

* B2: 2,048 fp32 samples against 2,908 docs x 180 bf16-exact tokens
  (doc 0 all dead), at k 4 and 16;
* B3: 64 queries x 32 bf16-exact tokens against 3,695 bf16 docs x 128
  (doc 5 all masked), with those queries (one bf16 term) and with them
  scaled by 1 + 2^-12 (three terms).

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
from repro_torch.kernels.maxsim_topk.ops import maxsim_topk_op
from repro_torch.kernels.maxsim_topk.ref import maxsim_topk_ref

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
    secs = build.build_all(("maxsim_topk", "colbert_maxsim"), force=True)
    print(f"build {secs:.2f} s")
    for name in ("maxsim_topk", "colbert_maxsim"):
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
    print("score_check: " + ("ok" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
