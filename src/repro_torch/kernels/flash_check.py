"""Quick card check of B7's fp32 route (``csrc/flash_attention.cu``,
namespace ``sm90_f32``).

    PYTHONPATH=src python -m repro_torch.kernels.flash_check

Builds ``flash_attention`` and prints its ptxas report.  Then, on fp32
randn inputs (seed 0), it runs the kernel against its plain version
within 2e-4 at BERT4Rec's serving shape (512 sequences x 2 heads, S
200, d 32, non-causal), with the kernel's and the plain version's
errors against a float64 softmax beside, and at chip_smoke.py's
phase-10 LM shapes widened to fp32 (4 prompts x 2,048, causal: 24 / 8
heads at d 128, 32 / 32 at d 80, a 512 window, 40 / 8 at d 128).  At
each shape it times the kernel twice (CUDA events, mean of 5 after a
warm-up), the plain version and ``scaled_dot_product_attention``, beside
the route's bound: 24·d flops a visible pair on the bf16 tensor cores
(its 12 split products) or the bytes of q, k, v and o, the larger.

The script reaches the kernel only through the wrapper and ``build``'s
public functions, so it times another checkout's kernel when that
checkout's ``src`` comes first on the path:

    PYTHONPATH=<checkout>/src python - < src/repro_torch/kernels/flash_check.py

It needs a CUDA device and exits non-zero on a disagreement past 2e-4.
The card tests (``pytest -m cuda tests/test_torch_flash_attention.py``)
hold the route at every head dim and mask, and ``chip_smoke.py`` on the
paths' own tensors; this is the short first call after a change to it.
"""

from __future__ import annotations

import math
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                     visible)

TOL = 2e-4
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12

SHAPES = [
    # (tag, B, H, KV, S, d, causal, window)
    ("bert4rec", 512, 2, 2, 200, 32, False, None),
    ("prefill", 4, 24, 8, 2048, 128, True, None),
    ("stablelm-3b", 4, 32, 32, 2048, 80, True, None),
    ("window 512", 4, 24, 8, 2048, 128, True, 512),
    ("qwen2.5-32b", 4, 40, 8, 2048, 128, True, None),
]


def _ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _plain(q, k, v, causal, window):
    rep = q.shape[-3] // k.shape[-3]
    return flash_attention_ref(q, k.repeat_interleave(rep, -3),
                               v.repeat_interleave(rep, -3), causal=causal,
                               window=window)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_check needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}")
    secs = build.build_all(("flash_attention",))
    print(f"[build] {build.CSRC / 'flash_attention.cu'} in {secs:.2f} s; "
          f"ptxas: {build.ptxas_report('flash_attention')}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for tag, B, H, KV, S, d, causal, window in SHAPES:
        q = torch.randn((B, H, S, d), generator=gen, device="cuda")
        k, v = (torch.randn((B, KV, S, d), generator=gen, device="cuda")
                for _ in range(2))
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention_op(q, k, v, **kw)
        want = _plain(q, k, v, causal, window)
        err = (got - want).abs().max().item()
        extra = ""
        if tag == "bert4rec":     # non-causal: softmax(q kᵀ/√d) v
            w64 = torch.softmax(q.double() @ k.double().transpose(-1, -2)
                                / math.sqrt(d), -1) @ v.double()
            extra = (f"; vs float64: kernel "
                     f"{(got - w64).abs().max().item():.3e}, plain "
                     f"{(want - w64).abs().max().item():.3e}")
            del w64
        if err > TOL:
            bad.append(f"{tag}: {err:.3e}")
        del got, want
        mask = visible(S, S, causal=causal, window=window, device="cuda")
        pairs = int(mask.sum()) * B * H
        nb = 4 * (2 * q.numel() + 2 * k.numel())
        t_ops, t_bytes = (24 * d * pairs / PEAK_BF16 * 1e3,
                          nb / PEAK_BYTES * 1e3)
        bound = max(t_ops, t_bytes)
        by = ("24·d flops a pair on bf16 tensor cores" if t_ops >= t_bytes
              else "bytes of q, k, v and o")
        rep = H // KV

        def library():
            if window is None:
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=rep > 1)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=rep > 1)

        def kernel():
            return ops.flash_attention_op(q, k, v, **kw)

        t1, t2 = _ms(kernel), _ms(kernel)
        plain_ms = _ms(lambda: _plain(q, k, v, causal, window), reps=2)
        lib_ms = _ms(library)
        print(f"[time] {tag}: B {B} H {H} KV {KV} S {S} d {d} causal "
              f"{causal} window {window} fp32: max_abs_err {err:.3e}{extra}; "
              f"kernel {t1:.4f} / {t2:.4f} ms; plain {plain_ms:.4f} ms; SDPA "
              f"{lib_ms:.4f} ms; bound {bound:.4f} ms ({by}, "
              f"{100 * bound / min(t1, t2):.1f} % of it); "
              f"{pairs} pairs, {nb} bytes")
        del q, k, v, mask
        torch.cuda.empty_cache()
    print(f"[device] {smi}")
    if bad:
        print("flash_check FAILED: " + "; ".join(bad), file=sys.stderr)
        return 1
    print("flash_check ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
