"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``).

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention_op``:
the JAX layout q (H, Sq, d), k and v (KV, Sk, d) with H % KV == 0, and
any leading batch dims shared by all three.  Query head h reads KV head
h // (H // KV), the mapping of the reference's ``jnp.repeat``: the
plain version repeats k and v on the CPU; the kernel indexes the KV head
and repeats nothing.

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  The kernel has no backward: where autograd
records and an input requires grad, a CUDA tensor raises
(``build.refuse_grad``) rather than return an output cut from the
graph; the plain version on the CPU is differentiable.
``flash_attention_op.launches`` counts launches.
The kernel takes fp32 or bf16 (q, k and v alike), head dims up to
128 that are multiples of 8, and contiguous 16-byte-aligned tensors.
Both routes are Hopper kernels (TMA loads, ``wgmma``).  fp32
(BERT4Rec's encoder) splits q, k, v and p into three bf16 terms each and
keeps the six products above 2^-24 in two fp32 accumulators: the fp32
function to within fp32 rounding.  bf16 (the LM path) computes Q·Kᵀ and
P·V as P_hi·V + P_lo·V: the same fp32 function to within one bf16
output rounding.

Every query row must see at least one key: with a ``window`` that needs
``window >= 1`` and ``Sq < Sk + window``.  A row that sees no key has
no softmax; there the reference kernel and its oracle disagree (a mean
over the padded and the unpadded keys), so both paths here raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

D_MAX = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, window):
    if q.dim() < 3 or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected (..., H, Sq, d) and "
                         f"two (..., KV, Sk, d)")
    H, sq, d = q.shape[-3:]
    KV, sk, dk = k.shape[-3:]
    if q.shape[:-3] != k.shape[:-3] or dk != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch dims or head dim")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are no multiple of {KV} KV heads")
    if sk < 1:
        raise ValueError("no keys")
    if window is not None and (window < 1 or sq >= sk + window):
        raise ValueError(f"window {window} leaves a query row of Sq={sq} "
                         f"with no visible key among Sk={sk}")
    return H, KV, sq, sk, d


def _launch(q, k, v, causal, window, H, KV, sq, sk, d):
    if d % 8 or d > D_MAX:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         f"up to {D_MAX}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q has dtype {q.dtype}, expected one of "
                         f"{list(DTYPES)}")
    B = math.prod(q.shape[:-3])
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(t, name, q.dtype, t.shape, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    out = torch.empty_like(q)
    build.launch(
        "flash_attention", "flash_attention_launch", q.device, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, sq, sk, d,
        int(causal), window or 0, ctypes.c_float(1.0 / math.sqrt(d)),
        DTYPES[q.dtype], build.stream_ptr(q))
    flash_attention_op.launches += 1
    return out


def flash_attention_op(q, k, v, *, causal: bool = False,
                       window: int | None = None):
    """q: (..., H, Sq, d); k, v: (..., KV, Sk, d) -> (..., H, Sq, d) in
    q's dtype."""
    H, KV, sq, sk, d = _check(q, k, v, window)
    if build.plain(q):
        if H != KV:
            k = k.repeat_interleave(H // KV, dim=-3)
            v = v.repeat_interleave(H // KV, dim=-3)
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    build.refuse_grad("flash_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, window, H, KV, sq, sk, d)


flash_attention_op.launches = 0
