"""Shared neural building blocks.

Counterpart of ``repro.models.common``: the same arithmetic, with the
same places of fp32 upcast, on torch tensors.  Matrices are created in
the reference's (in, out) layout; modules store them as ``nn.Linear``
weights, (out, in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(generator, in_dim, out_dim, dtype=torch.float32, scale=None):
    """(in_dim, out_dim) normal matrix scaled by 1/sqrt(in_dim)."""
    scale = scale if scale is not None else in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return (w * scale).to(dtype)


def embed_init(generator, vocab, dim, dtype=torch.float32, scale=0.02):
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)


def rms_norm(x, gamma, eps=1e-6):
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * gamma.float()).to(dt)


def layer_norm(x, gamma, beta, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def rope(x, positions, theta: float = 1e4):
    """Rotary position embedding. x: (..., seq, heads, head_dim);
    positions: (..., seq) — (1, S) for a prefill, (B, 1) per row for a
    decode step."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rounded_einsum(eq, a, b):
    """``torch.einsum`` of two operands of one dtype, computed in fp32
    and rounded once to that dtype — where the reference's HLO rounds a
    bf16 dot (fp32 accumulation, one rounding of the result).  torch's
    own bf16 batched product takes another path by host (on the CPU, by
    instruction set) and can land an element one bf16 step away."""
    if a.dtype == torch.float32:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, w_gate, w_up, w_down):
    """silu(x W_gate) * (x W_up) W_down with ``nn.Linear`` modules."""
    return w_down(F.silu(w_gate(x)) * w_up(x))


def mlp(x, ws, bs=None, act=F.relu, final_act: bool = False):
    """Plain MLP over the last axis; ``ws`` a list of (in, out) weights
    (the reference's layout, ``x @ w``), ``bs`` their biases or None."""
    h = x
    for i, w in enumerate(ws):
        h = h @ w
        if bs is not None and bs[i] is not None:
            h = h + bs[i]
        if i < len(ws) - 1 or final_act:
            h = act(h)
    return h
