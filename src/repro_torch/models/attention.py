"""Full-sequence, non-causal attention with a key-padding mask and RoPE.

Counterpart of the full-sequence branch of
``repro.models.attention.attention`` (``chunk=None``, ``causal=False``,
no window).  Written as the reference writes it — matmul, mask, fp32
softmax, cast back — and not through ``scaled_dot_product_attention``,
so the two packages round at the same places.  Decode and the chunked
branch are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.common import rope

NEG = -1e30


class Attention(nn.Module):
    """Multi-head attention; ``n_kv_heads == n_heads`` (ColBERT's BERT
    backbone has no grouped heads)."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *,
                 dtype=torch.float32):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        inner = n_heads * head_dim
        self.wq = nn.Linear(d_model, inner, bias=False, dtype=dtype)
        self.wk = nn.Linear(d_model, inner, bias=False, dtype=dtype)
        self.wv = nn.Linear(d_model, inner, bias=False, dtype=dtype)
        self.wo = nn.Linear(inner, d_model, bias=False, dtype=dtype)

    def forward(self, x, *, attn_mask=None, rope_theta: float | None = 1e4):
        """x: (B, S, D); attn_mask: (B, S) key-padding mask."""
        B, S, _ = x.shape
        H, hd = self.n_heads, self.head_dim
        q = self.wq(x).view(B, S, H, hd)
        k = self.wk(x).view(B, S, H, hd)
        v = self.wv(x).view(B, S, H, hd)
        if rope_theta is not None:
            pos = torch.arange(S, device=x.device)[None, :]
            q, k = rope(q, pos, rope_theta), rope(k, pos, rope_theta)
        scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(hd)
        if attn_mask is not None:
            scores = torch.where(attn_mask[:, None, None, :], scores, NEG)
        w = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = torch.einsum("bhij,bjhd->bihd", w, v).reshape(B, S, H * hd)
        return self.wo(ctx)
