"""Plain PyTorch version of the flash-attention forward kernel.

Counterpart of ``repro.kernels.flash_attention.ref``: softmax(q kᵀ/√d)
v with the causal and sliding-window masks, computed in fp32 on
fp32-widened inputs and cast to q's type.  It materializes the
(..., Sq, Sk) score tensor the kernel exists to avoid.
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


def visible(sq: int, sk: int, *, causal: bool, window: int | None,
            row0: int = 0, device=None) -> torch.Tensor:
    """(sq, sk) bool: key j is visible to query i = row0 + r of row r
    (``j <= i`` if causal, ``j > i - window`` if windowed), the
    reference's ``vis`` rule."""
    ii = row0 + torch.arange(sq, device=device)[:, None]
    jj = torch.arange(sk, device=device)[None, :]
    vis = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        vis &= jj <= ii
    if window is not None:
        vis &= jj > ii - window
    return vis


def flash_attention_ref(q, k, v, *, causal: bool = False,
                        window: int | None = None):
    """q: (..., H, Sq, d); k, v: (..., H, Sk, d) -> (..., H, Sq, d)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    vis = visible(q.shape[-2], k.shape[-2], causal=causal, window=window,
                  device=q.device)
    s = torch.where(vis, s, NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", w, v.float()).to(q.dtype)
