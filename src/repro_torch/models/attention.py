"""GQA attention: full / causal / sliding-window, prefill + KV-cache decode.

Counterpart of ``repro.models.attention``: :class:`Attention` holds the
reference's ``AttnParams`` (``wq``, ``wk``, ``wv``, ``wo`` and the
optional q/k/v biases) and its ``forward`` is the reference's
``attention()``; :class:`KVCache`, :func:`init_cache` and
:func:`decode_attention` are the decode path.

The full-sequence branch has two backends (``core.backend.SERVING``):

* ``reference`` — the reference's arithmetic, rounding at the same
  places: the score einsum rounded to the compute dtype (accumulated in
  fp32, ``common.rounded_einsum``), the division by √hd,
  the masks, softmax in fp32, the cast back, the P·V einsum.  With
  ``chunk`` shorter than the sequence it runs the reference's blocked
  branch, one query chunk at a time, so the live score buffer is
  (B, H, chunk, S); with ``remat_chunk`` (the reference's) a chunk's
  scores are recomputed in the backward pass instead of kept.
* ``fused`` — the flash-attention kernel (``kernels.flash_attention``,
  B7) when there is no key-padding mask: the same function with fp32
  scores, p and P·V, and nothing (S, S)-shaped in device memory.  The
  key-padding branch (the ColBERT encoder) stays plain on both
  backends, as in the reference: the kernel takes no key mask.

The default is ``fused`` on CUDA and ``reference`` on the CPU.  Decode
is plain torch on both, as in the reference, and so is
:func:`attention_weights_received` (the attention pruning baseline).

Cache layout (per layer): k, v (batch, kv_heads, cache_len, head_dim);
cache_len is max_len for full attention and ``window`` (a ring buffer)
for sliding-window attention.  :func:`decode_attention` writes the new
token's k and v into the cache in place (the reference returns a new
cache; the port returns the same one).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import backend as backend_lib
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.kernels.flash_attention.ref import visible
from repro_torch.models.common import rope, rounded_einsum
from repro_torch.sharding.specs import constrain, note_attention

NEG = -1e30


class Attention(nn.Module):
    """Grouped-query attention (``n_kv_heads`` divides ``n_heads``;
    ``n_kv_heads=None`` is multi-head).  Matrices are ``nn.Linear``
    weights, (out, in); ``qkv_bias`` adds the q/k/v biases."""

    def __init__(self, d_model: int, n_heads: int, head_dim: int, *,
                 n_kv_heads: int | None = None, qkv_bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        n_kv_heads = n_kv_heads or n_heads
        if n_heads % n_kv_heads:
            raise ValueError(f"{n_heads} heads are no multiple of "
                             f"{n_kv_heads} KV heads")
        self.n_heads, self.n_kv_heads, self.head_dim = (n_heads, n_kv_heads,
                                                        head_dim)
        inner, kv_inner = n_heads * head_dim, n_kv_heads * head_dim
        self.wq = nn.Linear(d_model, inner, bias=qkv_bias, dtype=dtype)
        self.wk = nn.Linear(d_model, kv_inner, bias=qkv_bias, dtype=dtype)
        self.wv = nn.Linear(d_model, kv_inner, bias=qkv_bias, dtype=dtype)
        self.wo = nn.Linear(inner, d_model, bias=False, dtype=dtype)

    def _project_qkv(self, x):
        """(B, S, D) -> q (B, S, H, hd), k and v (B, S, KV, hd); the bias
        is added after the product, as the reference adds it."""
        B, S, _ = x.shape
        out = []
        for lin, heads in ((self.wq, self.n_heads), (self.wk, self.n_kv_heads),
                           (self.wv, self.n_kv_heads)):
            y = F.linear(x, lin.weight)
            if lin.bias is not None:
                y = y + lin.bias
            out.append(y.view(B, S, heads, self.head_dim))
        return out

    def forward(self, x, *, causal: bool = False, window: int | None = None,
                rope_theta: float | None = 1e4, attn_mask=None,
                positions=None, chunk: int | None = None,
                remat_chunk: bool = False, backend: str | None = None):
        """Full-sequence attention (prefill / encoder). x: (B, S, D);
        attn_mask: (B, S) key-padding mask; positions: (B or 1, S).
        ``remat_chunk``: on the blocked plain branch, while autograd
        records, each query chunk runs under ``torch.utils.checkpoint``
        (non-reentrant, so it nests in a block's checkpoint): its scores
        and softmax are recomputed in the backward pass instead of kept,
        the same arithmetic, so outputs and gradients are bit-equal."""
        B, S, _ = x.shape
        H, KV, hd = self.n_heads, self.n_kv_heads, self.head_dim
        q, k, v = self._project_qkv(x)
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        if rope_theta is not None:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
        q = constrain(q, "batch", "seq", "heads", None)
        k = constrain(k, "batch", "seq", "kv_heads", None)
        v = constrain(v, "batch", "seq", "kv_heads", None)
        note_attention(q, k, chunk)
        backend = backend_lib.resolve_backend(
            backend, allow=backend_lib.SERVING, device=x.device)
        if backend == backend_lib.FUSED and attn_mask is None:
            ctx = flash_attention_op(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=causal, window=window)
            ctx = ctx.transpose(1, 2)
        else:
            qg = q.view(B, S, KV, H // KV, hd)
            if chunk is None or chunk >= S:
                ctx = _attend(qg, k, v, 0, causal, window, attn_mask)
            else:
                attend = _attend
                if remat_chunk and torch.is_grad_enabled():
                    attend = functools.partial(checkpoint, _attend,
                                               use_reentrant=False)
                ctx = torch.cat([attend(qg[:, c:c + chunk], k, v, c, causal,
                                        window, attn_mask)
                                 for c in range(0, S, chunk)], dim=1)
        ctx = constrain(ctx.reshape(B, S, H * hd), "batch", "seq", "heads")
        return F.linear(ctx, self.wo.weight)


def _scaled(s, hd):
    """s / √hd with √hd rounded to s's dtype first, as the reference's
    ``/ jnp.sqrt(head_dim)`` rounds its weak fp32 scalar (bf16: 11.3125
    for hd 128, not 11.3137); fp32 is unchanged."""
    return s / torch.tensor(math.sqrt(hd), dtype=s.dtype, device=s.device)


def _attend(qg, k, v, row0, causal, window, attn_mask):
    """The reference's score -> mask -> fp32 softmax -> P·V for query
    rows ``row0 + i`` of qg (B, c, KV, G, hd) against every key; one
    query chunk of the blocked branch, or all of them."""
    c, S, hd = qg.shape[1], k.shape[1], qg.shape[-1]
    s = _scaled(rounded_einsum("bikgh,bjkh->bkgij", qg, k), hd)
    if causal or window is not None:     # else every key is visible
        s = torch.where(visible(c, S, causal=causal, window=window,
                                row0=row0, device=qg.device), s, NEG)
    if attn_mask is not None:
        s = torch.where(attn_mask[:, None, None, None, :], s, NEG)
    w = torch.softmax(s.float(), dim=-1).to(qg.dtype)
    return rounded_einsum("bkgij,bjkh->bikgh", w, v)


def attention_weights_received(attn: Attention, x, *, attn_mask=None,
                               rope_theta: float | None = None):
    """Mean attention mass each token receives (column sums), for the
    attention-score pruning baseline [17, 20]; bidirectional.  x (B, S,
    D), attn_mask (B, S) key padding -> (B, S) fp32: the key-masked fp32
    softmax of every query row, averaged over heads and query rows."""
    B, S, _ = x.shape
    H, KV, hd = attn.n_heads, attn.n_kv_heads, attn.head_dim
    q, k, _ = attn._project_qkv(x)
    if rope_theta is not None:
        pos = torch.arange(S, device=x.device)[None, :]
        q, k = rope(q, pos, rope_theta), rope(k, pos, rope_theta)
    qg = q.view(B, S, KV, H // KV, hd)
    s = _scaled(rounded_einsum("bikgh,bjkh->bkgij", qg, k), hd)
    if attn_mask is not None:
        s = torch.where(attn_mask[:, None, None, None, :], s, NEG)
    return torch.softmax(s.float(), dim=-1).mean(dim=(1, 2, 3))


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, kv_heads, C, head_dim)
    v: torch.Tensor    # (B, kv_heads, C, head_dim)


def init_cache(batch, n_kv_heads, cache_len, head_dim, dtype,
               device=None) -> KVCache:
    shape = (batch, n_kv_heads, cache_len, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def decode_attention(attn: Attention, x, cache: KVCache, pos: int, *,
                     window: int | None = None,
                     rope_theta: float | None = 1e4):
    """One-token decode. x: (B, 1, D); pos: the current position (an
    int).  Writes the token's k and v into ``cache`` in place and
    returns (out (B, 1, D), cache).

    Full attention: the cache holds positions [0, C); slot = pos.
    Sliding window: the cache is a ring buffer of size C = window;
    slot = pos % C and only the last C positions are visible.
    """
    B = x.shape[0]
    H, KV, hd = attn.n_heads, attn.n_kv_heads, attn.head_dim
    pos = int(pos)
    q, k, v = attn._project_qkv(x)
    if rope_theta is not None:
        pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q, pos_b, rope_theta)
        k = rope(k, pos_b, rope_theta)
    C = cache.k.shape[2]
    slot = pos % C
    cache.k[:, :, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, :, slot] = v[:, 0].to(cache.v.dtype)
    constrain(cache.k, "batch", "kv_heads", "kv_len", None)
    constrain(cache.v, "batch", "kv_heads", "kv_len", None)

    qg = q.view(B, KV, H // KV, hd)
    s = _scaled(rounded_einsum("bkgh,bkjh->bkgj", qg, cache.k), hd)
    j = torch.arange(C, device=x.device)
    if window is None:
        valid = j <= pos
    else:
        # Ring buffer: slot j holds absolute position pos - ((slot - j)
        # mod C); it is valid once written (>= 0), and age < C bounds it
        # to the window.
        valid = (pos - (slot - j) % C) >= 0
    s = torch.where(valid, s, NEG)
    w = torch.softmax(s.float(), dim=-1).to(x.dtype)
    ctx = rounded_einsum("bkgj,bkjh->bkgh", w, cache.v).reshape(B, 1,
                                                           H * hd)
    ctx = constrain(ctx, "batch", "seq", "heads")
    return F.linear(ctx, attn.wo.weight), cache
