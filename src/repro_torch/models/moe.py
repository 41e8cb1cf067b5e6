"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Counterpart of ``repro.models.moe``: tokens are routed in fp32 to their
top-k experts, sorted by expert id and sliced into an (E, cap, D)
buffer per block of tokens; an expert's tokens beyond its capacity are
dropped (their residual passes through).  Aux losses: load balance
(Switch-style) and the router z-loss.

The reference's semantics are kept exactly, because a token's drop
depends on all of them:

* blocking: T tokens split into ``nb = T // block_tokens`` blocks when
  that divides T, else one; capacity per block
  ``max(1, ceil(cf * tb * k / E))``;
* the router product in fp32 (TF32 is off, ``core.backend``), softmax,
  top-k with ties to the lowest expert id (a stable descending sort, as
  ``lax.top_k`` orders them), renormalised with a 1e-9 floor;
* a stable sort of the token-major (token, rank) slots by expert id, so
  the earliest tokens of a block win an expert's capacity;
* the experts' SwiGLU as three batched products over (block, expert),
  bf16 ones in fp32 rounded once (``common.rounded_einsum``), and the
  SiLU op by op (:func:`silu`);
* each kept output times its gate in fp32, cast to x's dtype, and a
  token's k terms summed in x's dtype in expert-ascending order.

The port gathers where the reference scatters: buffer cell (b, e, c) is
the token at sorted position ``first[e] + c`` (zero past the expert's
count), and a token's outputs are read back from the cells its kept
entries occupy.  Both gathers go through ``core.segment.take_rows``, so
their backward adds a row's repeats (a token sent to k experts) in a
fixed order, and the sum over a token's k terms is a fixed sequence of
adds, never ``index_add_``'s atomics: serving and a resumed training
run are bit-equal from run to run on the card.

A placed step (``sharding.placed``) runs the layer once a position, on
that position's rows, under :func:`coupled`: its hook gives each
layer's load-balance loss the expert counts of every position, and may
compute the experts' SwiGLU on the positions that own them.  A remat
recomputation runs under the same hook (:func:`remat_context`).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager, nullcontext

import torch
from torch import nn

from repro_torch.core.segment import take_rows
from repro_torch.models.common import dense_init, rounded_einsum
from repro_torch.sharding.specs import constrain, note_topk

BLOCK_TOKENS = 2048          # a dispatch block's tokens (``Block`` keeps it)


class Local:
    """The hook of an MoE layer outside :func:`coupled`: ``ce(layer,
    counts, slots)`` gives the load-balance loss's expert shares from
    the call's own expert counts (E,) and its ``T * top_k`` slots, and
    ``experts(layer, buf, swiglu)`` the experts' outputs on the dispatch
    buffer, computed by ``swiglu`` (:func:`expert_swiglu`) where the
    layer runs.  ``layer`` is the :class:`MoE` module."""

    def ce(self, layer, counts, slots):
        return counts.float() / slots

    def experts(self, layer, buf, swiglu):
        return swiglu(buf, layer.w_gate, layer.w_up, layer.w_down)


LOCAL = Local()
_hook = threading.local()


def _current() -> Local:
    return getattr(_hook, "value", LOCAL)


@contextmanager
def coupled(hook):
    """Route every MoE layer of this thread through ``hook`` (a
    :class:`Local` that overrides what it couples) for the enclosed
    region."""
    prev = _current()
    _hook.value = hook
    try:
        yield hook
    finally:
        _hook.value = prev


def remat_context():
    """``torch.utils.checkpoint``'s ``context_fn``: the recomputation of
    a checkpointed block runs under the hook its forward ran under (on
    the card the backward, and so the recomputation, runs on autograd's
    device thread, which starts with no hook)."""
    return nullcontext(), coupled(_current())


class MoE(nn.Module):
    """The reference's ``MoEParams``: ``router`` (d_model, E) in fp32
    whatever the parameter dtype, ``w_gate`` and ``w_up`` (E, d_model,
    d_ff), ``w_down`` (E, d_ff, d_model) in ``dtype`` — the reference's
    layouts, ``x @ W``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(
            (d_model, n_experts), dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty((n_experts, d_model, d_ff),
                                               **kw))
        self.w_up = nn.Parameter(torch.empty((n_experts, d_model, d_ff),
                                             **kw))
        self.w_down = nn.Parameter(torch.empty((n_experts, d_ff, d_model),
                                               **kw))

    def forward(self, x, *, top_k: int, capacity_factor: float = 1.25,
                block_tokens: int = BLOCK_TOKENS, aux: bool = True):
        return moe_ffn(self, x, top_k=top_k, capacity_factor=capacity_factor,
                       block_tokens=block_tokens, aux=aux)


@torch.no_grad()
def init_moe_(moe: MoE, generator: torch.Generator) -> MoE:
    """Fill ``moe`` in place from ``generator`` (on the module's device)
    with the reference's distributions: the router N(0, 1/d_model) in
    fp32, each expert matrix N(0, 1) / √in cast to its dtype."""
    d_model, n_experts = moe.router.shape
    moe.router.copy_(dense_init(generator, d_model, n_experts))
    for w in (moe.w_gate, moe.w_up, moe.w_down):
        e, i, o = w.shape
        draw = torch.randn((e, i, o), generator=generator,
                           dtype=torch.float32, device=generator.device)
        w.copy_((draw / math.sqrt(i)).to(w.dtype))
    return moe


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype=torch.float32) -> MoE:
    """An :class:`MoE` on ``generator``'s device, filled by
    :func:`init_moe_`."""
    return init_moe_(MoE(d_model, d_ff, n_experts, dtype,
                         device=generator.device), generator)


def silu(x):
    """``jax.nn.silu`` op by op, ``x * (1 / (1 + exp(-x)))``, each step
    rounded to x's dtype as the reference's HLO rounds it (bf16:
    ``F.silu`` rounds once and lands a step away)."""
    return x * (1 / (1 + torch.exp(-x)))


def top_k_ids(probs, k: int):
    """The indices of the k largest entries of the last axis in
    descending order, equal values by ascending index (``lax.top_k``'s
    order; ``torch.topk`` promises none)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def capacity(tb: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    return max(1, math.ceil(capacity_factor * tb * top_k / n_experts))


def n_blocks(T: int, block_tokens: int) -> int:
    return max(1, T // block_tokens) if T % block_tokens == 0 else 1


def route(p: MoE, xt, top_k: int):
    """The router on blocked tokens xt (nb, tb, D): (fp32 logits (nb,
    tb, E), probs, expert ids (nb, tb, k) int64 in descending gate
    order, renormalised gates (nb, tb, k) fp32)."""
    logits = xt.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    expert_ids = top_k_ids(note_topk(probs, "batch", None, None), top_k)
    gates = probs.gather(-1, expert_ids)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, expert_ids, gates


def dispatch(expert_ids, n_experts: int, cap: int):
    """The reference's ``dispatch_block`` for every block at once.
    expert_ids (nb, tb, k) -> (cell_tok (nb, E, cap) the block-local
    token in each buffer cell, cell_ok (nb, E, cap) whether the cell
    holds one, slot (nb, tb, k) each entry's rank within its expert,
    counts (nb, E) entries routed to each expert)."""
    nb, tb, k = expert_ids.shape
    n = tb * k
    flat = expert_ids.reshape(nb, n)
    se, order = torch.sort(flat, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=flat.device).expand(
        nb, n_experts).contiguous()
    first = torch.searchsorted(se, experts)                  # (nb, E)
    counts = torch.searchsorted(se, experts, right=True) - first
    pos = torch.arange(n, device=flat.device).expand(nb, n)
    slot_sorted = pos - first.gather(-1, se)
    slot = torch.empty_like(slot_sorted).scatter_(-1, order, slot_sorted)
    c = torch.arange(cap, device=flat.device)
    cell_ok = c < counts[..., None]                          # (nb, E, cap)
    cell_pos = (first[..., None] + c).clamp(max=n - 1).reshape(nb, -1)
    cell_tok = (order.gather(-1, cell_pos) // k).reshape(nb, n_experts, cap)
    return cell_tok, cell_ok, slot.reshape(nb, tb, k), counts


def expert_swiglu(buf, w_gate, w_up, w_down):
    """The experts' SwiGLU on a dispatch buffer (nb, E, cap, D) with
    their (E, ...) weights, batched over blocks and experts."""
    g = rounded_einsum("becd,edf->becf", buf, w_gate)
    u = rounded_einsum("becd,edf->becf", buf, w_up)
    h = constrain(silu(g) * u, "batch", "expert", None, "ffn")
    return constrain(rounded_einsum("becf,efd->becd", h, w_down),
                     "batch", "expert", None, "embed")


def moe_ffn(p: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
            block_tokens: int = BLOCK_TOKENS, aux: bool = True):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux {"load_balance",
    "router_z"} 0-d fp32, or None when not ``aux``), the reference's
    ``moe_ffn`` (module docstring)."""
    B, S, D = x.shape
    T = B * S
    E = p.router.shape[1]
    nb = n_blocks(T, block_tokens)
    tb = T // nb
    cap = capacity(tb, top_k, E, capacity_factor)
    xt = constrain(x.reshape(nb, tb, D), "batch", None, "embed")
    logits, probs, expert_ids, gates = route(p, xt, top_k)
    cell_tok, cell_ok, slot, counts = dispatch(expert_ids, E, cap)
    hook = _current()

    # ---- aux losses ----
    losses = None
    if aux:
        me = probs.mean(dim=(0, 1))                             # (E,)
        ce = hook.ce(p, counts.sum(0), T * top_k)
        losses = {"load_balance": E * torch.sum(me * ce),
                  "router_z": torch.logsumexp(logits, dim=-1).square().mean()}

    # ---- dispatch: buffer cells gather their tokens ----
    base = (torch.arange(nb, device=x.device) * tb)[:, None, None]
    buf = take_rows(x.reshape(T, D), cell_tok + base)           # (nb,E,cap,D)
    buf = constrain(torch.where(cell_ok[..., None], buf, 0),
                    "batch", "expert", None, "embed")

    # ---- expert FFN (SwiGLU), batched over blocks ----
    out_buf = hook.experts(p, buf, expert_swiglu)

    # ---- combine: a token's kept outputs, expert-ascending ----
    ex, r = torch.sort(expert_ids, dim=-1)                      # (nb, tb, k)
    slot = slot.gather(-1, r)
    keep = slot < cap
    cell = ((torch.arange(nb, device=x.device)[:, None, None] * E + ex) * cap
            + slot.clamp(max=cap - 1))
    eo = take_rows(out_buf.reshape(-1, D), cell)                # (nb,tb,k,D)
    eo = torch.where(keep[..., None], eo, 0)
    terms = (eo.float() * gates.gather(-1, r)[..., None]).to(x.dtype)
    y = terms[:, :, 0]
    for j in range(1, top_k):
        y = y + terms[:, :, j]
    y = constrain(y, "batch", None, "embed")
    return y.reshape(B, S, D), losses
