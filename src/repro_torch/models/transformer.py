"""Transformer LM: dense and MoE blocks, GQA, optional sliding window, RoPE.

Counterpart of ``repro.models.transformer``: causal LM (prefill, KV-cache
decode and training) and bidirectional encoder (the ColBERT and
BERT4Rec backbones).  The reference stacks layers on a leading axis for
``lax.scan``; here they are an ``nn.ModuleList``.  The LM head is
``lm_head`` or, with ``tie_embeddings``, the embedding table
transposed.  A block's FFN is the dense SwiGLU, or with ``moe_experts``
the mixture of experts of ``models.moe`` (top-k routing with capacity
``capacity_factor``), which also returns the block's aux losses; a
dense block returns none, and :meth:`Transformer.forward_aux` gives a
dense model constant zeros.

The full-sequence attention of every layer takes a ``backend``
(``models.attention``): ``fused`` runs the flash-attention kernel (B7),
``reference`` the reference's arithmetic; training runs ``reference``
(neither package has a B7 backward).  Decode is plain torch and updates
the stacked KV cache in place.  With ``remat`` each block runs under
``torch.utils.checkpoint`` while autograd records (the reference's
``jax.checkpoint``; its recomputation under the MoE hook of its forward,
``moe.remat_context``), so a training step keeps one block's activations
at a time; with ``remat_attn_chunk`` each query chunk of the blocked
plain attention is recomputed too, inside its block's recomputation
(``Attention.forward``'s ``remat_chunk``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import Attention, KVCache, decode_attention
from repro_torch.models.common import dense_init, embed_init, rms_norm, swiglu
from repro_torch.models.moe import MoE, init_moe_, remat_context
from repro_torch.sharding.specs import constrain


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // n_heads
    moe_experts: int = 0               # 0 -> dense FFN
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    qkv_bias: bool = False
    window: int | None = None          # sliding-window attention
    attn_window_serving: int | None = None  # window used only for long-ctx serving
    rope_theta: float = 1e4
    causal: bool = True                # False -> bidirectional encoder
    tie_embeddings: bool = False
    attn_chunk: int | None = None      # blocked attention chunk (long seqs)
    remat_attn_chunk: bool = False
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
        if self.moe_experts:
            ffn = self.moe_experts * 3 * d * f + d * self.moe_experts
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of E experts)."""
        if not self.moe_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_ffn = self.moe_experts * 3 * d * f
        active_ffn = self.moe_top_k * 3 * d * f
        return self.param_count() - self.n_layers * (dense_ffn - active_ffn)


class Block(nn.Module):
    """Pre-norm block: GQA attention, then the dense SwiGLU FFN or, with
    ``cfg.moe_experts``, the MoE FFN (``moe``)."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        dt = cfg.param_dtype
        self.cfg = cfg
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.hd,
                              n_kv_heads=cfg.n_kv_heads,
                              qkv_bias=cfg.qkv_bias, dtype=dt)
        if cfg.moe_experts:
            self.moe = MoE(cfg.d_model, cfg.d_ff, cfg.moe_experts, dt)
        else:
            self.w_gate = nn.Linear(cfg.d_model, cfg.d_ff, bias=False,
                                    dtype=dt)
            self.w_up = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
            self.w_down = nn.Linear(cfg.d_ff, cfg.d_model, bias=False,
                                    dtype=dt)

    def _ffn(self, x, aux: bool):
        """(x + FFN(ln2(x)), the MoE block's aux losses when ``aux``,
        else None; a dense block has none)."""
        cfg = self.cfg
        h = rms_norm(x, self.ln2)
        if not cfg.moe_experts:
            return x + swiglu(h, self.w_gate, self.w_up, self.w_down), None
        h, losses = self.moe(h, top_k=cfg.moe_top_k,
                             capacity_factor=cfg.capacity_factor, aux=aux)
        return x + h, losses

    def forward(self, x, attn_mask=None, window=None, backend=None):
        """(x after the block, its aux losses {"load_balance",
        "router_z"} or, dense, None)."""
        cfg = self.cfg
        h = self.attn(rms_norm(x, self.ln1), causal=cfg.causal,
                      window=window, rope_theta=cfg.rope_theta,
                      attn_mask=attn_mask, chunk=cfg.attn_chunk,
                      remat_chunk=cfg.remat_attn_chunk, backend=backend)
        x = constrain(x + h, "batch", "seq", "embed")
        x, aux = self._ffn(x, aux=True)
        return constrain(x, "batch", "seq", "embed"), aux

    def decode(self, x, cache: KVCache, pos: int, window=None):
        h, _ = decode_attention(self.attn, rms_norm(x, self.ln1), cache, pos,
                                window=window,
                                rope_theta=self.cfg.rope_theta)
        x = constrain(x + h, "batch", "seq", "embed")
        return constrain(self._ffn(x, aux=False)[0], "batch", "seq", "embed")


class Transformer(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model,
                                  dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model,
                                            dtype=cfg.param_dtype))
        self.lm_head = (None if cfg.tie_embeddings else
                        nn.Linear(cfg.d_model, cfg.vocab, bias=False,
                                  dtype=cfg.param_dtype))

    def _embed(self, tokens):
        return self.embed(tokens).to(self.cfg.compute_dtype)

    def logits(self, x):
        """The LM head on final hidden states x (..., D) -> (..., vocab):
        ``x @ lm_head`` or, tied, ``x @ embed.T``."""
        head = self.embed if self.lm_head is None else self.lm_head
        return F.linear(x, head.weight.to(self.cfg.compute_dtype))

    def _final(self, tokens, attn_mask, window, backend):
        """(final hidden states (B, S, D), the MoE blocks' aux losses, a
        list with one dict a layer, empty when dense)."""
        x = constrain(self._embed(tokens), "batch", "seq", "embed")
        remat = self.cfg.remat and torch.is_grad_enabled()
        auxs = []
        for layer in self.layers:
            if remat:
                x, aux = checkpoint(layer, x, attn_mask, window, backend,
                                    use_reentrant=False,
                                    context_fn=remat_context)
            else:
                x, aux = layer(x, attn_mask, window, backend)
            if aux is not None:
                auxs.append(aux)
        return rms_norm(x, self.ln_f), auxs

    def hidden_states(self, tokens, attn_mask=None, *, backend=None):
        """Final-layer hidden states (B, S, D) of token ids (B, S)."""
        return self._final(tokens, attn_mask, self.cfg.window, backend)[0]

    def forward_aux(self, tokens, attn_mask=None, *, window="cfg",
                    backend=None):
        """The reference's ``forward``: (logits (B, S, vocab), aux
        {"load_balance", "router_z"} 0-d fp32, each the mean over
        layers, zeros from a dense block)."""
        if window == "cfg":
            window = self.cfg.window
        x, auxs = self._final(tokens, attn_mask, window, backend)
        if auxs:
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        else:
            zero = torch.zeros((), device=x.device)
            aux = {"load_balance": zero, "router_z": zero}
        return constrain(self.logits(x), "batch", "seq", "vocab"), aux

    def forward(self, tokens, attn_mask=None, *, window="cfg", backend=None):
        """Full-sequence forward -> logits (B, S, vocab)."""
        if window == "cfg":
            window = self.cfg.window
        return constrain(self.logits(self._final(tokens, attn_mask, window,
                                                 backend)[0]),
                         "batch", "seq", "vocab")

    def init_cache(self, batch: int, max_len: int, *, window=None):
        """Stacked per-layer KV cache {"k", "v"}: (n_layers, batch,
        kv_heads, C, hd) zeros, C = max_len, or min(max_len, window)
        with a window (a ring buffer)."""
        cfg = self.cfg
        w = window if window is not None else cfg.window
        C = min(max_len, w) if w else max_len
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, C, cfg.hd)
        dev = self.embed.weight.device
        return {n: torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
                for n in ("k", "v")}

    def decode_step(self, cache, tokens, pos: int, *, window="cfg"):
        """One decode step. tokens: (B, 1); pos: the position (an int).
        -> (logits (B, 1, vocab), cache), the cache updated in place."""
        if window == "cfg":
            window = self.cfg.window
        x = self._embed(tokens)
        for i, layer in enumerate(self.layers):
            x = layer.decode(x, KVCache(cache["k"][i], cache["v"][i]), pos,
                             window)
        return self.logits(rms_norm(x, self.ln_f)), cache


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: LMConfig,
                device=None) -> Transformer:
    """A randomly initialised LM drawn from ``generator`` on its device,
    with the reference's distributions: embeddings N(0, 0.02), matrices
    N(0, 1/in_dim), an untied head N(0, 0.02), biases 0, norm gains 1,
    MoE leaves as ``models.moe.init_moe`` draws them.
    The module is built without storage and filled in place, so a
    CUDA generator initialises the full-size model on the card."""
    device = torch.device(device or generator.device)
    with torch.device("meta"):
        model = Transformer(cfg)
    model = model.to_empty(device=device)
    dt = cfg.param_dtype
    model.embed.weight.copy_(embed_init(generator, cfg.vocab, cfg.d_model, dt))
    model.ln_f.fill_(1.0)
    for layer in model.layers:
        layer.ln1.fill_(1.0)
        layer.ln2.fill_(1.0)
        lins = [layer.attn.wq, layer.attn.wk, layer.attn.wv, layer.attn.wo]
        if cfg.moe_experts:
            init_moe_(layer.moe, generator)
        else:
            lins += [layer.w_gate, layer.w_up, layer.w_down]
        for lin in lins:
            lin.weight.copy_(dense_init(generator, lin.in_features,
                                        lin.out_features, dt).T)
            if lin.bias is not None:
                lin.bias.zero_()
    if model.lm_head is not None:
        model.lm_head.weight.copy_(dense_init(
            generator, cfg.d_model, cfg.vocab, dt, scale=0.02).T)
    return model.eval()
