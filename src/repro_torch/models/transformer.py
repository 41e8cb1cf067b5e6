"""Transformer LM: dense blocks, GQA, optional sliding window, RoPE.

Counterpart of ``repro.models.transformer``: causal LM (prefill and
KV-cache decode) and bidirectional encoder (the ColBERT backbone).  The
reference stacks layers on a leading axis for ``lax.scan``; here they
are an ``nn.ModuleList``.  The LM head is ``lm_head`` or, with
``tie_embeddings``, the embedding table transposed.

The full-sequence attention of every layer takes a ``backend``
(``models.attention``): ``fused`` runs the flash-attention kernel (B7),
``reference`` the reference's arithmetic.  Decode is plain torch and
updates the stacked KV cache in place.

Not ported yet: MoE blocks (``moe_experts > 0`` raises; ROADMAP § A item
16) and training, so ``remat``, ``remat_attn_chunk`` and
``capacity_factor`` are carried for parity with the reference's config
and read by nothing here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import Attention, KVCache, decode_attention
from repro_torch.models.common import dense_init, embed_init, rms_norm, swiglu


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
    """Pre-norm block: GQA attention, then the dense SwiGLU FFN."""

    def __init__(self, cfg: LMConfig):
        super().__init__()
        dt = cfg.param_dtype
        self.cfg = cfg
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.hd,
                              n_kv_heads=cfg.n_kv_heads,
                              qkv_bias=cfg.qkv_bias, dtype=dt)
        self.w_gate = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.w_up = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.w_down = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, dtype=dt)

    def _ffn(self, x):
        return x + swiglu(rms_norm(x, self.ln2), self.w_gate, self.w_up,
                          self.w_down)

    def forward(self, x, attn_mask=None, window=None, backend=None):
        cfg = self.cfg
        h = self.attn(rms_norm(x, self.ln1), causal=cfg.causal,
                      window=window, rope_theta=cfg.rope_theta,
                      attn_mask=attn_mask, chunk=cfg.attn_chunk,
                      backend=backend)
        return self._ffn(x + h)

    def decode(self, x, cache: KVCache, pos: int, window=None):
        h, _ = decode_attention(self.attn, rms_norm(x, self.ln1), cache, pos,
                                window=window,
                                rope_theta=self.cfg.rope_theta)
        return self._ffn(x + h)


class Transformer(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        if cfg.moe_experts:
            raise NotImplementedError(
                f"{cfg.name}: MoE blocks (models/moe.py) are not ported yet "
                f"(ROADMAP § A item 16)")
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
        x = self._embed(tokens)
        for layer in self.layers:
            x = layer(x, attn_mask, window, backend)
        return rms_norm(x, self.ln_f)

    def hidden_states(self, tokens, attn_mask=None, *, backend=None):
        """Final-layer hidden states (B, S, D) of token ids (B, S)."""
        return self._final(tokens, attn_mask, self.cfg.window, backend)

    def forward(self, tokens, attn_mask=None, *, window="cfg", backend=None):
        """Full-sequence forward -> logits (B, S, vocab)."""
        if window == "cfg":
            window = self.cfg.window
        return self.logits(self._final(tokens, attn_mask, window, backend))

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
    N(0, 1/in_dim), an untied head N(0, 0.02), biases 0, norm gains 1.
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
        for lin in (layer.attn.wq, layer.attn.wk, layer.attn.wv,
                    layer.attn.wo, layer.w_gate, layer.w_up, layer.w_down):
            lin.weight.copy_(dense_init(generator, lin.in_features,
                                        lin.out_features, dt).T)
            if lin.bias is not None:
                lin.bias.zero_()
    if model.lm_head is not None:
        model.lm_head.weight.copy_(dense_init(
            generator, cfg.d_model, cfg.vocab, dt, scale=0.02).T)
    return model.eval()
