"""Bidirectional transformer encoder (dense FFN, RoPE, RMSNorm).

Counterpart of ``repro.models.transformer`` in encoder mode:
``hidden_states`` and ``_block`` with the dense SwiGLU FFN.  The
reference stacks layers on a leading axis for ``lax.scan``; here they
are an ``nn.ModuleList``.  MoE blocks, the LM head and decode are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.common import rms_norm, swiglu


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads


class Block(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        dt = cfg.param_dtype
        self.rope_theta = cfg.rope_theta
        self.ln1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt))
        self.ln2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dt))
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.hd, dtype=dt)
        self.w_gate = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.w_up = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, dtype=dt)
        self.w_down = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, dtype=dt)

    def forward(self, x, attn_mask=None):
        h = self.attn(rms_norm(x, self.ln1), attn_mask=attn_mask,
                      rope_theta=self.rope_theta)
        x = x + h
        h = swiglu(rms_norm(x, self.ln2), self.w_gate, self.w_up,
                   self.w_down)
        return x + h


class Transformer(nn.Module):
    def __init__(self, cfg: LMConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model,
                                  dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.ln_f = nn.Parameter(torch.ones(cfg.d_model,
                                            dtype=cfg.param_dtype))

    def hidden_states(self, tokens, attn_mask=None):
        """Final-layer hidden states (B, S, D) of token ids (B, S)."""
        x = self.embed(tokens).to(self.cfg.compute_dtype)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return rms_norm(x, self.ln_f)
