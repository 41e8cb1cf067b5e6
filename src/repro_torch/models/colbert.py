"""ColBERT-style late-interaction encoder — the paper's own architecture.

Counterpart of ``repro.models.colbert``: a bidirectional transformer
backbone plus a linear projection to the late-interaction dim, then
``norm="sphere"`` (L2 onto S^{n-1}) or ``norm="ball"`` ([27]'s
projection into the unit ball).  Queries are augmented to ``query_len``
with [MASK] tokens; documents carry padding masks.  The encoder also
exports each doc token's received attention (layer 0) for the
attention-score pruning baseline.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.regularizers import ball_projection
from repro_torch.models.attention import attention_weights_received
from repro_torch.models.common import dense_init, embed_init, rms_norm
from repro_torch.models.transformer import LMConfig, Transformer

MASK_ID = 3  # reserved vocab ids: 0=pad, 1=[Q], 2=[D], 3=[MASK]


@dataclasses.dataclass(frozen=True)
class ColBERTConfig:
    name: str = "colbert"
    vocab: int = 30_522
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    out_dim: int = 128
    query_len: int = 32
    doc_len: int = 180
    norm: str = "sphere"            # "sphere" | "ball"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def lm_config(self) -> LMConfig:
        return LMConfig(name=self.name + "-core", n_layers=self.n_layers,
                        d_model=self.d_model, n_heads=self.n_heads,
                        n_kv_heads=self.n_heads, d_ff=self.d_ff,
                        vocab=self.vocab, causal=False, tie_embeddings=True,
                        param_dtype=self.param_dtype,
                        compute_dtype=self.compute_dtype, remat=False)


class ColBERT(nn.Module):
    def __init__(self, cfg: ColBERTConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = Transformer(cfg.lm_config())
        self.proj = nn.Linear(cfg.d_model, cfg.out_dim, bias=False,
                              dtype=cfg.param_dtype)

    def _finalize(self, raw):
        if self.cfg.norm == "sphere":
            n = torch.sqrt((raw * raw).sum(-1, keepdim=True))
            return raw / n.clamp_min(1e-9)
        return ball_projection(raw)

    def encode(self, token_ids, attn_mask):
        """token_ids, attn_mask: (B, S) -> embeddings (B, S, out_dim) in
        the compute dtype."""
        h = self.backbone.hidden_states(token_ids, attn_mask=attn_mask)
        raw = h @ self.proj.weight.T.to(self.cfg.compute_dtype)
        return self._finalize(raw)

    def encode_queries(self, token_ids):
        """Query augmentation: pad/truncate to ``query_len`` with [MASK]
        (and [MASK] for pad ids); every position attends."""
        B, S = token_ids.shape
        ql = self.cfg.query_len
        if S < ql:
            pad = torch.full((B, ql - S), MASK_ID, dtype=token_ids.dtype,
                             device=token_ids.device)
            token_ids = torch.cat([token_ids, pad], dim=1)
        else:
            token_ids = token_ids[:, :ql]
        token_ids = torch.where(token_ids == 0, MASK_ID, token_ids)
        mask = torch.ones_like(token_ids, dtype=torch.bool)
        return self.encode(token_ids, mask), mask

    def encode_docs(self, token_ids):
        mask = token_ids != 0
        return self.encode(token_ids, mask), mask

    def encode_docs_with_attention(self, token_ids):
        """Doc embeddings, masks and each token's received attention in
        the first layer (the embedding in the compute dtype, ``ln1``,
        q/k with rope, the key-masked fp32 softmax): (emb, mask, recv
        (B, S) fp32)."""
        mask = token_ids != 0
        emb = self.encode(token_ids, mask)
        bb = self.backbone
        layer0 = bb.layers[0]
        h = rms_norm(bb._embed(token_ids), layer0.ln1)
        recv = attention_weights_received(layer0.attn, h, attn_mask=mask,
                                          rope_theta=bb.cfg.rope_theta)
        return emb, mask, recv


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: ColBERTConfig,
                device=None) -> ColBERT:
    """A randomly initialised encoder drawn from ``generator`` with the
    reference's distributions (embeddings N(0, 0.02), matrices
    N(0, 1/in_dim), norm gains 1), moved to ``device``."""
    model = ColBERT(cfg)
    dt = cfg.param_dtype
    bb = model.backbone
    bb.embed.weight.copy_(embed_init(generator, cfg.vocab, cfg.d_model, dt))
    for layer in bb.layers:
        for lin in (layer.attn.wq, layer.attn.wk, layer.attn.wv,
                    layer.attn.wo, layer.w_gate, layer.w_up, layer.w_down):
            lin.weight.copy_(dense_init(generator, lin.in_features,
                                        lin.out_features, dt).T)
    model.proj.weight.copy_(
        dense_init(generator, cfg.d_model, cfg.out_dim, dt).T)
    return model.to(device or generator.device).eval()
