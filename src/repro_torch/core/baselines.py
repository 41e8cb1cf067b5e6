"""Pruning baselines of the paper's §5.3.

Counterpart of ``repro.core.baselines``.  Learning-free: first-k /
positional, IDF, stopword, attention-score.  Learned/optimization:
Norm-Pruning (theta=0.5) and LP-Pruning (theta=0.7) of Zong &
Piwowarski [27] (LP in ``core.lp``).

Every baseline shares the keep-mask contract of ``core.voronoi``:
padded token batches (..., m) plus masks in, a bool keep mask out, with
at least one surviving token per document.  Budgets round as the
reference's do, ``ceil(keep_fraction * n_real)`` in fp32, and ranks by
score break ties toward the lower position (a stable sort, as
``jnp.argsort`` is): IDF scores tie on every repeated token id.
"""

from __future__ import annotations

import torch

from repro_torch.core.lp import lp_prunable

__all__ = ["attention_prune", "build_idf", "first_k", "idf_prune",
           "lp_prune", "norm_prune", "random_prune", "stopword_prune"]


def _ensure_one(keep, d_mask):
    """Never prune a document to zero tokens: resurrect its first real
    one."""
    empty = ~(keep & d_mask).any(-1, keepdim=True)
    first_real = torch.cumsum(d_mask.int(), dim=-1) == 1
    return (keep | (empty & first_real)) & d_mask


def _budget(d_mask, keep_fraction: float):
    """ceil(keep_fraction * n_real) per document, in fp32: (..., 1)."""
    n_real = d_mask.sum(-1, keepdim=True).float()
    f = torch.tensor(keep_fraction, dtype=torch.float32,
                     device=d_mask.device)
    return torch.ceil(f * n_real)


def first_k(d_mask, keep_fraction: float):
    """Positional pruning: keep the first ceil(f * n_real) tokens [20]."""
    pos = torch.cumsum(d_mask.int(), dim=-1)   # 1-based among real tokens
    return _ensure_one(d_mask & (pos <= _budget(d_mask, keep_fraction)),
                       d_mask)


def idf_prune(token_ids, d_mask, idf, keep_fraction: float):
    """Keep the highest-IDF fraction of tokens per document [1, 20]."""
    scores = torch.where(d_mask, idf[token_ids.long()], -torch.inf)
    return _keep_top_fraction(scores, d_mask, keep_fraction)


def stopword_prune(token_ids, d_mask, is_stopword):
    """Drop tokens whose vocabulary id is flagged as a stopword [1]."""
    return _ensure_one(d_mask & ~is_stopword[token_ids.long()], d_mask)


def attention_prune(attn_received, d_mask, keep_fraction: float):
    """Keep tokens receiving the most encoder attention mass [17, 20];
    ``attn_received`` is ``ColBERT.encode_docs_with_attention``'s."""
    scores = torch.where(d_mask, attn_received, -torch.inf)
    return _keep_top_fraction(scores, d_mask, keep_fraction)


def norm_prune(d_embs, d_mask, theta: float = 0.5):
    """[27] Norm-Pruning: drop tokens with ||d||_2 < theta (needs the
    ball projection of the regularized fine-tuning)."""
    norms = torch.linalg.vector_norm(d_embs, dim=-1)
    return _ensure_one(d_mask & (norms >= theta), d_mask)


def lp_prune(d_embs, d_mask, theta: float = 0.7, *, n_iters: int = 200,
             lr: float = 0.1):
    """[27] LP-Pruning: drop token i if no query in the unit ball gives
    it a dominance margin above ``theta`` (``core.lp``); (m, dim) or a
    batch (B, m, dim)."""
    prunable = lp_prunable(d_embs, d_mask, theta, n_iters=n_iters, lr=lr)
    return _ensure_one(d_mask & ~prunable, d_mask)


def _keep_top_fraction(scores, d_mask, keep_fraction: float):
    """Per-document top-fraction keep mask from arbitrary token scores;
    equal scores rank by position."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(order.shape[-1], device=order.device)
        .expand_as(order).contiguous())
    return _ensure_one(d_mask & (rank < _budget(d_mask, keep_fraction)),
                       d_mask)


def random_prune(generator: torch.Generator, d_mask, keep_fraction: float):
    """Uniform-random keep mask (the sanity floor), drawn from
    ``generator`` on its device.  The reference draws from ``jax.random``,
    so the masks differ.  As in the reference, padded slots draw scores
    too and may take ranks inside the budget, so a padded document keeps
    fewer than ceil(f * n_real) tokens, by a count that depends on the
    draw; a document without padding keeps exactly that many."""
    scores = torch.rand(d_mask.shape, generator=generator,
                        device=generator.device).to(d_mask.device)
    return _keep_top_fraction(scores, d_mask, keep_fraction)


def build_idf(token_ids, d_mask, vocab: int):
    """Corpus IDF table: log(n_docs / (1 + df)), the quotient in fp32 as
    the reference's, its log correctly rounded to fp32 (taken in
    float64).  XLA's fp32 quotient and log are not correctly rounded, so
    the reference's table can differ from it by a few ulps."""
    n_docs = token_ids.shape[0]
    present = torch.zeros((n_docs, vocab), dtype=torch.bool,
                          device=token_ids.device)
    rows = torch.arange(n_docs, device=token_ids.device)[:, None]
    present[rows.expand_as(token_ids)[d_mask],
            token_ids[d_mask].long()] = True
    df = present.sum(0).float()
    quot = torch.full_like(df, n_docs) / (1.0 + df)
    return torch.log(quot.double()).float()
