"""Retrieval metrics (MRR@k, nDCG@k, Recall@k) and the Mean-Error /
metric linear fit of paper §6.4 (Fig. 6).

Counterpart of ``repro.core.metrics``.  Orderings are stable sorts, so
tied scores rank by ascending doc index as ``jnp.argsort`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def _order(scores):
    return torch.sort(-scores, dim=-1, stable=True).indices


def rank_of_relevant(scores, rel):
    """1-based rank of each query's best-ranked relevant doc (int32 max
    for a query with no relevant doc).  scores (n_q, n_docs); rel bool."""
    rel_sorted = rel.gather(-1, _order(scores))
    pos = rel_sorted.to(torch.int64).argmax(-1) + 1
    return torch.where(rel.any(-1), pos,
                       torch.iinfo(torch.int32).max)


def mrr_at_k(scores, rel, k: int = 10):
    r = rank_of_relevant(scores, rel).to(torch.float64)
    return torch.where(r <= k, 1.0 / r, 0.0).mean().to(torch.float32)


def ndcg_at_k(scores, gains, k: int = 10):
    """gains: graded relevance (n_q, n_docs) (binary works too)."""
    k = min(k, scores.shape[-1])
    gains = gains.to(torch.float32)
    g = gains.gather(-1, _order(scores)[:, :k])
    disc = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float32,
                                         device=scores.device))
    dcg = (g * disc[None, :]).sum(-1)
    ideal = torch.sort(gains, dim=-1, descending=True).values[:, :k]
    idcg = (ideal * disc[None, :]).sum(-1)
    return torch.where(idcg > 0, dcg / idcg.clamp_min(1e-9), 0.0).mean()


def relevance_recall_at_k(scores, rel, k: int = 10):
    """Fraction of queries with a relevant doc in the score top-k (the
    judgment-based recall; the routed-serving gate uses the id-overlap
    :func:`recall_at_k` instead).  0 when no query has a relevant doc."""
    hit = rel.gather(-1, _order(scores)[:, :k]).any(-1)
    has = int(rel.any(-1).sum())
    if has == 0:
        return torch.zeros((), dtype=torch.float32, device=scores.device)
    return hit.sum().float() / has


def recall_at_k(ids_pruned, ids_oracle) -> float:
    """Mean per-query ``|top-k(pruned) ∩ top-k(oracle)| / |top-k(oracle)|``.
    Negative ids are pad sentinels and never count as docs on either
    side; a query whose oracle row is empty is perfect by definition,
    and an entirely empty oracle returns 1.0."""
    pruned = np.asarray(ids_pruned)
    oracle = np.asarray(ids_oracle)
    if oracle.ndim != 2 or pruned.ndim != 2:
        raise ValueError("recall_at_k expects (n_q, k)-shaped id arrays")
    if pruned.shape[0] != oracle.shape[0]:
        raise ValueError(
            f"query counts differ: pruned {pruned.shape[0]} vs oracle "
            f"{oracle.shape[0]}")
    per_q = []
    for p_row, o_row in zip(pruned, oracle):
        want = {int(i) for i in o_row if i >= 0}
        if not want:
            per_q.append(1.0)
            continue
        got = {int(i) for i in p_row if i >= 0}
        per_q.append(len(want & got) / len(want))
    return float(np.mean(per_q)) if per_q else 1.0


def linear_fit(x, y) -> dict:
    """Least-squares line and R^2 for the ME vs nDCG@10 analysis (§6.4),
    in float64 numpy as the reference's."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    A = np.stack([x, np.ones_like(x)], axis=1)
    (slope, intercept), *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = slope * x + intercept
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return {"slope": float(slope), "intercept": float(intercept), "r2": r2}
