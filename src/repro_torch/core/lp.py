"""LP-Pruning [27] without an external LP solver.

Counterpart of ``repro.core.lp``.  Zong & Piwowarski prune token
``d_i`` when the linear program

    max_{||q|| <= 1}  q.d_i - max_{j != i} q.d_j        (dominance margin)

stays below a threshold theta.  As in the reference, the equivalent
concave maximin ``g(q) = min_{j != i} q.(d_i - d_j)`` over the unit ball
is solved by projected supergradient ascent: the supergradient at q is
``d_i - d_{j*}`` for the first minimizing j*, the step is
``lr / sqrt(1 + t)``, the iterate is projected back onto the ball, and
the best g seen is kept.  Four restarts per token, in the reference's
order: d_i / |d_i|, minus the normalized sum of the other tokens, the
normalized difference of those two, and -d_i / |d_i|.

Batching: every restart of every token of every document ascends
together.  One step is one batched product q . d_j (B, 4m, m), so
``q.(d_i - d_j)`` is formed as ``q.d_i - q.d_j`` (the reference forms
the difference first; the two agree to fp32 rounding), and the
``n_iters`` steps are a Python loop of device work with no host sync.
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import NEG_INF

__all__ = ["brute_force_margin", "dominance_margin", "lp_prunable"]


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


def _inits(d_embs, others_ok):
    """(B, 4, m, dim): the four starting points of every token."""
    di = _unit(d_embs)
    mean_others = _unit(others_ok.to(d_embs.dtype) @ d_embs)
    return torch.stack([di, -mean_others, _unit(di - mean_others), -di],
                       dim=1)


def _objective(q, d_embs, others_ok):
    """g at every iterate q (B, R, m, dim): (the masked q.(d_i - d_j)
    (B, R, m, m), its min over j)."""
    B, R, m, dim = q.shape
    qd = torch.bmm(q.reshape(B, R * m, dim),
                   d_embs.transpose(1, 2)).view(B, R, m, m)
    own = torch.diagonal(qd, dim1=-2, dim2=-1)[..., None]     # q_i . d_i
    diffs = torch.where(others_ok[:, None], own - qd, torch.inf)
    return diffs, diffs.amin(-1)


def dominance_margin(d_embs, d_mask, *, n_iters: int = 200,
                     lr: float = 0.1):
    """Per-token optimum of max_{||q||<=1} min_{j!=i} q.(d_i - d_j).

    d_embs (m, dim) with d_mask (m,), or a batch (B, m, dim) with
    (B, m).  Returns the margins, (m,) or (B, m); padded tokens get -inf.
    """
    if d_embs.dim() == 2:
        return dominance_margin(d_embs[None], d_mask[None], n_iters=n_iters,
                                lr=lr)[0]
    B, m, _ = d_embs.shape
    dev = d_embs.device
    eye = torch.eye(m, dtype=torch.bool, device=dev)
    others_ok = d_mask[:, None, :] & ~eye                    # (B, i, j)
    q = _inits(d_embs, others_ok)
    diffs, best = _objective(q, d_embs, others_ok)
    # lr / sqrt(1 + t) in fp32, as the reference's traced step counter
    steps = (torch.tensor(lr, dtype=torch.float32, device=dev)
             / torch.sqrt(torch.arange(n_iters, dtype=torch.float32,
                                       device=dev) + 1.0))
    rows = torch.arange(B, device=dev)[:, None, None]
    for t in range(n_iters):
        jstar = diffs.argmin(-1)                   # first index on ties
        grad = d_embs[:, None] - d_embs[rows, jstar]
        q = q + steps[t] * grad
        nrm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
        q = torch.where(nrm > 1.0, q / nrm, q)
        diffs, g = _objective(q, d_embs, others_ok)
        best = torch.maximum(best, g)
    return torch.where(d_mask, best.amax(1), -torch.inf)


def lp_prunable(d_embs, d_mask, theta: float = 0.7, *, n_iters: int = 200,
                lr: float = 0.1):
    """A token is prunable when its best dominance margin stays below
    theta."""
    margins = dominance_margin(d_embs, d_mask, n_iters=n_iters, lr=lr)
    return d_mask & (margins < theta)


def brute_force_margin(d_embs, d_mask, n_probe: int = 200_000,
                       seed: int = 0):
    """Test oracle: dense random search over the sphere (small dims
    only), with probes from a ``torch.Generator`` seeded with ``seed``
    on the embeddings' device.  (m, dim) -> (m,)."""
    g = torch.Generator(device=d_embs.device).manual_seed(seed)
    q = torch.randn((n_probe, d_embs.shape[1]), generator=g,
                    device=d_embs.device)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    s = torch.where(d_mask[None, :], q @ d_embs.T, NEG_INF)   # (n, m)
    m = d_embs.shape[0]
    # the best other token of each probe: its best, or its second where
    # token i is its best
    top, idx = s.topk(min(2, m), dim=-1)
    second = top[:, 1:2] if m > 1 else torch.full_like(top, NEG_INF)
    tok = torch.arange(m, device=d_embs.device)
    others_best = torch.where(tok == idx[:, :1], second, top[:, :1])
    margins = (s - others_best).amax(0)
    return torch.where(d_mask, margins, -torch.inf)
