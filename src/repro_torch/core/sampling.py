"""Monte-Carlo query samplers over the unit sphere / ball (paper §4.2).

Counterpart of ``repro.core.sampling``.  Each sampler takes an explicit
``torch.Generator`` where the reference takes a ``jax.random`` key; the
two frameworks draw different numbers from the same seed, so parity is
held at the level of the distribution.  The theoretical marginals and
the Fig. 1 report are deterministic and follow the reference's fp32
arithmetic.
"""

from __future__ import annotations

import math

import torch


def sample_sphere(generator: torch.Generator, n: int, dim: int,
                  dtype=torch.float32, device=None) -> torch.Tensor:
    """n i.i.d. samples uniform on the unit sphere S^{dim-1}, drawn on
    the generator's device and moved to ``device``."""
    x = torch.randn((n, dim), generator=generator, dtype=torch.float32,
                    device=generator.device)
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x.to(dtype=dtype, device=device or generator.device)


def sample_ball(generator: torch.Generator, n: int, dim: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """n i.i.d. samples uniform in the unit ball B^dim (radius CDF r^dim,
    so r = u^{1/dim})."""
    d = sample_sphere(generator, n, dim, torch.float32)
    u = torch.rand((n, 1), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (d * u ** (1.0 / dim)).to(dtype=dtype,
                                     device=device or generator.device)


def _log_norm(a: float, b: float) -> float:
    """log Γ(a) - log Γ(b) - log(π)/2 in float64: the marginals'
    normalizer.  (The reference takes each log Γ in fp32, which at dim
    128, log Γ(64) ~ 201, is good to ~1.5e-5 a term.)"""
    return math.lgamma(a) - math.lgamma(b) - 0.5 * math.log(math.pi)


def sphere_marginal_logpdf(x, dim: int):
    r"""Log marginal density of one coordinate of a uniform S^{dim-1}
    sample: p(x) \propto (1 - x^2)^{(dim-3)/2} on [-1, 1] (paper Fig. 1a;
    exponent 62.5 at dim 128)."""
    k = (dim - 3.0) / 2.0
    return (_log_norm(dim / 2.0, (dim - 1.0) / 2.0)
            + k * torch.log1p(-x.clamp(-1.0, 1.0) ** 2))


def ball_marginal_logpdf(x, dim: int):
    r"""Log marginal density of one coordinate of a uniform B^dim
    sample: p(x) \propto (1 - x^2)^{(dim-1)/2} on [-1, 1]."""
    k = (dim - 1.0) / 2.0
    return (_log_norm(dim / 2.0 + 1.0, (dim + 1.0) / 2.0)
            + k * torch.log1p(-x.clamp(-1.0, 1.0) ** 2))


def _edges(n: int, device):
    """n + 1 bin edges evenly spaced over [-1, 1]: the float64 linspace
    rounded to fp32 (the reference's fp32 ``jnp.linspace`` lands an ulp
    away from it at some edges)."""
    return torch.linspace(-1.0, 1.0, n + 1, dtype=torch.float64,
                          device=device).float()


def _histogram(a, edges, density: bool = False):
    """``jnp.histogram`` on explicit edges: bins closed on the left, the
    last also on the right; values outside are dropped.  fp32 counts."""
    n = edges.shape[0]
    idx = torch.searchsorted(edges, a, right=True)
    idx = torch.where(a == edges[-1], n - 1, idx)
    counts = torch.zeros(n + 1, dtype=torch.float32, device=a.device)
    counts = counts.index_add_(0, idx, torch.ones_like(a))[1:n]
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts


def embedding_uniformity_report(vectors, n_bins: int = 41) -> dict:
    """Fig. 1 diagnostics: one dimension's histogram (dimension
    ``min(104, dim - 1)``, as the paper's) against the uniform-sphere
    marginal, and the 80-bin histogram of the pairwise correlations
    between embedding dimensions.  Returns a dict of tensors."""
    v = torch.as_tensor(vectors).float()
    n, dim = v.shape
    edges = _edges(n_bins, v.device)
    centers = 0.5 * (edges[:-1] + edges[1:])
    hist = _histogram(v[:, min(104, dim - 1)].contiguous(), edges,
                      density=True)
    expected = torch.exp(sphere_marginal_logpdf(centers, dim))
    vc = v - v.mean(0, keepdim=True)
    cov = (vc.T @ vc) / (n - 1)
    sd = torch.sqrt(torch.diagonal(cov).clamp_min(1e-12))
    corr = cov / (sd[:, None] * sd[None, :])
    off = corr[~torch.eye(dim, dtype=torch.bool, device=v.device)]
    corr_edges = _edges(80, v.device)
    return {
        "bin_centers": centers,
        "observed_density": hist,
        "expected_density": expected,
        "corr_hist": _histogram(off.contiguous(), corr_edges),
        "corr_edges": corr_edges,
        "max_abs_off_corr": off.abs().max(),
        "mean_abs_off_corr": off.abs().mean(),
    }
