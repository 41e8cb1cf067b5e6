"""Monte-Carlo query samplers over the unit sphere / ball (paper §4.2).

Counterpart of ``repro.core.sampling``.  Each sampler takes an explicit
``torch.Generator`` where the reference takes a ``jax.random`` key; the
two frameworks draw different numbers from the same seed, so parity is
held at the level of the distribution.
"""

from __future__ import annotations

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
