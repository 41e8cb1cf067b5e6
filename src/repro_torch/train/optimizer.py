"""AdamW + schedules + clipping, as plain functions on tensors.

Counterpart of ``repro.train.optimizer``, whose update is not
``torch.optim.AdamW``'s (the clip scale, the bias corrections and the
decay rule are the reference's).  Parameters, gradients and the moments
are dicts of tensors under the same names.  ``m`` and ``v`` are fp32
whatever the parameter dtype; the update is computed in fp32 and
rounded to the parameter's dtype.  :func:`apply` updates parameters and
moments in place.

Decay: the reference decays every leaf of rank >= 2 ("no decay on
norms/bias").  Its layers are stacked on a leading axis, so a layer's
norm gain is a rank-2 leaf there and is decayed, while the port holds it
as a vector.  :func:`apply` therefore takes each parameter's rank in the
reference's tree (``ranks``; ``models.convert.jax_ranks``) and decides
by that.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor            # () int32, on the CPU
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # "cosine" | "linear" | "constant"
    min_lr_ratio: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d fp32
    tensor computed in fp32 as the reference computes it."""
    s = _f32(step)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = _f32(1.0)
    else:
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(_f32(math.pi) * frac))
        else:
            decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    return cfg.lr * warm * decay


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root.  CUDA's is; the CPU's
    vectorized one is not always, so there it is taken in fp64 and
    rounded once (exact for fp32 inputs)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def init(params: dict[str, torch.Tensor]) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32), m=zeros(),
                      v=zeros())


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in tensors]).sum())


# the AdamW of every train cell's step (``launch.steps``)
CELL_CONFIG = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)


@torch.no_grad()
def apply(cfg: AdamWConfig, params: dict[str, torch.Tensor],
          grads: dict[str, torch.Tensor], state: AdamWState, *,
          ranks: dict[str, int] | None = None,
          gnorm: torch.Tensor | None = None):
    """One AdamW update, in place, of parameters on one device.
    ``ranks`` gives each parameter's rank in the reference's tree
    (default: its own ``ndim``); rank >= 2 is decayed.  ``gnorm`` is the
    clip's norm, on the parameters' device; by default the
    :func:`global_norm` of ``grads`` (a placed step passes the norm of
    the whole gradients, of which ``grads`` are pieces).  Returns
    (params, new_state, stats) with ``stats`` {"grad_norm" (before the
    clip), "lr"} as 0-d fp32 tensors."""
    names = list(params)
    if gnorm is None:
        gnorm = global_norm([grads[n] for n in names])
    if cfg.grad_clip:
        scale = torch.clamp(cfg.grad_clip / gnorm.clamp_min(1e-9), max=1.0)
    else:
        scale = None
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    s = _f32(step)
    b1c = 1 - _f32(cfg.b1) ** s
    b2c = 1 - _f32(cfg.b2) ** s
    # The scalars go to the parameters' device once, as 0-d tensors
    # there: CUDA divides by a host scalar as a product with its
    # reciprocal, which rounds differently from the reference's division.
    dev = gnorm.device
    lr_d, b1c_d, b2c_d = torch.stack([lr, b1c, b2c]).to(dev).unbind()
    for n in names:
        p, m, v = params[n], state.m[n], state.v[n]
        g = grads[n].float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (m / b1c_d) / (_sqrt(v / b2c_d) + cfg.eps)
        rank = p.ndim if ranks is None else ranks[n]
        p32 = p.float()
        if rank >= 2 and cfg.weight_decay:
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr_d * delta)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), stats
