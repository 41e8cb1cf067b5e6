"""Backend dispatch for the pruning and serving hot paths.

Counterpart of ``repro.core.backend``: the single seam through which
the algorithmic layer (``core.voronoi``, ``serve.retrieval``) reaches
the hand-written CUDA kernels (``kernels.maxsim_top2``,
``kernels.maxsim_topk``, ``kernels.colbert_maxsim``).

======================  ==========================================
path                    what it does
======================  ==========================================
``reference``           plain torch; materializes the (B, N, m)
                        pruning score tensor / the 4-D serving
                        tensor.  The parity oracle.
``fused``               CUDA kernels: ``maxsim_top2`` per pruning
                        step, ``colbert_maxsim`` for serving.
``shortlist``           exact top-K shortlist pruning, dense rescan
(pruning only)          over a cached score tensor.
``shortlist_topk``      the same algorithm, rescanned through the
(pruning only)          ``maxsim_topk`` kernel (nothing (N, m)-shaped
                        is cached).
======================  ==========================================

``resolve_backend(None)`` picks, on CUDA, ``shortlist_topk`` where the
caller allows it (pruning) and ``fused`` otherwise (serving); on the CPU
it picks ``reference``.  The ``REPRO_BACKEND`` environment variable
overrides, as in the reference.

Devices: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU device they raise
(:func:`resolve_device`).  Kernel wrappers take the plain version for a
CPU or ``meta`` tensor (``kernels.build.PLAIN_DEVICES``) and launch the
kernel (or raise) for a CUDA tensor.

Numerics: fp32 means IEEE fp32.  Importing this module turns TF32 off
for both cuBLAS matmuls and cuDNN, so the plain large products the
port leaves to ``torch.matmul`` (encoder, pooled first stage, dense
shortlist rescan, the reference oracles) run in full fp32 on the card.

The reference's autotuner (``core/tuning.py``) is not ported yet: the
knobs it resolved are fixed here (:func:`shortlist_knobs`,
:data:`STREAM_CHUNK_DOCS`).  The CUDA kernels' tile sizes are
compile-time constants of their sources.
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = [
    "BACKENDS",
    "FUSED",
    "PRUNING",
    "REFERENCE",
    "SERVING",
    "SHORTLIST",
    "SHORTLIST_TOPK",
    "STREAM_CHUNK_DOCS",
    "resolve_backend",
    "resolve_device",
    "shortlist_knobs",
]

REFERENCE = "reference"
FUSED = "fused"
SHORTLIST = "shortlist"
SHORTLIST_TOPK = "shortlist_topk"
BACKENDS = (REFERENCE, FUSED, SHORTLIST, SHORTLIST_TOPK)
SERVING = (REFERENCE, FUSED)
PRUNING = BACKENDS

_ENV_VAR = "REPRO_BACKEND"

# Doc-axis slab each streaming top-k step scores then reduces
# (the reference's tuned ``chunk_docs``).  Results never depend on it:
# the (-score, id) merge is exact for any chunking.
STREAM_CHUNK_DOCS = 1024


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  Raises when no GPU is present and the caller did not
    ask for the CPU explicitly — an entry point never carries on quietly
    on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _platform_default(allow: tuple[str, ...], device) -> str:
    if torch.device(device).type == "cuda":
        return SHORTLIST_TOPK if SHORTLIST_TOPK in allow else FUSED
    return REFERENCE


def resolve_backend(backend: str | None = None, *,
                    allow: tuple[str, ...] = BACKENDS,
                    device="cuda") -> str:
    """Resolve a ``backend=`` argument: explicit argument >
    ``REPRO_BACKEND`` env var > platform default of ``device``.  An
    explicit argument outside ``allow`` raises; an env value that is a
    valid backend outside ``allow`` falls back to the platform default;
    an env value that is no backend raises everywhere."""
    if backend is None:
        env = os.environ.get(_ENV_VAR)
        if env:
            if env not in BACKENDS:
                raise ValueError(
                    f"backend={env!r} (from {_ENV_VAR} env var) is not a "
                    f"known backend; choose one of {list(BACKENDS)}")
            if env not in allow:
                env = None
        backend = env or _platform_default(allow, device)
    if backend not in allow:
        raise ValueError(f"backend={backend!r} not supported here; "
                         f"choose one of {list(allow)}")
    return backend


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def shortlist_knobs(m: int) -> tuple[int, int]:
    """``(shortlist K, rescan_every R)`` for documents of width ``m``:
    the reference heuristic's K ~ sqrt(m) in [4, 32], R = K - 1, which
    satisfies the exactness bound K >= R + 1."""
    k = _pow2_at_least(max(int(m ** 0.5), 2))
    k = max(4, min(32, k))
    k = min(k, max(m, 2))
    return k, max(1, k - 1)
