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

Knobs: :func:`tuned` and the ``tuned_*_blocks`` helpers are the seam to
the autotuner (``core/tuning.py``): the shortlist schedule, the doc
block of B1, B2, B3 and B5, and the streaming slab, by shape and by the
card the call runs on.  Explicit arguments win; ``None`` is filled from
the tuner.  The CUDA kernels' tiles are compile-time constants of their
sources.
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
    "resolve_backend",
    "resolve_device",
    "tuned",
    "tuned_routing_blocks",
    "tuned_serving_blocks",
    "tuned_streaming_blocks",
]

REFERENCE = "reference"
FUSED = "fused"
SHORTLIST = "shortlist"
SHORTLIST_TOPK = "shortlist_topk"
BACKENDS = (REFERENCE, FUSED, SHORTLIST, SHORTLIST_TOPK)
SERVING = (REFERENCE, FUSED)
PRUNING = BACKENDS

_ENV_VAR = "REPRO_BACKEND"


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


def tuned(kind: str, *, device=None, **shape):
    """The autotuner's ``KernelConfig`` for (kind, shape) on ``device``
    (``core.tuning.tune``; imported here lazily so the kernel layer
    below this module never imports the tuner)."""
    from repro_torch.core import tuning
    return tuning.tune(kind, device=device, **shape)


def tuned_serving_blocks(n_q: int, n_docs: int, m: int, l: int, dim: int,
                         block_docs: int | None = None, *,
                         codec: str | None = None, device=None) -> int:
    """``block_docs`` of the multi sweep over one doc array (n_docs, m,
    dim); ``m`` is the capacity of the array scored (a packed index's
    bucket keys its own entry).  ``codec`` (``"bf16"``, ``"int8"``,
    ``"residual4"``, ...) joins the key only when set, so fp32 keys stay
    the reference's.  An explicit value wins.  (The reference also
    resolves ``block_q`` here; the port's query tile is a compile-time
    constant of the kernels, so nothing takes it.)"""
    if block_docs is None:
        shape = dict(n_q=n_q, n_docs=n_docs, m=m, l=l, dim=dim)
        if codec is not None:
            shape["codec"] = codec
        block_docs = tuned("serving", device=device, **shape).block_docs
    return block_docs


def tuned_routing_blocks(n_q: int, n_buckets: int, n_centroids: int,
                         l: int, dim: int, *,
                         n_probe: int | None = None,
                         threshold: float | None = None,
                         block_docs: int | None = None,
                         device=None) -> int:
    """``block_docs`` of the router's centroid pass: the table scored as
    one bucket of ``n_buckets`` docs of ``n_centroids`` tokens.
    ``n_probe`` and ``threshold`` join the key only when set.  An
    explicit value wins."""
    if block_docs is None:
        shape = dict(n_q=n_q, n_docs=n_buckets, m=n_centroids, l=l,
                     dim=dim)
        if n_probe is not None:
            shape["n_probe"] = n_probe
        if threshold is not None:
            shape["threshold"] = threshold
        block_docs = tuned("serving", device=device, **shape).block_docs
    return block_docs


def tuned_streaming_blocks(n_q: int, n_docs: int, m: int, l: int, dim: int,
                           k: int, *, n_shards: int = 1, n_groups: int = 1,
                           replicas: int = 1,
                           block_docs: int | None = None,
                           chunk_docs: int | None = None,
                           codec: str | None = None,
                           device=None) -> tuple[int, int]:
    """``(block_docs, chunk_docs)`` of the streaming top-k over one bucket
    (n_docs, m, dim): the serving key extended by the merge fan-in ``k``
    and the candidate shard count ``n_shards`` (knobs sized for the
    shard-local slice); ``n_groups`` (> 1), ``replicas`` (> 1) and
    ``codec`` join the key only when set.  Explicit values win."""
    if block_docs is None or chunk_docs is None:
        shape = dict(n_q=n_q, n_docs=n_docs, m=m, l=l, dim=dim,
                     k=k, n_shards=n_shards)
        if n_groups > 1:
            shape["n_groups"] = n_groups
        if replicas > 1:
            shape["replicas"] = replicas
        if codec is not None:
            shape["codec"] = codec
        cfg = tuned("serving", device=device, **shape)
        block_docs = cfg.block_docs if block_docs is None else block_docs
        chunk_docs = cfg.chunk_docs if chunk_docs is None else chunk_docs
    return block_docs, chunk_docs
