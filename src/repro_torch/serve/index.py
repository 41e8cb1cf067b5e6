"""Packed serving index: pruning that actually shrinks the index.

Counterpart of ``repro.serve.index`` for ``compression="none"``: kept
tokens are compacted to the front of each row (original order kept) and
documents are grouped by kept-token count into power-of-two capacity
buckets (``pruning_pipeline.bucket_plan``).  Each bucket is a dense
``(n_docs_b, cap_b, dim)`` tensor the ``colbert_maxsim`` kernels score
directly, with a ``doc_ids`` remap back to corpus-global positions.
``storage()["bytes_stored"]`` sums the bytes of the tensors actually
held.  MaxSim's per-query-token max is subset/order-invariant, so
packed scores equal masked scores.

The ``int8`` and ``residual`` codecs are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pruning_pipeline import bucket_plan

__all__ = ["COMPRESSIONS", "PackedBucket", "PackedIndex"]

COMPRESSIONS = ("none",)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class PackedBucket:
    """One capacity bucket; ``masks`` is prefix-dense, and a document
    that lost every token to pruning has an all-false row."""

    cap: int
    doc_ids: torch.Tensor             # (n_docs_b,) int32, global doc ids
    masks: torch.Tensor               # (n_docs_b, cap) bool
    embs: torch.Tensor                # (n_docs_b, cap, dim)

    @property
    def n_docs(self) -> int:
        return self.masks.shape[0]

    def nbytes(self) -> int:
        return sum(_nbytes(t) for t in (self.doc_ids, self.masks, self.embs))

    def __repr__(self):
        return f"PackedBucket(cap={self.cap}, n_docs={self.n_docs})"


@dataclasses.dataclass
class PackedIndex:
    """Compacted token index: the artifact pruning produces and serving
    loads (``serve.retrieval`` accepts it wherever it accepts a
    ``TokenIndex``)."""

    n_docs: int
    m: int                      # original padded doc length
    dim: int
    tokens_total: int           # alive tokens before pruning
    compression: str
    buckets: list[PackedBucket]
    # Mutation epoch (0 for a freshly packed index); joins the serving
    # closure cache keys.
    epoch: int = 0
    _pooled: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _padded: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def pack(cls, d_embs, d_masks, keep=None, *, compression: str = "none",
             granularity: int | str = "pow2",
             min_width: int = 8) -> "PackedIndex":
        """Compact ``keep & d_masks`` tokens into capacity buckets on
        ``d_embs``' device.  Host-side layout (data-dependent), like
        ``bucket_plan``; ``keep=None`` packs the unpruned index."""
        if compression not in COMPRESSIONS:
            raise ValueError(f"compression={compression!r}; one of "
                             f"{COMPRESSIONS} (int8/residual not ported)")
        dev = d_embs.device
        embs = d_embs.detach().cpu().numpy()
        masks = d_masks.cpu().numpy().astype(bool)
        active = masks if keep is None else (
            keep.cpu().numpy().astype(bool) & masks)
        n_docs, m = active.shape
        dim = embs.shape[-1]
        buckets = []
        if n_docs:
            plan = bucket_plan(active.sum(1), m, granularity=granularity,
                               min_width=min_width)
            for b in plan:
                act = active[b.indices]
                # stable argsort on ~mask: kept positions first, in order
                sel = np.argsort(~act, axis=1, kind="stable")[:, :b.width]
                e = np.take_along_axis(embs[b.indices], sel[:, :, None],
                                       axis=1)
                mk = np.take_along_axis(act, sel, axis=1)
                e[~mk] = 0  # deterministic bytes in the padded tail
                buckets.append(PackedBucket(
                    cap=b.width,
                    doc_ids=torch.as_tensor(b.indices, dtype=torch.int32,
                                            device=dev),
                    masks=torch.as_tensor(mk, device=dev),
                    embs=torch.as_tensor(e, device=dev)))
        return cls(n_docs=n_docs, m=m, dim=dim,
                   tokens_total=int(masks.sum()), compression=compression,
                   buckets=buckets)

    @property
    def device(self) -> torch.device:
        return self.buckets[0].embs.device if self.buckets else (
            torch.device("cpu"))

    @property
    def tokens_kept(self) -> int:
        return int(sum(int(b.masks.sum()) for b in self.buckets))

    @property
    def cap_max(self) -> int:
        return max((b.cap for b in self.buckets), default=0)

    def storage(self) -> dict:
        """Measured footprint: ``bytes_stored`` sums the bytes of the
        tensors this process holds."""
        kept = self.tokens_kept
        slots = sum(b.n_docs * b.cap for b in self.buckets)
        return {
            "tokens_total": self.tokens_total,
            "tokens_kept": kept,
            "remain_pct": 100.0 * kept / max(self.tokens_total, 1),
            "bytes_stored": sum(b.nbytes() for b in self.buckets),
            "bytes_fp32": kept * self.dim * 4,
            "bytes_fp32_unpruned": self.tokens_total * self.dim * 4,
            "bytes_dense_fp32": self.n_docs * self.m * self.dim * 4,
            "compression": self.compression,
            "n_buckets": len(self.buckets),
            "cap_max": self.cap_max,
            "padding_overhead": slots / max(kept, 1),
        }

    def pooled(self) -> torch.Tensor:
        """(n_docs, dim) mean-pooled doc vectors in global doc order, for
        the cheap first stage; built once and cached."""
        if self._pooled is None:
            out = torch.zeros((self.n_docs, self.dim), dtype=torch.float32,
                              device=self.device)
            for b in self.buckets:
                w = b.masks[..., None].to(b.embs.dtype)
                out[b.doc_ids.long()] = ((b.embs * w).sum(1)
                                         / w.sum(1).clamp_min(1.0)).float()
            self._pooled = out
        return self._pooled

    def padded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Gatherable ((n_docs, cap_max, dim) embs, (n_docs, cap_max)
        masks) for the two-stage rerank's per-query candidate gather;
        built once and cached (serving scratch, not in
        ``bytes_stored``)."""
        if self._padded is None:
            e = torch.zeros((self.n_docs, self.cap_max, self.dim),
                            dtype=torch.float32, device=self.device)
            mk = torch.zeros((self.n_docs, self.cap_max), dtype=torch.bool,
                             device=self.device)
            for b in self.buckets:
                ids = b.doc_ids.long()
                e[ids, :b.cap] = b.embs.float()
                mk[ids, :b.cap] = b.masks
            self._padded = (e, mk)
        return self._padded
