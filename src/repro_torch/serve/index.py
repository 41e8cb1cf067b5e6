"""Packed serving index: pruning that actually shrinks the index.

Counterpart of ``repro.serve.index`` on one device: kept tokens are
compacted to the front of each row (original order kept) and documents
are grouped by kept-token count into power-of-two capacity buckets
(``pruning_pipeline.bucket_plan``).  Each bucket holds its documents in
one of three codecs (``compression``):

* ``"none"``: a dense ``(n_docs_b, cap_b, dim)`` tensor in the dtype it
  was given (the encoder's bf16 at the full config, as the reference
  stores it); the ``colbert_maxsim`` kernels read fp32 or bf16;
* ``"int8"``: 256-value blocks of symmetric int8 with one fp32 scale
  each (``train.compress.quantize_int8``), dequantized to fp32 for
  scoring;
* ``"residual"``: ColBERTv2-style — each kept token is a 1-byte id into
  the bucket's Lloyd's codebook (the seeded split the routing tier
  runs, ``serve.routing.bucket_codebook``) plus a bit-packed b-bit
  residual under a per-token scale.  Serving hands the compressed
  arrays (:class:`ResidualView`) to the residual ``colbert_maxsim``
  kernels, which decode tile by tile in shared memory: the fp32 bucket
  never exists in device memory on the ``fused`` path.

A ``doc_ids`` remap takes each bucket back to corpus-global positions.
``storage()["bytes_stored"]`` sums the bytes of the tensors actually
held.  MaxSim's per-query-token max is subset/order-invariant, so packed
scores equal masked scores.

Sharding: ``shard_axes`` names the logical axes of every bucket's
``(docs, tokens, dim)`` arrays (docs are the "candidates" axis);
:meth:`PackedIndex.spec` resolves them under the active
``sharding.specs`` rules, and :meth:`PackedBucket.shard_view` cuts a
bucket's doc axis into the equal shards ``serve.retrieval``'s sharded
and grid paths place on their devices.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.pruning_pipeline import bucket_plan
from repro_torch.sharding.specs import spec_for
from repro_torch.train import compress

__all__ = ["COMPRESSIONS", "PackedBucket", "PackedIndex", "ResidualView"]

COMPRESSIONS = ("none", "int8", "residual")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class ResidualView:
    """One residual bucket in compressed form, as serving passes it in
    place of a dense doc array.  Slicing the doc axis (``view[a:b]``,
    the streaming chunk walk) slices codes, residuals and per-token
    scales and shares the codebook; :meth:`dense` decodes eagerly (the
    ``reference`` backend and the host-side view builders)."""

    codes: torch.Tensor     # (n, cap) int8 centroid ids
    resq: torch.Tensor      # (n, cap, dim * bits // 8) uint8 packed
    scale: torch.Tensor     # (n, cap, 1) f32 per-token residual scales
    codebook: torch.Tensor  # (n_centroids, dim) f32
    bits: int
    dim: int

    def __getitem__(self, sl):
        return ResidualView(self.codes[sl], self.resq[sl], self.scale[sl],
                            self.codebook, self.bits, self.dim)

    def to(self, device) -> "ResidualView":
        return ResidualView(self.codes.to(device), self.resq.to(device),
                            self.scale.to(device), self.codebook.to(device),
                            self.bits, self.dim)

    def padded(self, n: int) -> "ResidualView":
        """This view with ``n`` pad rows appended: code 0, residual 0,
        scale 0 (they decode to garbage, so they must arrive masked)."""
        def pad(t):
            return torch.cat([t, t.new_zeros((n,) + t.shape[1:])])
        return ResidualView(pad(self.codes), pad(self.resq), pad(self.scale),
                            self.codebook, self.bits, self.dim)

    @property
    def n_docs(self) -> int:
        return self.codes.shape[0]

    @property
    def cap(self) -> int:
        return self.codes.shape[1]

    def dense(self) -> torch.Tensor:
        """Eager decode to (n, cap, dim) fp32."""
        return compress.dequantize_residual(self.resq, self.scale,
                                            self.codes, self.codebook,
                                            self.bits)


@dataclasses.dataclass
class PackedBucket:
    """One capacity bucket; ``masks`` is prefix-dense, and a document
    that lost every token to pruning has an all-false row.  Exactly one
    of ``embs``, ``q8``/``scales`` or ``codes``/``resq``/``rscale``/
    ``codebook`` is set, per the owning index's ``compression``."""

    cap: int
    doc_ids: torch.Tensor                 # (n_docs_b,) int32
    masks: torch.Tensor                   # (n_docs_b, cap) bool
    embs: torch.Tensor | None = None      # (n_docs_b, cap, dim) float
    q8: torch.Tensor | None = None        # (n_blocks, 256) int8
    scales: torch.Tensor | None = None    # (n_blocks,) f32
    codes: torch.Tensor | None = None     # (n_docs_b, cap) int8
    resq: torch.Tensor | None = None      # (n_docs_b, cap, dim*b//8) uint8
    rscale: torch.Tensor | None = None    # (n_docs_b, cap, 1) f32
    codebook: torch.Tensor | None = None  # (n_centroids, dim) f32

    @property
    def n_docs(self) -> int:
        return self.masks.shape[0]

    def residual_bits(self, dim: int) -> int:
        """b from the packed width: ``dim * b // 8`` bytes per token."""
        return self.resq.shape[-1] * 8 // dim

    def residual_view(self, dim: int) -> ResidualView:
        return ResidualView(self.codes, self.resq, self.rscale,
                            self.codebook, self.residual_bits(dim), dim)

    def dense_embs(self, dim: int) -> torch.Tensor:
        """The (n_docs_b, cap, dim) bucket as scorers read it: ``embs``
        as stored, int8 dequantized to fp32, residual decoded to fp32
        (the ``fused`` serving path bypasses this for residual buckets
        through :meth:`residual_view`)."""
        if self.embs is not None:
            return self.embs
        if self.codes is not None:
            return self.residual_view(dim).dense()
        n = self.n_docs * self.cap * dim
        return compress.dequantize_int8(self.q8, self.scales,
                                        (self.n_docs, self.cap, dim), n)

    def nbytes(self) -> int:
        ts = (self.doc_ids, self.masks, self.embs, self.q8, self.scales,
              self.codes, self.resq, self.rscale, self.codebook)
        return sum(_nbytes(t) for t in ts if t is not None)

    def shard_view(self, dim: int, n_shards: int, pad_id: int,
                   shard: int | None = None):
        """(embs, masks, doc_ids) with the doc axis padded up to a
        multiple of ``n_shards``, so the bucket splits into equal shards
        (the reference's ``shard_view``); ``shard=s`` gives shard ``s``'s
        rows alone, which view the bucket's storage unless they hold pad
        rows.  ``embs`` is a :class:`ResidualView` for a residual bucket
        (still compressed) and the dense view otherwise.

        Pad rows are all-masked docs carrying ``pad_id`` (callers pass
        ``n_docs``, above every real id); the streaming merge forces
        their candidates to -inf, so a pad never displaces a real doc,
        not even an empty-after-prune one (whose finite l x -1e30
        sentinel sits above -inf).  A bucket with no documents still
        gives one pad row a shard, with the reserved id ``-1``, which
        the merge audits the same way."""
        compressed = self.codes is not None
        e = self.residual_view(dim) if compressed else self.dense_embs(dim)
        mk, ids = self.masks, self.doc_ids
        n, n_shards = self.n_docs, max(n_shards, 1)
        pad = (-n) % n_shards if n else n_shards
        per = (n + pad) // n_shards
        lo, hi = (0, n + pad) if shard is None else (shard * per,
                                                     (shard + 1) * per)
        top = max(lo, min(hi, n))
        e, mk, ids = e[lo:top], mk[lo:top], ids[lo:top]
        n_pad = hi - top
        if n_pad:
            e = (e.padded(n_pad) if compressed else
                 torch.cat([e, e.new_zeros((n_pad,) + e.shape[1:])]))
            mk = torch.cat([mk, mk.new_zeros((n_pad,) + mk.shape[1:])])
            ids = torch.cat([ids, ids.new_full((n_pad,),
                                               pad_id if n else -1)])
        return e, mk, ids

    def __repr__(self):
        return (f"PackedBucket(cap={self.cap}, n_docs={self.n_docs}, "
                f"compressed={self.embs is None})")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host numpy array; bf16 (which numpy lacks) travels as
    its int16 bit pattern, so compaction moves the exact bits."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


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
    # b of the residual codec (0 for "none"/"int8").
    residual_bits: int = 0
    # Logical axes of each bucket's (docs, tokens, dim) arrays; the
    # active sharding rules resolve "candidates" to the mesh's
    # candidate-parallel axis.
    shard_axes: tuple = ("candidates", None, None)
    _pooled: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _padded: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _padded_res: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # Shard placements under a mesh, by (bucket, devices)
    # (``serve.retrieval._shards``).
    _shards: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)
    # Guards the lazy views above: concurrent readers (the server's read
    # gate admits many) build each one once.
    _views_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @classmethod
    def pack(cls, d_embs, d_masks, keep=None, *, compression: str = "none",
             granularity: int | str = "pow2", min_width: int = 8,
             residual_bits: int = 4, n_centroids: int = 8,
             seed: int = 0) -> "PackedIndex":
        """Compact ``keep & d_masks`` tokens into capacity buckets on
        ``d_embs``' device.  The layout is host-side (data-dependent),
        like ``bucket_plan``; the codecs run on the device.
        ``keep=None`` packs the unpruned index.  ``residual_bits``,
        ``n_centroids`` and ``seed`` shape the ``"residual"`` codec
        only."""
        if compression not in COMPRESSIONS:
            raise ValueError(f"compression={compression!r}; one of "
                             f"{COMPRESSIONS}")
        dim = d_embs.shape[-1]
        if compression == "residual":
            if residual_bits not in compress.RESIDUAL_BITS:
                raise ValueError(f"residual_bits={residual_bits}; one of "
                                 f"{compress.RESIDUAL_BITS}")
            if dim % (8 // residual_bits):
                raise ValueError(f"dim={dim} must be a multiple of "
                                 f"{8 // residual_bits} for "
                                 f"{residual_bits}-bit residuals")
            if not 1 <= n_centroids <= 127:
                raise ValueError("n_centroids must fit int8 codes "
                                 f"(1..127), got {n_centroids}")
        dev = d_embs.device
        embs = _host_array(d_embs)
        masks = d_masks.cpu().numpy().astype(bool)
        active = masks if keep is None else (
            keep.cpu().numpy().astype(bool) & masks)
        n_docs, m = active.shape
        buckets = []
        if n_docs:
            plan = bucket_plan(active.sum(1), m, granularity=granularity,
                               min_width=min_width)
            for bi, b in enumerate(plan):
                act = active[b.indices]
                # stable argsort on ~mask: kept positions first, in order
                sel = np.argsort(~act, axis=1, kind="stable")[:, :b.width]
                e = np.take_along_axis(embs[b.indices], sel[:, :, None],
                                       axis=1)
                mk = np.take_along_axis(act, sel, axis=1)
                e[~mk] = 0  # deterministic bytes in the padded tail
                e = torch.from_numpy(e).view(d_embs.dtype).to(dev)
                bucket = PackedBucket(
                    cap=b.width,
                    doc_ids=torch.as_tensor(b.indices, dtype=torch.int32,
                                            device=dev),
                    masks=torch.as_tensor(mk, device=dev))
                if compression == "int8":
                    bucket.q8, bucket.scales = compress.quantize_int8(e)
                elif compression == "residual":
                    cls._encode_residual(bucket, e.float(), residual_bits,
                                         n_centroids, seed, bi)
                else:
                    bucket.embs = e
                buckets.append(bucket)
        return cls(n_docs=n_docs, m=m, dim=dim,
                   tokens_total=int(masks.sum()), compression=compression,
                   buckets=buckets,
                   residual_bits=(residual_bits
                                  if compression == "residual" else 0))

    @staticmethod
    def _encode_residual(bucket, e, bits, n_centroids, seed, bi):
        """Codebook, codes and packed residuals of one bucket ``e``
        (n, cap, dim) f32.  Masked slots store code 0 and residual 0;
        they decode to garbage that every scorer masks."""
        from repro_torch.serve.routing import _dist2, bucket_codebook
        n, cap, dim = e.shape
        mk = bucket.masks
        cb, cbm = bucket_codebook(e.reshape(-1, dim), mk.reshape(-1),
                                  n_centroids, seed=seed, bucket_index=bi)
        d2 = _dist2(e.reshape(-1, dim), cb).reshape(n, cap, -1)
        # all-invalid codebook (no kept token): every row is inf, and
        # argmin takes code 0 as the reference does
        codes = torch.where(cbm, d2, torch.inf).argmin(-1)
        codes = torch.where(mk, codes, 0).to(torch.int8)
        r = torch.where(mk[..., None], e - cb[codes.long()], 0.0)
        bucket.codes = codes
        bucket.resq, bucket.rscale = compress.quantize_residual(r, bits)
        bucket.codebook = cb

    # -- introspection ---------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.buckets[0].masks.device if self.buckets else (
            torch.device("cpu"))

    @property
    def tokens_kept(self) -> int:
        return int(sum(int(b.masks.sum()) for b in self.buckets))

    @property
    def cap_max(self) -> int:
        return max((b.cap for b in self.buckets), default=0)

    @property
    def n_centroids(self) -> int:
        """Residual codebook size (0 unless compression == "residual")."""
        return max((b.codebook.shape[0] for b in self.buckets
                    if b.codebook is not None), default=0)

    def codec_tag(self) -> str | None:
        """None for the uncompressed index, "int8", or "residual{b}"."""
        if self.compression == "none":
            return None
        if self.compression == "residual":
            return f"residual{self.residual_bits}"
        return self.compression

    def spec(self) -> tuple:
        """The mesh axes of one bucket's (docs, tokens, dim) arrays under
        the active rules (``sharding.spec_for`` of ``shard_axes``).  A
        residual bucket's codes take the first two entries, its
        residuals and scales all three; its codebook is replicated."""
        return spec_for(*self.shard_axes)

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
            **({"residual_bits": self.residual_bits}
               if self.compression == "residual" else {}),
        }

    # -- serving views ---------------------------------------------------

    def _view(self, attr: str, build):
        """The cached view ``attr``, built by ``build()`` once under the
        index's lock (a reader that finds it built takes no lock)."""
        view = getattr(self, attr)
        if view is None:
            with self._views_lock:
                view = getattr(self, attr)
                if view is None:
                    view = build()
                    setattr(self, attr, view)
        return view

    def pooled(self) -> torch.Tensor:
        """(n_docs, dim) fp32 mean-pooled doc vectors in global doc
        order, for the cheap first stage; computed in the bucket's dtype
        as the reference computes it; built once and cached."""
        return self._view("_pooled", self._build_pooled)

    def _build_pooled(self) -> torch.Tensor:
        out = torch.zeros((self.n_docs, self.dim), dtype=torch.float32,
                          device=self.device)
        for b in self.buckets:
            e = b.dense_embs(self.dim)
            w = b.masks[..., None].to(e.dtype)
            out[b.doc_ids.long()] = ((e * w).sum(1)
                                     / w.sum(1).clamp_min(1.0)).float()
        return out

    def padded(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Gatherable ((n_docs, cap_max, dim) embs, (n_docs, cap_max)
        masks) for the two-stage rerank's per-query candidate gather;
        built once and cached (serving scratch, not in
        ``bytes_stored``).  The embs keep an uncompressed index's dtype
        (bf16 at the full config: the rerank kernel widens it exactly,
        and the gather moves half the bytes of the reference's fp32
        scratch) and are fp32 for the decoded codecs."""
        return self._view("_padded", self._build_padded)

    def _build_padded(self) -> tuple[torch.Tensor, torch.Tensor]:
        dtype = (self.buckets[0].embs.dtype
                 if self.compression == "none" and self.buckets
                 else torch.float32)
        e = torch.zeros((self.n_docs, self.cap_max, self.dim), dtype=dtype,
                        device=self.device)
        mk = torch.zeros((self.n_docs, self.cap_max), dtype=torch.bool,
                         device=self.device)
        for b in self.buckets:
            ids = b.doc_ids.long()
            e[ids, :b.cap] = b.dense_embs(self.dim)
            mk[ids, :b.cap] = b.masks
        return e, mk

    def padded_residual(self) -> tuple:
        """Compressed gatherable view for the ``fused`` two-stage rerank:
        ``(codes (n_docs, cap_max) int8, resq (n_docs, cap_max, pb)
        uint8, bucket_of (n_docs,) int32, masks (n_docs, cap_max),
        codebooks (n_buckets, C, dim) f32, rscales (n_docs, cap_max, 1)
        f32)``.  Candidates gather compressed rows; each row's codebook
        is looked up through ``bucket_of`` inside the rerank kernel, so
        the fp32 ``padded()`` scratch is never built on that path."""
        return self._view("_padded_res", self._build_padded_residual)

    def _build_padded_residual(self) -> tuple:
        dev, n, cap = self.device, self.n_docs, self.cap_max
        pb = self.dim * self.residual_bits // 8
        codes = torch.zeros((n, cap), dtype=torch.int8, device=dev)
        resq = torch.zeros((n, cap, pb), dtype=torch.uint8, device=dev)
        bucket_of = torch.zeros((n,), dtype=torch.int32, device=dev)
        mk = torch.zeros((n, cap), dtype=torch.bool, device=dev)
        cbs = torch.zeros((len(self.buckets), self.n_centroids, self.dim),
                          device=dev)
        scales = torch.zeros((n, cap, 1), device=dev)
        for bi, b in enumerate(self.buckets):
            ids = b.doc_ids.long()
            codes[ids, :b.cap] = b.codes
            resq[ids, :b.cap] = b.resq
            bucket_of[ids] = bi
            mk[ids, :b.cap] = b.masks
            cbs[bi, :b.codebook.shape[0]] = b.codebook
            scales[ids, :b.cap] = b.rscale
        return codes, resq, bucket_of, mk, cbs, scales
