"""Quantization codecs: int8 blocks, gradient error feedback and the
b-bit residual codec.

Counterpart of ``repro.train.compress``.

* int8: per-block (:data:`BLOCK` values) symmetric quantization with one
  fp32 scale per block — ``PackedIndex.pack(compression="int8")``, and
  the gradient compression with **error feedback** (EF-SGD):
  :func:`compress_tree` quantizes ``g + residual`` and carries the
  quantization error into the next step, :func:`decompress_tree`
  decodes, :func:`init_residuals` starts the residuals at zero.  A tree
  is a tensor or a dict / list / tuple of trees.
* residual (ColBERTv2-style): each kept token is a centroid id plus a
  ``bits``-bit symmetric quantization of ``token - centroid`` under a
  per-token scale, bit-packed into uint8 bytes (:func:`pack_bits`).
  Decoding is ``codebook[code] + scale * q``: eagerly in
  :func:`dequantize_residual`, or tile by tile inside the residual
  ``colbert_maxsim`` CUDA kernels.

The arithmetic is the reference's, step for step, so the bytes agree:
the scale is ``max|x| / qmax`` clamped at 1e-12, values are divided by
it (not multiplied by a reciprocal) and rounded half to even
(``torch.round``, as ``jnp.round``), and the decode is a rounded
product followed by a rounded add.
"""

from __future__ import annotations

import torch

__all__ = ["BLOCK", "RESIDUAL_BITS", "compress_tree", "decompress_tree",
           "dequantize_int8", "dequantize_residual", "init_residuals",
           "pack_bits", "quantize_int8", "quantize_residual",
           "residual_values", "symmetric_scale", "unpack_bits"]

BLOCK = 256

#: Supported residual widths: 8 // bits values pack into each byte.
RESIDUAL_BITS = (2, 4)


def symmetric_scale(x: torch.Tensor, qmax: float, *, dim=None,
                    keepdim: bool = False) -> torch.Tensor:
    """``max|x| / qmax`` (over ``dim``, or all of ``x``), clamped at
    1e-12 so all-zero inputs stay finite."""
    a = x.abs()
    m = a.amax() if dim is None else a.amax(dim=dim, keepdim=keepdim)
    return (m / qmax).clamp_min(1e-12)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: the flattened input, zero-padded to a
    multiple of :data:`BLOCK`, as ``(q (n_blocks, BLOCK) int8, scales
    (n_blocks,) f32)``."""
    flat = g.reshape(-1).float()
    pad = (-flat.numel()) % BLOCK
    blocks = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, BLOCK)
    scale = symmetric_scale(blocks, 127.0, dim=1, keepdim=True)
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    n: int) -> torch.Tensor:
    blocks = q.float() * scale[:, None]
    return blocks.reshape(-1)[:n].reshape(shape)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of the first tree and the entries at the
    same places of the others (dicts by key, lists and tuples by
    position): the others' entries there may be anything."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def compress_tree(grads, residuals):
    """EF step 1: g' = g + residual; quantize; residual' = g' - deq(q).
    Returns (a tree of (q, scales) pairs, the new fp32 residuals)."""
    pairs = _tree_map(_compress_one, grads, residuals)
    return (_tree_map(lambda g, pr: pr[0], grads, pairs),
            _tree_map(lambda g, pr: pr[1], grads, pairs))


def _compress_one(g, r):
    g32 = g.float() + r
    q, s = quantize_int8(g32)
    return (q, s), g32 - dequantize_int8(q, s, g.shape, g.numel())


def decompress_tree(qtree, like):
    """The tree of (q, scales) pairs decoded to the shapes and dtypes of
    ``like``'s tensors."""
    return _tree_map(lambda t, qs: dequantize_int8(
        qs[0], qs[1], t.shape, t.numel()).to(t.dtype), like, qtree)


def init_residuals(params):
    """fp32 zeros shaped like ``params``' tensors."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def _check_bits(bits: int) -> int:
    if bits not in RESIDUAL_BITS:
        raise ValueError(f"bits={bits}; one of {RESIDUAL_BITS}")
    return 8 // bits


def pack_bits(u: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned ``bits``-bit values (last axis) into uint8: value
    ``d`` of a row lands in byte ``d // vpb`` at shift
    ``(d % vpb) * bits`` (vpb = 8 // bits).  The last axis must be a
    multiple of vpb."""
    vpb = _check_bits(bits)
    *lead, d = u.shape
    if d % vpb:
        raise ValueError(f"last axis {d} not a multiple of {vpb}")
    g = u.reshape(*lead, d // vpb, vpb).to(torch.int32)
    shifts = torch.arange(vpb, dtype=torch.int32, device=u.device) * bits
    return (g << shifts).sum(-1).to(torch.uint8)


def unpack_bits(p: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 values in ``[0, 2**bits)``
    with the last axis widened by ``8 // bits``."""
    vpb = _check_bits(bits)
    shifts = torch.arange(vpb, dtype=torch.int32, device=p.device) * bits
    vals = (p[..., None].to(torch.int32) >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*p.shape[:-1], p.shape[-1] * vpb)


def quantize_residual(r: torch.Tensor, bits: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric ``bits``-bit quantization under a per-token scale (one
    per last-axis row): ``(packed uint8 (..., dim * bits // 8), scale
    (..., 1) f32)``.  Values are stored biased by ``2**(bits-1)`` so
    the packed bytes are unsigned."""
    _check_bits(bits)
    qmax = float(2 ** (bits - 1) - 1)
    r = r.float()
    scale = symmetric_scale(r, qmax, dim=-1, keepdim=True)
    q = torch.round(r / scale).clamp(-qmax, qmax).to(torch.int32)
    return pack_bits(q + 2 ** (bits - 1), bits), scale


def residual_values(packed: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """The decoded residuals ``(unpacked - 2**(bits-1)) * scale`` as
    fp32 (one rounded product)."""
    q = unpack_bits(packed, bits) - 2 ** (bits - 1)
    return q.float() * scale


def dequantize_residual(packed: torch.Tensor, scale: torch.Tensor,
                        codes: torch.Tensor, codebook: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """Eager decode: ``codebook[codes] + scale * q``, a rounded product
    then a rounded add — the arithmetic the residual kernels repeat
    per tile (``__fmul_rn``/``__fadd_rn``)."""
    return codebook[codes.long()] + residual_values(packed, scale, bits)
