"""Wrappers of the ColBERT MaxSim CUDA kernels
(``csrc/colbert_maxsim.cu``).

Counterpart of ``repro.kernels.colbert_maxsim.ops``:

* :func:`colbert_maxsim_multi_op` — a query batch vs one doc array in
  one launch (the e2e / exact scoring sweep);
* :func:`colbert_maxsim_rerank_op` — each query vs its OWN candidate
  block (two-stage rerank), one launch;
* :func:`colbert_maxsim_op` — one query vs a doc batch, the
  ``n_q = 1`` case of the rerank kernel;
* :func:`colbert_maxsim_batch_op` — a query batch vs shared docs, the
  single-query case once a query (the reference's ``vmap``);
* :func:`colbert_maxsim_residual_multi_op` and
  :func:`colbert_maxsim_residual_rerank_op` — the same two sweeps over
  residual-codec docs, decoded inside the kernel tile by tile.

Queries are fp32; dense docs are fp32 or bf16.  A CPU tensor runs the
plain version (``ref.py``); a CUDA tensor launches the kernel.  Every
route is a Hopper kernel, which splits the queries (and, in the multi
sweep, fp32 docs) into three bf16 planes first, into scratch allocated
here, and takes a dim that is a multiple of 8 up to 128.
``.launches`` on each launching wrapper counts its launches, and
``.bf16_launches`` on the two dense ones the share of them on bf16
docs.  The two multi sweeps take ``block_docs``, the docs a CUDA block
takes (the tuner's ``KernelConfig.block_docs``, rounded up to a whole
tile group by the launcher; :func:`default_block_docs` where not
given); their result does not depend on it.  The reranks size their
own doc groups (one query a block).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.colbert_maxsim.ref import (
    colbert_maxsim_batch_ref, colbert_maxsim_multi_ref,
    colbert_maxsim_rerank_ref,
    colbert_maxsim_residual_multi_ref, colbert_maxsim_residual_rerank_ref)

L_MAX = 64   # query tokens per query the kernels take (one wgmma M)
BF16_DIM_MAX = 128   # the query planes' row length (csrc PLANE_DP)
DOC_DTYPES = (torch.float32, torch.bfloat16)
# doc rows a tile of the multi sweeps: bf16 docs (csrc multi_bf16::TN),
# fp32 and residual docs (sweep::TN)
TILE_ROWS_BF16 = 128
TILE_ROWS = 64


def tile_group(m: int, bf16: bool) -> int:
    """G, the docs of m tokens a multi-sweep tile holds: the tile's rows
    over m padded to a power of two (at least 8), or 1 for a doc that
    fills a tile or more."""
    rows = TILE_ROWS_BF16 if bf16 else TILE_ROWS
    m_pad = max(8, 1 << (max(m, 1) - 1).bit_length())
    return 1 if m_pad >= rows else rows // m_pad


def query_blocks(n_q: int, l: int) -> int:
    """Blocks along the query axis of a multi sweep: two warpgroups of
    floor(64 / l) queries a block."""
    return -(-n_q // (2 * (L_MAX // l)))


def default_block_docs(n_q: int, l: int, n_docs: int, m: int, bf16: bool,
                       device) -> int:
    """The multi sweeps' doc block on ``device``'s card: about four
    blocks an SM over the query blocks, a whole number of tile groups
    (``build.docs_per_block``)."""
    return build.docs_per_block(n_docs, tile_group(m, bf16),
                                query_blocks(n_q, l), build.sm_count(device))


def _device_of(t):
    if not build.plain(t) and t.device.type != "cuda":
        raise ValueError(f"colbert_maxsim runs on cpu or cuda, not "
                         f"{t.device}")
    return t.device


def _queries(q_embs, q_masks):
    """Check the fp32 query side; default mask all-true."""
    n_q, l, dim = q_embs.shape
    dev = q_embs.device
    if l > L_MAX:
        raise ValueError(f"query length {l} exceeds the kernel's {L_MAX}")
    if q_masks is None:
        q_masks = torch.ones((n_q, l), dtype=torch.bool, device=dev)
    build.require(q_embs, "q_embs", torch.float32, (n_q, l, dim), dev)
    build.require(q_masks, "q_masks", torch.bool, (n_q, l), dev)
    return q_masks


def _launch(entry, q_embs, d_embs, d_masks, q_masks, n_docs,
            block_docs=None):
    q_masks = _queries(q_embs, q_masks)
    n_q, l, dim = q_embs.shape
    m = d_embs.shape[-2]
    dev = q_embs.device
    if d_embs.dtype not in DOC_DTYPES:
        raise ValueError(f"d_embs has dtype {d_embs.dtype}, expected one "
                         f"of {DOC_DTYPES}")
    build.require(d_embs, "d_embs", d_embs.dtype,
                  d_masks.shape + (dim,), dev)
    build.require(d_masks, "d_masks", torch.bool, d_masks.shape, dev)
    bf16 = d_embs.dtype == torch.bfloat16
    block = []
    if entry == "colbert_maxsim_multi_launch":
        if bf16 and d_embs.data_ptr() % 16:
            raise ValueError("bf16 d_embs must be 16-byte aligned")
        scratch = _query_planes(q_embs, 64 // l) + (
            (None, None) if bf16 else _doc_planes(d_embs))
        if block_docs is None:
            block_docs = default_block_docs(n_q, l, n_docs, m, bf16, dev)
        block = [int(block_docs)]
    else:
        scratch = _query_planes(q_embs, 1)
        # the rerank reads its candidates 16 bytes at a time (fp32) or
        # through a tensor map (bf16)
        if d_embs.data_ptr() % 16:
            raise ValueError("d_subs must be 16-byte aligned")
    out = torch.empty((n_q, n_docs), dtype=torch.float32, device=dev)
    build.launch(
        "colbert_maxsim", entry, dev, q_embs.data_ptr(), q_masks.data_ptr(),
        d_embs.data_ptr(), d_masks.data_ptr(), n_q, l, n_docs, m, dim,
        int(bf16), *[None if s is None else s.data_ptr() for s in scratch],
        out.data_ptr(), *block, build.stream_ptr(q_embs))
    return out


def _query_planes(q_embs, group):
    """Scratch of the Hopper kernels: the queries' three bf16 planes and
    one flag a group of ``group`` queries (a warpgroup's floor(64 / l) in
    the multi sweeps, one in the reranks)."""
    n_q, l, dim = q_embs.shape
    if dim % 8 or dim > BF16_DIM_MAX:
        raise ValueError(f"dim={dim}: the Hopper kernel takes a multiple "
                         f"of 8 up to {BF16_DIM_MAX}")
    dev = q_embs.device
    planes = torch.empty((3, n_q * l, BF16_DIM_MAX), dtype=torch.bfloat16,
                         device=dev)
    flags = torch.empty((-(-n_q // group),), dtype=torch.int32, device=dev)
    return planes, flags


def _doc_planes(d_embs):
    """Scratch of the multi sweep on fp32 docs: the docs' three bf16
    planes (6 bytes a doc value) and a flag a doc (the kernel uses one a
    tile group)."""
    n_docs, m, _ = d_embs.shape
    dev = d_embs.device
    planes = torch.empty((3, n_docs * m, BF16_DIM_MAX), dtype=torch.bfloat16,
                         device=dev)
    return planes, torch.empty((n_docs,), dtype=torch.int32, device=dev)


def _count(fn, d_embs):
    fn.launches += 1
    fn.bf16_launches += d_embs.dtype == torch.bfloat16


def colbert_maxsim_multi_op(q_embs, d_embs, d_masks, q_masks=None, *,
                            block_docs: int | None = None):
    """(n_q, l, dim) x (n_docs, m, dim) -> (n_q, n_docs)."""
    if _device_of(d_embs).type in build.PLAIN_DEVICES:
        return colbert_maxsim_multi_ref(q_embs, d_embs, d_masks, q_masks,
                                        block_docs=block_docs)
    if d_masks.dim() != 2:
        raise ValueError("d_masks must be (n_docs, m)")
    out = _launch("colbert_maxsim_multi_launch", q_embs, d_embs, d_masks,
                  q_masks, d_masks.shape[0], block_docs)
    _count(colbert_maxsim_multi_op, d_embs)
    return out


colbert_maxsim_multi_op.launches = 0
colbert_maxsim_multi_op.bf16_launches = 0


def colbert_maxsim_rerank_op(q_embs, d_subs, m_subs, q_masks=None):
    """Query i vs its candidate block: q_embs (n_q, l, dim);
    d_subs (n_q, n_cand, m, dim) fp32 or bf16; m_subs (n_q, n_cand, m)
    -> (n_q, n_cand).  On the card, dim is a multiple of 8 up to 128 and
    d_subs 16-byte aligned."""
    if _device_of(d_subs).type in build.PLAIN_DEVICES:
        return colbert_maxsim_rerank_ref(q_embs, d_subs, m_subs, q_masks)
    if m_subs.dim() != 3 or m_subs.shape[0] != q_embs.shape[0]:
        raise ValueError("m_subs must be (n_q, n_cand, m)")
    out = _launch("colbert_maxsim_rerank_launch", q_embs, d_subs, m_subs,
                  q_masks, m_subs.shape[1])
    _count(colbert_maxsim_rerank_op, d_subs)
    return out


colbert_maxsim_rerank_op.launches = 0
colbert_maxsim_rerank_op.bf16_launches = 0


def colbert_maxsim_op(q_emb, d_embs, d_masks, q_mask=None):
    """q_emb (l, dim) x d_embs (n_docs, m, dim) -> (n_docs,)."""
    return colbert_maxsim_rerank_op(
        q_emb[None], d_embs[None], d_masks[None],
        None if q_mask is None else q_mask[None])[0]


def colbert_maxsim_batch_op(q_embs, d_embs, d_masks):
    """q_embs (n_q, l, dim) x d_embs (n_docs, m, dim) -> (n_q, n_docs),
    no query masks: the reference's ``vmap`` of the single-query kernel
    over shared docs.  On the card, one rerank launch (B4) a query over
    the docs as its candidates: the kernel reads a query's candidates
    at its own offset, so a broadcast would have to be copied once a
    query; each launch reads the shared, 16-byte aligned docs in place
    and counts under ``colbert_maxsim_rerank_op.launches``.  Its limits
    are B4's (1-64 query tokens, dim a multiple of 8 up to 128;
    ``ValueError`` otherwise)."""
    if _device_of(d_embs).type in build.PLAIN_DEVICES:
        return colbert_maxsim_batch_ref(q_embs, d_embs, d_masks)
    if q_embs.dim() != 3 or d_masks.dim() != 2:
        raise ValueError("q_embs must be (n_q, l, dim) and d_masks "
                         "(n_docs, m)")
    out = torch.empty((q_embs.shape[0], d_masks.shape[0]),
                      dtype=torch.float32, device=d_embs.device)
    for i in range(q_embs.shape[0]):
        out[i] = colbert_maxsim_rerank_op(q_embs[i:i + 1], d_embs[None],
                                          d_masks[None])[0]
    return out


def _residual_launch(entry, q_embs, q_masks, codes, resq, rscale, tables,
                     bucket_of, d_masks, bits, block_docs=None):
    """Check and launch one residual kernel; ``codes`` (..., n_docs, m)
    with leading query axis on the rerank, ``tables`` (C, dim) or
    (n_buckets, C, dim).  Codes and ``bucket_of`` are not range-checked
    here (that would sync the host); the kernel clamps them into their
    tables, so a malformed index scores garbage but reads no memory
    outside them."""
    q_masks = _queries(q_embs, q_masks)
    n_q, l, dim = q_embs.shape
    dev = q_embs.device
    if bits not in (2, 4) or dim % (8 // bits):
        raise ValueError(f"bits={bits} with dim={dim}: bits in (2, 4) "
                         f"and dim a multiple of {8 // max(bits, 1)}")
    shape = tuple(codes.shape)
    n_docs, m = shape[-2:]
    build.require(codes, "codes", torch.int8, shape, dev)
    build.require(resq, "resq", torch.uint8, shape + (dim * bits // 8,),
                  dev)
    build.require(rscale, "rscale", torch.float32, shape + (1,), dev)
    build.require(d_masks, "d_masks", torch.bool, shape, dev)
    build.require(tables, "codebook", torch.float32,
                  tables.shape[:-1] + (dim,), dev)
    args = [t.data_ptr() for t in (codes, resq, rscale, tables)]
    group = 64 // l
    block = []
    if bucket_of is not None:
        build.require(bucket_of, "bucket_of", torch.int32, shape[:-1], dev)
        args += [bucket_of.data_ptr(), tables.shape[0]]
        group = 1
    else:
        if block_docs is None:
            block_docs = default_block_docs(n_q, l, n_docs, m, False, dev)
        block = [int(block_docs)]
    # the Hopper kernels load a chunk's residual bits as one word and
    # codebook rows 16 bytes at a time
    if resq.data_ptr() % bits or tables.data_ptr() % 16:
        raise ValueError("resq must be aligned to the residual word and "
                         "the codebook to 16 bytes")
    scratch = _query_planes(q_embs, group)
    out = torch.empty((n_q, n_docs), dtype=torch.float32, device=dev)
    build.launch(
        "colbert_maxsim", entry, dev, q_embs.data_ptr(), q_masks.data_ptr(),
        *args, d_masks.data_ptr(), n_q, l, n_docs, m, dim, tables.shape[-2],
        bits, *[t.data_ptr() for t in scratch], out.data_ptr(), *block,
        build.stream_ptr(q_embs))
    return out


def colbert_maxsim_residual_multi_op(q_embs, codes, resq, rscale, codebook,
                                     d_masks, q_masks=None, *, bits: int,
                                     block_docs: int | None = None):
    """A query batch vs ONE residual bucket, decoded in the kernel:
    q_embs (n_q, l, dim) x [codes (n_docs, m) int8, resq (n_docs, m,
    dim*bits//8) uint8, rscale (n_docs, m, 1) f32, codebook (C, dim)
    f32] -> (n_q, n_docs).  Pad rows (code 0, residual 0) decode to
    garbage and must arrive all-masked.  On the card, dim is a multiple
    of 8 up to 128."""
    if _device_of(codes).type in build.PLAIN_DEVICES:
        return colbert_maxsim_residual_multi_ref(
            q_embs, codes, resq, rscale, codebook, d_masks, q_masks,
            bits=bits, block_docs=block_docs)
    if codes.dim() != 2:
        raise ValueError("codes must be (n_docs, m)")
    out = _residual_launch("colbert_maxsim_residual_multi_launch", q_embs,
                           q_masks, codes, resq, rscale, codebook, None,
                           d_masks, bits, block_docs)
    colbert_maxsim_residual_multi_op.launches += 1
    return out


colbert_maxsim_residual_multi_op.launches = 0


def colbert_maxsim_residual_rerank_op(q_embs, code_subs, resq_subs,
                                      scale_subs, codebooks, bucket_of,
                                      m_subs, q_masks=None, *, bits: int):
    """Query i vs its own residual candidates, candidate (i, j) decoding
    against ``codebooks[bucket_of[i, j]]``: code_subs (n_q, n_cand, m)
    int8; resq_subs (n_q, n_cand, m, pb) uint8; scale_subs (n_q, n_cand,
    m, 1) f32; codebooks (n_buckets, C, dim) f32; bucket_of (n_q,
    n_cand) int32; m_subs (n_q, n_cand, m) -> (n_q, n_cand).  The
    reference gathers a (n_q, n_cand, C, dim) codebook tensor; this
    reads each row's table in the kernel instead."""
    if _device_of(code_subs).type in build.PLAIN_DEVICES:
        return colbert_maxsim_residual_rerank_ref(
            q_embs, code_subs, resq_subs, scale_subs, codebooks, bucket_of,
            m_subs, q_masks, bits=bits)
    if code_subs.dim() != 3 or code_subs.shape[0] != q_embs.shape[0]:
        raise ValueError("code_subs must be (n_q, n_cand, m)")
    out = _residual_launch("colbert_maxsim_residual_rerank_launch", q_embs,
                           q_masks, code_subs, resq_subs, scale_subs,
                           codebooks, bucket_of, m_subs, bits)
    colbert_maxsim_residual_rerank_op.launches += 1
    return out


colbert_maxsim_residual_rerank_op.launches = 0
