"""Wrappers of the ColBERT MaxSim CUDA kernels
(``csrc/colbert_maxsim.cu``).

Counterpart of ``repro.kernels.colbert_maxsim.ops``:

* :func:`colbert_maxsim_multi_op` — a query batch vs one doc array in
  one launch (the e2e / exact scoring sweep);
* :func:`colbert_maxsim_rerank_op` — each query vs its OWN candidate
  block (two-stage rerank), one launch over (candidates x queries);
* :func:`colbert_maxsim_op` — one query vs a doc batch, the
  ``n_q = 1`` case of the rerank kernel.

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor
launches the kernel.  ``.launches`` on the two launching wrappers
counts their launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.colbert_maxsim.ref import (
    colbert_maxsim_multi_ref, colbert_maxsim_rerank_ref)

L_MAX = 64   # query tokens per query the kernel takes (csrc RT)


def _device_of(t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"colbert_maxsim runs on cpu or cuda, not "
                         f"{t.device}")
    return t.device


def _launch(entry, q_embs, d_embs, d_masks, q_masks, n_docs):
    n_q, l, dim = q_embs.shape
    m = d_embs.shape[-2]
    dev = q_embs.device
    if l > L_MAX:
        raise ValueError(f"query length {l} exceeds the kernel's {L_MAX}")
    if q_masks is None:
        q_masks = torch.ones((n_q, l), dtype=torch.bool, device=dev)
    build.require(q_embs, "q_embs", torch.float32, (n_q, l, dim), dev)
    build.require(q_masks, "q_masks", torch.bool, (n_q, l), dev)
    build.require(d_embs, "d_embs", torch.float32,
                  d_masks.shape + (dim,), dev)
    build.require(d_masks, "d_masks", torch.bool, d_masks.shape, dev)
    out = torch.empty((n_q, n_docs), dtype=torch.float32, device=dev)
    lib = build.library("colbert_maxsim")
    build.check("colbert_maxsim", getattr(lib, entry)(
        q_embs.data_ptr(), q_masks.data_ptr(), d_embs.data_ptr(),
        d_masks.data_ptr(), n_q, l, n_docs, m, dim, out.data_ptr(),
        build.stream_ptr(q_embs)))
    return out


def colbert_maxsim_multi_op(q_embs, d_embs, d_masks, q_masks=None):
    """(n_q, l, dim) x (n_docs, m, dim) -> (n_q, n_docs)."""
    if _device_of(d_embs).type == "cpu":
        return colbert_maxsim_multi_ref(q_embs, d_embs, d_masks, q_masks)
    if d_masks.dim() != 2:
        raise ValueError("d_masks must be (n_docs, m)")
    out = _launch("colbert_maxsim_multi_launch", q_embs, d_embs, d_masks,
                  q_masks, d_masks.shape[0])
    colbert_maxsim_multi_op.launches += 1
    return out


colbert_maxsim_multi_op.launches = 0


def colbert_maxsim_rerank_op(q_embs, d_subs, m_subs, q_masks=None):
    """Query i vs its candidate block: q_embs (n_q, l, dim);
    d_subs (n_q, n_cand, m, dim); m_subs (n_q, n_cand, m) ->
    (n_q, n_cand)."""
    if _device_of(d_subs).type == "cpu":
        return colbert_maxsim_rerank_ref(q_embs, d_subs, m_subs, q_masks)
    if m_subs.dim() != 3 or m_subs.shape[0] != q_embs.shape[0]:
        raise ValueError("m_subs must be (n_q, n_cand, m)")
    out = _launch("colbert_maxsim_rerank_launch", q_embs, d_subs, m_subs,
                  q_masks, m_subs.shape[1])
    colbert_maxsim_rerank_op.launches += 1
    return out


colbert_maxsim_rerank_op.launches = 0


def colbert_maxsim_op(q_emb, d_embs, d_masks, q_mask=None):
    """q_emb (l, dim) x d_embs (n_docs, m, dim) -> (n_docs,)."""
    return colbert_maxsim_rerank_op(
        q_emb[None], d_embs[None], d_masks[None],
        None if q_mask is None else q_mask[None])[0]
