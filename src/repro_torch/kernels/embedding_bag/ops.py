"""Wrapper of the EmbeddingBag CUDA kernel (``csrc/embedding_bag.cu``).

Counterpart of ``repro.kernels.embedding_bag.ops.embedding_bag_op``:
table (V, D), ids (n_bags, nnz) int32 -> (n_bags, D) f32, each bag the
sum of its rows (``mode="sum"``) or that sum divided by ``nnz``
(``mode="mean"``).  Ids out of range follow ``jnp.take``: [-V, 0)
wraps, outside [-V, V) gives a NaN row.

A CPU tensor runs the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises, and raises where autograd records and
the table requires grad (the kernel has no backward;
``build.refuse_grad``).  ``embedding_bag_op.launches`` counts
launches.  The kernel takes a contiguous fp32 table (the configs' type)
and contiguous int32 ids; it reads 16-byte rows when ``D % 4 == 0`` and
the table is 16-byte aligned, 4-byte elements otherwise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.embedding_bag.ref import MODES, embedding_bag_ref

INT32_MAX = 2 ** 31 - 1


def _check(table, ids, mode):
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; one of {MODES}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}: expected (V, D) and "
                         f"(n_bags, nnz)")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids have dtype {ids.dtype}, expected int32")


def _launch(table, ids, mode):
    V, D = table.shape
    n_bags, nnz = ids.shape
    build.require(table, "table", torch.float32, (V, D), table.device)
    build.require(ids, "ids", torch.int32, (n_bags, nnz), table.device)
    if max(n_bags, nnz, D) > INT32_MAX:
        raise ValueError(f"{n_bags} bags of {nnz} ids, D {D}: the kernel "
                         f"takes each below 2^31")
    out = torch.empty((n_bags, D), dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out                               # nothing to launch
    build.launch(
        "embedding_bag", "embedding_bag_launch", table.device,
        table.data_ptr(), ids.data_ptr(), V, D, n_bags, nnz,
        int(mode == "mean"), out.data_ptr(), build.stream_ptr(table))
    embedding_bag_op.launches += 1
    return out


def embedding_bag_op(table, ids, *, mode: str = "sum"):
    """table: (V, D) fp32; ids: (n_bags, nnz) int32 -> (n_bags, D) f32."""
    _check(table, ids, mode)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, mode)
    build.refuse_grad("embedding_bag", table)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu or cuda, not "
                         f"{table.device}")
    return _launch(table, ids, mode)


embedding_bag_op.launches = 0
