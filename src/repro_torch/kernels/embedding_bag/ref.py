"""Plain PyTorch version of the fused EmbeddingBag kernel.

Counterpart of ``repro.kernels.embedding_bag.ref``: per bag, the sum of
its ``nnz`` table rows in fp32, divided by ``nnz`` for ``mode="mean"``.

Ids out of range follow the oracle's ``jnp.take``: an id in [-V, 0)
wraps to ``id + V``, and an id outside [-V, V) gives a row of NaN.  The
gather here never indexes outside the table (on the card an
out-of-bounds index is a device-side assert): a bad id reads row 0 and
its row is then replaced by NaN.

The rows of a bag are added one at a time in ascending order onto zero,
the Pallas kernel's order (``out_ref[...] += row``), so this version
equals that kernel bit for bit on fp32 tables, and equals the CUDA
kernel, which adds in the same order.
"""

from __future__ import annotations

import torch

MODES = ("sum", "mean")


def wrap_ids(ids, V: int):
    """(int64 row indices safe to gather, bool validity) for ``ids``
    into a table of ``V`` rows, by ``jnp.take``'s rule."""
    ids = ids.long()
    ids = torch.where(ids < 0, ids + V, ids)
    valid = (ids >= 0) & (ids < V)
    return torch.where(valid, ids, 0), valid


def gather_rows(table, ids):
    """``table[ids]`` under ``jnp.take``'s rule: (*ids.shape, D), NaN
    rows for ids outside [-V, V)."""
    safe, valid = wrap_ids(ids, table.shape[0])
    rows = table[safe]
    return torch.where(valid[..., None], rows, float("nan"))


def bag_reduce(rows, mode: str = "sum"):
    """rows (n_bags, nnz, D) -> (n_bags, D) f32: the rows of each bag
    added onto zero in ascending order, divided by nnz for ``mean``."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r}; one of {MODES}")
    out = torch.zeros((rows.shape[0], rows.shape[2]), dtype=torch.float32,
                      device=rows.device)
    for j in range(rows.shape[1]):
        out = out + rows[:, j].float()
    if mode == "mean":
        # a tensor divisor: PyTorch's CUDA division by a Python scalar
        # multiplies by its reciprocal, one rounding off the oracle's
        out = out / torch.full_like(out, rows.shape[1])
    return out


def embedding_bag_ref(table, ids, mode: str = "sum"):
    """table: (V, D); ids: (n_bags, nnz) -> (n_bags, D) f32."""
    return bag_reduce(gather_rows(table, ids), mode)
