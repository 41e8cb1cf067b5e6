"""Row gathers whose gradient sums in a fixed order.

Training gathers rows with repeats: a CTR batch's ids hit a table row
more than once, BERT4Rec's masked positions and sampled items repeat.
The gradient of a gather adds the repeats' rows, and autograd's
backward adds them in an order that changes from run to run: on the CPU
``index_put_`` with ``accumulate=True`` adds by atomics across threads,
on the card ``gather``/``index_select`` backward add by ``index_add_``'s
atomics.  A resumed run would then drift from an uninterrupted one in
the last bits.

:func:`take_rows` is ``table[idx]`` whose backward sums each row's
repeats in the order they appear in ``idx`` (a stable sort by row, then
``torch.segment_reduce``, which adds a segment's rows one after another
on the CPU and the card), into a dense gradient, as JAX's scatter-add
into zeros gives.  It is bit for bit the same from run to run on one
device and thread count.
"""

from __future__ import annotations

import torch

__all__ = ["segment_rows_sum", "take_rows"]


def segment_rows_sum(vals, rows, n_rows: int):
    """out[r] = sum of vals[i] over i with rows[i] == r, added in i's
    order -> (n_rows, *vals.shape[1:]); rows outside [0, n_rows) are
    not allowed.  vals (n, ...), rows (n,) integer."""
    out = vals.new_zeros((n_rows,) + tuple(vals.shape[1:]))
    if not rows.numel():
        return out
    order = torch.sort(rows, stable=True).indices
    keys, counts = torch.unique_consecutive(rows[order], return_counts=True)
    flat = vals[order].reshape(order.numel(), -1)     # segment_reduce: >= 2-D
    sums = torch.segment_reduce(flat, "sum", lengths=counts, axis=0,
                                unsafe=True)
    out[keys] = sums.view((keys.numel(),) + tuple(vals.shape[1:]))
    return out


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        flat = idx.reshape(-1).long()
        return table.index_select(0, flat).view(tuple(idx.shape)
                                                + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        tail = tuple(grad.shape[idx.dim():])
        g = segment_rows_sum(grad.reshape((-1,) + tail),
                             idx.reshape(-1).long(), ctx.n_rows)
        return g, None


def take_rows(table, idx):
    """``table[idx]`` -> (*idx.shape, *table.shape[1:]) for integer
    ``idx`` in [0, len(table)), with a backward that sums repeated rows
    in ``idx``'s order (module docstring)."""
    return _TakeRows.apply(table, idx)
