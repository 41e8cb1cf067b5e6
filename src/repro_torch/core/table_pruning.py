"""Voronoi-mass pruning of recsys embedding-table rows.

Counterpart of ``repro.core.table_pruning`` (a beyond-paper extension):
the paper's estimator (Eq. 5/8) applied to a table, its rows taking the
place of a document's tokens and unit-sphere user/query vectors the
place of queries.  A row's error is the top-1 retrieval loss if it were
evicted; low-error rows go first.

Where the reference reduces the whole (N, V) score matrix at once (its
``chunk`` argument is unused), the port streams the top-2 over row
chunks (``kernels.maxsim_top2``'s ``maxsim_top2_rows_op``: B1 on the
card, its plain version on the CPU), so at dlrm-rm2's 1,048,576 rows and
8,192 samples nothing (N, V)-shaped (34.4 GB) is built, and sums Eq. 8
by global cell in sample order (``core.segment.segment_rows_sum``: a
stable sort, then each cell's gaps added one after another; no one-hot
and no atomics, whose order changes from run to run).  The
errors are the same bits for any ``chunk``.

With N samples at most N rows can own a sample, so every other row's
error is exactly 0 (at 8,192 samples, 99.2 % of a million rows).  The
order is a stable descending sort of the errors, as ``jnp.argsort``'s,
so the zero-error rows a ``keep_fraction`` keeps are the lowest-indexed
ones.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core.sampling import sample_sphere
from repro_torch.core.segment import segment_rows_sum
from repro_torch.kernels.maxsim_top2.ops import maxsim_top2_rows_op
from repro_torch.kernels.maxsim_top2.ref import maxsim_top2_rows_ref

__all__ = ["keep_mask", "prune_table", "table_row_errors"]


def table_row_errors(table, samples, chunk: int = 4096,
                     backend: str | None = None):
    """Eq. 8 error per table row (the top-1 retrieval degradation if it
    were evicted): table (V, D), samples (N, D) -> (V,) fp32.  The top-2
    streams over ``chunk``-row chunks on ``fused`` (B1 on the card; the
    default there) or the plain chunked version on ``reference`` (the
    CPU's default)."""
    backend = backend_lib.resolve_backend(
        backend, allow=backend_lib.SERVING, device=table.device)
    top2 = (maxsim_top2_rows_op if backend == backend_lib.FUSED
            else maxsim_top2_rows_ref)
    best, second, bi, _ = top2(samples, table, chunk)
    return segment_rows_sum(best - second, bi.long(),
                            table.shape[0]) / samples.shape[0]


def keep_mask(errs, keep_fraction: float):
    """The keep mask of the ``ceil(keep_fraction * V)`` rows of largest
    error, ties to the lower row: the rank of each row in a stable
    descending sort (``jnp.argsort(-errs)``'s order), below the count,
    which is the reference's product (Python float64) rounded up in
    fp32."""
    n_keep = int(np.ceil(np.float32(keep_fraction * errs.shape[0])))
    order = torch.sort(-errs, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank < n_keep


def prune_table(generator: torch.Generator, table, keep_fraction: float,
                n_samples: int = 8192):
    """Keep mask over table rows (one-shot, non-iterative; see
    :func:`keep_mask`).  Samples come from ``generator`` on its device,
    moved to the table's."""
    samples = sample_sphere(generator, n_samples, table.shape[1],
                            device=table.device)
    return keep_mask(table_row_errors(table, samples), keep_fraction)
