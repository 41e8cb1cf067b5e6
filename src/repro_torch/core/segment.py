"""Row gathers and segment sums that add in a fixed order.

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

:func:`segment_gather_sum` is the GNN's message passing, ``out[i] = sum
of x[src[e]] over the edges e with dst[e] == i`` (the reference's
``jax.ops.segment_sum(x[src], dst)``), without the (E, d) message
tensor that its plain form builds, sorts and saves for the backward
(24.7 GB at ``ogb_products``' layer 0).  A :class:`GatherPlan`, built
once per edge index and mask, holds the kept edges sorted stably by dst
(the forward) and by src (the backward).  Each direction walks its
sorted edges in chunks of at most ``chunk_edges``, gathers a chunk's
rows and sums each segment in edge order, piece by piece: a piece is
at most ``PIECE_EDGES`` edges, and the pieces' sums are added in piece
order in runs of at most ``PIECE_EDGES``, level by level, until one is
left a segment (a fixed tree: 3 levels for a segment of 262,144
edges).  Every level is ``torch.segment_reduce`` over 2-D values, which
adds a run's rows one after another on the CPU and the card, so the
order is fixed by the plan alone: the same bits on every run and for
every chunk size, no atomics (no ``index_add_``, ``scatter_add_`` or
accumulating ``index_put_``), and no thread that loops over one node's
tens of millions of edges.  The backward saves
the plan's index tensors only.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["CHUNK_EDGES", "GatherPlan", "PIECE_EDGES", "gather_plan",
           "segment_gather_sum", "segment_rows_sum", "take_rows"]

# Values one sum covers at most: a segment's edges are summed in pieces
# of this many, in edge order, and the pieces' sums in runs of this many,
# level by level (64 keeps a same-sign sum's fp32 error near 1e-6 of its
# magnitude at every level).
PIECE_EDGES = 64
# Edges gathered at a time: 4,194,304 rows of d 64 fp32 are 1.07 GB.
CHUNK_EDGES = 1 << 22


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


def _runs(counts, piece: int):
    """Groups of ``counts[i]`` consecutive values cut into runs of at
    most ``piece``: (each run's length, in order; runs per group)."""
    runs = (counts + piece - 1) // piece
    group = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), runs)
    pos = (torch.arange(group.numel(), device=counts.device)
           - (torch.cumsum(runs, 0) - runs)[group])
    return torch.clamp(counts[group] - pos * piece, max=piece), runs


@dataclasses.dataclass(frozen=True)
class _Walk:
    """One direction of a :class:`GatherPlan`: the rows to gather in
    segment order, each first-level piece's edge count and end, the run
    lengths of each higher level, each nonempty segment's id, and the
    output's row count."""
    rows: torch.Tensor              # (E,) int32
    piece_len: torch.Tensor         # (P,) int64
    piece_end: torch.Tensor         # (P,) int64, cumulative
    seg_ids: torch.Tensor           # (S,) int64
    levels: tuple                   # int64 run lengths, one tensor a level
    n_out: int

    def tensors(self):
        return (self.rows, self.piece_len, self.piece_end, self.seg_ids,
                *self.levels)


def _walk(keys, rows, n_out: int) -> _Walk:
    """Edges grouped by ``keys`` (their order kept within a key), each
    group cut into pieces of at most ``PIECE_EDGES`` edges, the pieces'
    sums into runs of at most ``PIECE_EDGES`` a level until one is left
    a group.  On ``meta`` (the dry run's counts), :func:`_walk_bound`."""
    order = torch.sort(keys, stable=True).indices
    seg_ids, counts = torch.unique_consecutive(keys[order],
                                               return_counts=True)
    if keys.is_meta:
        return _walk_bound(rows[order].int(), n_out)
    piece_len, runs = _runs(counts, PIECE_EDGES)
    levels = []
    while runs.numel() and int(runs.max()) > 1:
        lens, runs = _runs(runs, PIECE_EDGES)
        levels.append(lens)
    return _Walk(rows[order].int(), piece_len, torch.cumsum(piece_len, 0),
                 seg_ids.long(), tuple(levels), n_out)


def _walk_bound(rows, n_out: int) -> _Walk:
    """A walk of meta tensors at the sizes that bound any data's (the
    counting rule of ``launch/roofline.py``): every one of the E edges
    gathered, at most min(E, n_out) segments and min(E, segments +
    ceil(E / PIECE_EDGES)) pieces, as many levels as a segment of all E
    edges needs, each level's runs at most segments + ceil(runs /
    PIECE_EDGES), the last one a run a segment."""
    E = rows.numel()
    n_seg = min(E, n_out)
    n_pieces = min(E, n_seg + -(-E // PIECE_EDGES))
    levels, runs, longest = [], n_pieces, -(-E // PIECE_EDGES)
    while longest > 1:
        longest = -(-longest // PIECE_EDGES)
        runs = n_seg if longest <= 1 else min(
            runs, n_seg + -(-runs // PIECE_EDGES))
        levels.append(torch.empty(runs, dtype=torch.long, device="meta"))
    if not levels and n_pieces > n_seg:
        levels.append(torch.empty(n_seg, dtype=torch.long, device="meta"))
    piece_len = torch.empty(n_pieces, dtype=torch.long, device="meta")
    return _Walk(rows, piece_len, torch.cumsum(piece_len, 0),
                 torch.empty(n_seg, dtype=torch.long, device="meta"),
                 tuple(levels), n_out)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """The kept edges of one edge index and mask, walked by dst
    (``fwd``: rows are src) and by src (``bwd``: rows are dst); see
    :func:`gather_plan`."""
    fwd: _Walk
    bwd: _Walk


def gather_plan(src, dst, n_out: int, edge_mask=None, *,
                n_in=None) -> GatherPlan:
    """The plan of ``out[i] = sum of x[src[e]] over e with dst[e] == i
    and edge_mask[e]`` for x of ``n_in`` rows (default ``n_out``): edges
    whose mask is False are dropped, which gives the sums that
    ``where(mask, x[src], 0)`` gives.  src and dst (E,) integers in range,
    on the device the sums run on; built once per edge index and mask
    (two stable sorts of the kept edges)."""
    src, dst = src.reshape(-1), dst.reshape(-1)
    if edge_mask is not None:
        keep = edge_mask.reshape(-1).bool()
        src, dst = src[keep], dst[keep]
    n_in = n_out if n_in is None else n_in
    return GatherPlan(_walk(dst, src, n_out), _walk(src, dst, n_in))


def _walk_sum(walk: _Walk, vals, chunk_edges: int, msg_hook=None):
    """Row i of the result: the sum of ``vals``' rows that ``walk`` maps
    to segment i, in the plan's fixed order (module docstring)."""
    flat = vals.reshape(vals.shape[0], -1)
    out = flat.new_zeros((walk.n_out, flat.shape[1]))
    n_edges, n_pieces = walk.rows.numel(), walk.piece_len.numel()
    if not n_edges:
        return out.view((walk.n_out,) + tuple(vals.shape[1:]))
    # a chunk is the whole pieces that end past the previous cut and at
    # or before the next multiple of chunk_edges; a piece longer than
    # chunk_edges makes a chunk of its own (on meta, one chunk: the same
    # rows and pieces, the cuts being values)
    dev = walk.piece_end.device
    if dev.type == "meta":
        p_cuts, e_cuts = [0, n_pieces], [0, n_edges]
    else:
        marks = torch.arange(chunk_edges, max(n_edges, chunk_edges),
                             chunk_edges, device=dev)
        cuts = torch.searchsorted(walk.piece_end, marks, right=True)
        p_cuts = ([0] + sorted(set(cuts.tolist()) - {0, n_pieces})
                  + [n_pieces])
        e_cuts = [0] + walk.piece_end[torch.tensor(p_cuts[1:], device=dev)
                                      - 1].tolist()
    sums = flat.new_empty((n_pieces, flat.shape[1]))
    for p0, p1, e0, e1 in zip(p_cuts, p_cuts[1:], e_cuts, e_cuts[1:]):
        msg = flat.index_select(0, walk.rows[e0:e1].long())
        if msg_hook is not None:
            msg = msg_hook(msg)
        sums[p0:p1] = torch.segment_reduce(
            msg, "sum", lengths=walk.piece_len[p0:p1], axis=0, unsafe=True)
        del msg
    for lens in walk.levels:
        sums = torch.segment_reduce(sums, "sum", lengths=lens, axis=0,
                                    unsafe=True)
    out.index_copy_(0, walk.seg_ids, sums)
    return out.view((walk.n_out,) + tuple(vals.shape[1:]))


class _SegmentGatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, chunk_edges, msg_hook):
        if x.shape[0] != plan.bwd.n_out:
            raise ValueError(f"x has {x.shape[0]} rows; the plan's sources "
                             f"index {plan.bwd.n_out}")
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(*plan.bwd.tensors())
            ctx.n_in, ctx.chunk_edges = plan.bwd.n_out, chunk_edges
        return _walk_sum(plan.fwd, x, chunk_edges, msg_hook)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        rows, piece_len, piece_end, seg_ids, *levels = ctx.saved_tensors
        walk = _Walk(rows, piece_len, piece_end, seg_ids, tuple(levels),
                     ctx.n_in)
        return (_walk_sum(walk, grad.contiguous(), ctx.chunk_edges), None,
                None, None)


def segment_gather_sum(x, plan: GatherPlan, *, chunk_edges: int = CHUNK_EDGES,
                       msg_hook=None):
    """``out[i] = sum of x[src[e]] over the kept edges e with dst[e] == i``
    -> (plan's n_out, *x.shape[1:]), for the ``plan`` of
    :func:`gather_plan`, differentiable in x: the gradient is the same
    walk by src over the output's gradient rows.  The sums' order is the
    plan's alone (module docstring): bit-equal for every ``chunk_edges``.
    ``msg_hook`` is applied to each chunk's gathered (edges, d) message
    rows in the forward (the GNN's sharding constraint)."""
    return _SegmentGatherSum.apply(x, plan, chunk_edges, msg_hook)
