"""Plain PyTorch version of the ``maxsim_top2`` kernel.

Counterpart of ``repro.kernels.maxsim_top2.ref``: per (document,
sample), (best, second, argbest, argsecond) of samples @ tokens.T over
alive tokens, through the materialized score tensor.  The CPU path of
the wrapper and the oracle the kernel is held against on the card.

:func:`maxsim_top2_rows_ref` is the same reduction over the rows of one
large table (Voronoi table pruning, ``core.table_pruning``), taken in
row chunks and merged by :func:`merge_chunk_top2`, so nothing
(N, V)-shaped is built.
"""

from __future__ import annotations

import torch

from repro_torch.core.scoring import doc_scores, top2_from_scores


def maxsim_top2_ref(samples, tokens, alive, *, block_docs=None):
    """samples (N, dim); tokens (..., m, dim); alive (..., m) bool ->
    best, second (..., N) f32 and argbest, argsecond (..., N) int32.
    ``block_docs`` (the kernel's doc block) changes nothing here."""
    scores = doc_scores(samples.float(), tokens.float())
    return top2_from_scores(scores, alive)


def merge_chunk_top2(best, second, bi, si, starts):
    """Global top-2 of a table from the top-2s of its row ranges:
    ``best``, ``second``, ``bi``, ``si`` (C, N) with range-local
    indices, range c starting at global row ``starts[c]`` (ascending,
    (C,) int64) -> (N,) each, int32 indices.

    Exact under (-score, global row): the best is the first range's
    best among the largest (ranges ascend, and a range's index is its
    lowest maximal row); the second is the largest of the winning
    range's second and every other range's best, lowest row on ties —
    ``top2_from_scores`` over the whole row, as the reference's two
    ``argmax``es take it.  A range with one alive row seconds at
    ``NEG_INF``, which any other range's best beats, so pad rows and
    ``NEG_INF`` never come out of a table of two or more rows."""
    off = starts.to(device=best.device, dtype=torch.int64)[:, None]
    g_bi, g_si = bi.long() + off, si.long() + off
    w = best.argmax(0, keepdim=True)                    # first maximum
    b = best.gather(0, w)[0]
    b_i = g_bi.gather(0, w)[0]
    cand = best.scatter(0, w, second.gather(0, w))
    cand_i = g_bi.scatter(0, w, g_si.gather(0, w))
    w2 = cand.argmax(0, keepdim=True)
    return (b, cand.gather(0, w2)[0], b_i.to(torch.int32),
            cand_i.gather(0, w2)[0].to(torch.int32))


# Rows of the table a score product takes at once (the last block
# zero-padded): a row's scores come from its block's own product, so
# they are the same bits whatever ``chunk`` asks for them (a product's
# blocking, on the CPU and on the card, follows its shape).
ROW_BLOCK = 4096


def maxsim_top2_rows_ref(samples, table, chunk: int = 4096):
    """samples (N, dim); table (V, dim) -> (best, second, argbest,
    argsecond) over every row, each (N,): each chunk of ``chunk`` rows
    reduced by ``top2_from_scores`` (in pieces where it crosses a
    :data:`ROW_BLOCK` boundary), the pieces merged by
    :func:`merge_chunk_top2`.  Nothing (N, V)-shaped is built, and the
    result is the same bits for any ``chunk``."""
    V, dim = table.shape
    if V < 1 or chunk < 1:
        raise ValueError(f"need a table of >= 1 row and chunk >= 1, got "
                         f"{V} rows and chunk {chunk}")
    s = samples.float()
    cuts = sorted(set(range(0, V, chunk)) | set(range(0, V, ROW_BLOCK)))
    parts, block, scores = [], None, None
    for a, b in zip(cuts, cuts[1:] + [V]):
        g = a // ROW_BLOCK * ROW_BLOCK
        if g != block:
            rows = table[g:g + ROW_BLOCK].float()
            if rows.shape[0] < ROW_BLOCK:
                rows = torch.cat([rows, rows.new_zeros(
                    (ROW_BLOCK - rows.shape[0], dim))])
            block, scores = g, s @ rows.T
        alive = torch.ones(b - a, dtype=torch.bool, device=s.device)
        parts.append(top2_from_scores(scores[:, a - g:b - g], alive))
    return merge_chunk_top2(*(torch.stack(p) for p in zip(*parts)),
                            starts=torch.tensor(cuts))
