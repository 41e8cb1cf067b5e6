"""The plain serving MaxSim gives a doc the same bits alone and in any
batch (``kernels/colbert_maxsim/ref.py``): one batched product a block
of a fixed 64 docs, zero-padded.  One batched product over all the docs
broke this on an AVX-512 CPU at 8 threads, at l 8 and m 20."""

import pytest
import torch

from repro_torch.kernels.colbert_maxsim.ref import (colbert_maxsim_multi_ref,
                                                    colbert_maxsim_ref)

N_DOCS, L, M = 37, 8, 20


@pytest.fixture
def eight_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _inputs(dim):
    g = torch.Generator().manual_seed(dim)
    q = torch.randn((3, L, dim), generator=g)
    d = torch.randn((N_DOCS, M, dim), generator=g)
    mask = torch.rand((N_DOCS, M), generator=g) < 0.8
    mask[:, 0] = True
    q_mask = torch.rand((3, L), generator=g) < 0.9
    return q, d, mask, q_mask


def _score(fn, q, d, mask, q_mask):
    if fn is colbert_maxsim_ref:
        return torch.stack([fn(qi, d, mask, qm) for qi, qm in zip(q, q_mask)])
    return fn(q, d, mask, q_mask)


@pytest.mark.parametrize("dim", [8, 16, 32, 64, 128])
@pytest.mark.parametrize(
    "fn", [colbert_maxsim_ref, colbert_maxsim_multi_ref],
    ids=["colbert_maxsim_ref", "colbert_maxsim_multi_ref"])
def test_doc_alone_equals_doc_in_batch(fn, dim, eight_threads):
    q, d, mask, q_mask = _inputs(dim)
    full = _score(fn, q, d, mask, q_mask)
    assert full.shape == (3, N_DOCS)
    for i in range(N_DOCS):
        alone = _score(fn, q, d[i:i + 1], mask[i:i + 1], q_mask)
        assert torch.equal(alone[:, 0], full[:, i]), i
        lo = max(0, i - 3)                       # shifted within a block
        some = _score(fn, q, d[lo:i + 5], mask[lo:i + 5], q_mask)
        assert torch.equal(some[:, i - lo], full[:, i]), i


def test_no_docs():
    q, d, mask, _ = _inputs(8)
    assert colbert_maxsim_ref(q[0], d[:0], mask[:0]).shape == (0,)
    assert colbert_maxsim_multi_ref(q, d[:0], mask[:0]).shape == (3, 0)
