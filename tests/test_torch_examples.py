"""The PyTorch counterparts of the three examples (``examples/*_torch.py``)
on the CPU, against the reference's functions on the same arrays.

Each counterpart runs through its ``main`` with ``--device cpu``
(``train_colbert_torch`` for 2 steps into a fresh checkpoint directory)
and returns its figures and arrays.  The reference's Voronoi pruning
(``repro.core.voronoi.pruning_order_batch`` and ``global_keep_masks``)
then runs on the same documents with the same sample set: the keep
masks are equal wherever a token's merge key lies farther than fp32
rounding from the budget's cut (two keys that close may fall either
side of it in either package), and the reference's MRR@10 and nDCG@10
of the counterpart's own score arrays are within 1e-5 of its figures.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as j_metrics
from repro.core import voronoi as j_vor
from repro_torch.core import voronoi

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, EXAMPLES)

import prune_and_serve_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import train_colbert_torch  # noqa: E402


def _np(t):
    return t.detach().cpu().numpy()


def _check_keep(d_embs, d_masks, samples, keep, frac):
    """The reference's keep mask at ``frac`` on the same arrays equals
    the counterpart's away from the cut (module docstring)."""
    ranks, errs, _ = j_vor.pruning_order_batch(
        jnp.asarray(_np(d_embs)), jnp.asarray(_np(d_masks)),
        jnp.asarray(_np(samples)))
    want = np.asarray(j_vor.global_keep_masks(ranks, errs,
                                              jnp.asarray(_np(d_masks)),
                                              frac))
    got = _np(keep)
    # the port's merge keys on the reference's ranks and errors
    mono = _np(voronoi._monotone_merge_errs(
        torch.tensor(np.array(ranks)), torch.tensor(np.array(errs)),
        d_masks.cpu()))
    masks = _np(d_masks)
    n_prune = masks.sum() - got.sum()
    cut = np.sort(mono[masks])[max(n_prune - 1, 0)]
    near = np.abs(mono - cut) <= 1e-6 * max(1.0, abs(float(cut)))
    assert got.sum() == want.sum()
    np.testing.assert_array_equal(got[~near], want[~near])
    assert (got != want).sum() <= near.sum()


def _check_metrics(scores, rel, gains, mrr, ndcg=None):
    s = jnp.asarray(_np(scores))
    assert abs(float(j_metrics.mrr_at_k(s, jnp.asarray(_np(rel)), 10))
               - mrr) <= 1e-5
    if ndcg is not None:
        assert abs(float(j_metrics.ndcg_at_k(s, jnp.asarray(gains), 10))
                   - ndcg) <= 1e-5


def test_quickstart():
    from repro_torch.data import synthetic
    out = quickstart_torch.main(["--device", "cpu"])
    assert out["device"] == "cpu"
    c = synthetic.embedding_corpus(seed=0, n_docs=192, n_q=48, dim=24,
                                   m=32, stop_frac=0.5, noise=0.5,
                                   n_topics=24)
    _check_keep(torch.as_tensor(c.d_embs), torch.as_tensor(c.d_masks),
                out["samples"], out["keep"], 0.5)
    for name in ("unpruned", "voronoi", "random", "first_k"):
        r = out[name]
        _check_metrics(r["scores"], torch.as_tensor(c.rel), c.gains,
                       r["mrr10"], r["ndcg10"])
    assert out["voronoi"]["ndcg10"] >= out["random"]["ndcg10"]
    assert out["remain_pct"] == pytest.approx(50.0, abs=0.1)


def test_prune_and_serve():
    from repro_torch.data import synthetic
    out = prune_and_serve_torch.main(["--device", "cpu"])
    c = synthetic.embedding_corpus(seed=3, n_docs=256, n_q=64, dim=24, m=40)
    _check_keep(torch.as_tensor(c.d_embs), torch.as_tensor(c.d_masks),
                out["samples"], out["keep"], out["budget"])
    _check_metrics(out["full_packed"], torch.as_tensor(c.rel), None,
                   out["mrr10_packed"])
    assert out["mrr10_packed"] == out["mrr10_pruned"]
    assert out["compacted_identical"] and out["epoch"] == 1
    assert out["recover"]["rolled_back"] == [99]


def test_train_colbert(tmp_path):
    out = train_colbert_torch.main(["--device", "cpu", "--steps", "2",
                                    "--ckpt-dir", str(tmp_path / "ck")])
    assert out["start"] == 0 and np.isfinite(out["final_loss"])
    assert os.listdir(tmp_path / "ck")
    _check_keep(out["d_emb"], out["d_mask"], out["samples"], out["keep"],
                0.5)
    _check_metrics(out["scores"], out["rel"], None, out["mrr10"])
    _check_metrics(out["scores_pruned"], out["rel"], None,
                   out["mrr10_pruned"])


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for mod in (quickstart_torch, prune_and_serve_torch,
                train_colbert_torch):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
