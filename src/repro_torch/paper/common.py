"""Shared setup of the paper drivers: the synthetic token corpus, the two
ColBERT encoders (sphere and ball geometry) trained with the
reference's recipe, encoding, Voronoi keep masks and timing.

Counterpart of ``benchmarks/common.py``.  A :class:`Scale` fixes the
encoder config and the corpus sizes: :data:`BENCH` is the reference's
CPU-scaled bench (2 layers, width 48, 256 docs of 32 tokens),
:data:`FULL` the full ``colbert`` config (12 layers, width 768, bf16)
on a 4x corpus (1,024 docs of 180 tokens, 256 queries).  Every driver
splits into "train and encode" and "rows from embeddings", so a caller
can feed the second step an encoder of its own.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``core.backend.resolve_device``); on the card, pruning and scoring take
the port's default backends (``shortlist_topk`` pruning through
``maxsim_topk``, ``fused`` scoring through ``colbert_maxsim_multi``).
The sample sets, the random keep masks and the encoders' weights come
from ``torch.Generator`` streams, so they differ from the reference's
by design; :func:`samples` and :func:`random_keep` are the seams a
caller replaces to feed the reference's draws.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import colbert_base
from repro_torch.core import baselines, metrics, voronoi
from repro_torch.core.backend import resolve_device
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.models import colbert as colbert_lib
from repro_torch.models.colbert import ColBERTConfig
from repro_torch.serve.retrieval import maxsim_scores
from repro_torch.train import checkpoint, optimizer, train_step

CFG_SPHERE = dataclasses.replace(colbert_base.SMOKE, name="bench-sphere",
                                 vocab=1024, n_layers=2, d_model=48,
                                 n_heads=4, d_ff=96, out_dim=24,
                                 query_len=8, doc_len=32, norm="sphere")
CFG_BALL = dataclasses.replace(CFG_SPHERE, name="bench-ball", norm="ball")

N_DOCS, N_Q = 256, 64
TRAIN_STEPS = 240
BATCH = 16
LR, WARMUP = 2e-3, 20


@dataclasses.dataclass(frozen=True)
class Scale:
    """The two encoder configs (sphere and ball geometry) and the corpus
    sizes of one run."""

    sphere: ColBERTConfig = CFG_SPHERE
    ball: ColBERTConfig = CFG_BALL
    n_docs: int = N_DOCS
    n_q: int = N_Q
    domain_docs: int = 192          # Table 3's shifted corpora
    domain_q: int = 48


BENCH = Scale()
FULL = Scale(sphere=colbert_base.CONFIG,
             ball=dataclasses.replace(colbert_base.CONFIG,
                                      name="colbert-ball", norm="ball"),
             n_docs=4 * N_DOCS, n_q=4 * N_Q, domain_docs=4 * 192,
             domain_q=4 * 48)


def corpus(scale: Scale = BENCH):
    """The in-domain token corpus (seed 0)."""
    cfg = scale.sphere
    return synthetic.token_corpus(0, n_docs=scale.n_docs, n_q=scale.n_q,
                                  vocab=cfg.vocab, m=cfg.doc_len,
                                  l=cfg.query_len)


def train_encoder(cfg: ColBERTConfig, *, reg: str | None = None,
                  alpha: float = 0.0, steps: int = TRAIN_STEPS,
                  seed: int = 0, scale: Scale = BENCH, device=None,
                  model=None, cache_dir: str | None = None):
    """Train an encoder on the in-domain corpus with the reference's
    recipe: AdamW lr 2e-3 with 20 warmup steps over ``steps`` steps,
    batch 16, each query paired with its first relevant doc, the queries
    drawn by ``numpy.random.default_rng(seed)``.  Starts from ``model``
    (moved to ``device``) or from ``init_params`` seeded with ``seed``.
    With ``cache_dir``, a finished run is restored from the port's
    checkpoint there and a new one is saved.  Returns ``(model, info)``,
    info ``{"losses": [...], "wall_s": s}``."""
    device = resolve_device(device)
    if model is None:
        model = colbert_lib.init_params(
            torch.Generator(device="cpu").manual_seed(seed), cfg, device)
    model = model.to(device)
    opt_cfg = optimizer.AdamWConfig(lr=LR, warmup_steps=WARMUP,
                                    total_steps=steps)
    state = train_step.make_train_state(model)
    ckpt = (os.path.join(cache_dir, f"{cfg.name}_{reg}_{alpha}_{steps}_"
                                    f"{seed}") if cache_dir else None)
    if ckpt:
        got, tree = checkpoint.restore_latest(ckpt,
                                              train_step.state_tree(state))
        if tree is not None and got >= steps:
            state = train_step.load_state_tree(state, tree)
            return state["params"].eval(), {"losses": [], "wall_s": 0.0}
    c = corpus(scale)
    step = train_step.colbert_train_step(cfg, opt_cfg, reg=reg, alpha=alpha)
    rel = c.rel
    pos = np.array([np.flatnonzero(rel[q])[0] if rel[q].any() else 0
                    for q in range(c.q_ids.shape[0])])
    q_ids = torch.as_tensor(c.q_ids, device=device)
    doc_ids = torch.as_tensor(c.doc_ids, device=device)
    pos = torch.as_tensor(pos, device=device)
    rng = np.random.default_rng(seed)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        qi = torch.as_tensor(rng.integers(0, c.q_ids.shape[0], BATCH),
                             device=device)
        state, m = step(state, {"query_ids": q_ids[qi],
                                "doc_ids": doc_ids[pos[qi]]})
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist() if losses else []
    wall = time.perf_counter() - t0
    if ckpt:
        checkpoint.save(ckpt, steps, train_step.state_tree(state))
    return state["params"].eval(), {"losses": losses, "wall_s": wall}


@dataclasses.dataclass
class Encoded:
    """A corpus through an encoder: fp32 doc and query embeddings on the
    encoder's device, with their masks and the corpus itself."""

    corpus: synthetic.TokenCorpus
    d_emb: torch.Tensor
    d_mask: torch.Tensor
    q_emb: torch.Tensor
    q_mask: torch.Tensor

    @property
    def rel(self):
        return torch.as_tensor(self.corpus.rel, device=self.d_emb.device)


@torch.no_grad()
def encode_all(model, c) -> Encoded:
    dev = next(model.parameters()).device
    d_emb, d_mask = model.encode_docs(torch.as_tensor(c.doc_ids, device=dev))
    q_emb, q_mask = model.encode_queries(torch.as_tensor(c.q_ids,
                                                         device=dev))
    return Encoded(c, d_emb.float(), d_mask, q_emb.float(), q_mask)


def samples(n_samples: int, dim: int, seed: int, device):
    """The Monte-Carlo sample set of a driver: ``n_samples`` unit-sphere
    points from a generator seeded with ``seed`` on ``device``."""
    return sample_sphere(torch.Generator(device=device).manual_seed(seed),
                         n_samples, dim)


def random_keep(d_mask, keep_fraction: float, seed: int):
    """The random baseline's keep mask, from a generator seeded with
    ``seed`` on the masks' device."""
    g = torch.Generator(device=d_mask.device).manual_seed(seed)
    return baselines.random_prune(g, d_mask, keep_fraction)


def vp_keep(d_emb, d_mask, keep_fraction, *, n_samples=2048, seed=1,
            step_size=1):
    """Voronoi pruning at a corpus budget: Alg. 1 orders on the default
    backend, merged by :func:`voronoi.global_keep_masks`."""
    s = samples(n_samples, d_emb.shape[-1], seed, d_emb.device)
    ranks, errs, _ = voronoi.pruning_order_batch(d_emb, d_mask, s,
                                                 step_size=step_size)
    return voronoi.global_keep_masks(ranks, errs, d_mask, keep_fraction)


def quantile(x, q: float) -> float:
    """``jnp.quantile``'s linear rule in the reference's arithmetic: the
    sorted values at floor and ceil of q (n - 1) in fp32, weighted by the
    fraction, the high term fused into the sum as XLA's CPU code fuses
    it.  (``torch.quantile`` interpolates with ``lerp`` and can land an
    ulp away, which moves a threshold that sits on a run of equal norms.)
    """
    a = torch.sort(x.reshape(-1).float()).values
    pos = (torch.tensor(q, dtype=torch.float32)
           * torch.tensor(a.numel() - 1, dtype=torch.float32))
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    low = (a[int(lo)] * (1 - hw)).double()
    return float((low + a[int(hi)].double() * hw.double()).float())


def score(index, q_emb, q_mask):
    """MaxSim of every query against the (pruned) index, on the default
    serving backend."""
    return maxsim_scores(index, q_emb, q_mask)


def quality(index, q_emb, q_mask, rel):
    """(MRR@10, nDCG@10, remain %) of a pruned index."""
    s = score(index, q_emb, q_mask)
    return (float(metrics.mrr_at_k(s, rel, 10)),
            float(metrics.ndcg_at_k(s, rel.float(), 10)),
            index.storage()["remain_pct"])


def timeit(fn, *args, repeat=3, warmup=1, device="cpu"):
    """(min seconds, last output) of ``fn(*args)`` after ``warmup``
    calls.  On a CUDA ``device``, CUDA events around each call, each
    call ended by a synchronize (the reference's ``block_until_ready``);
    on the CPU, the host clock."""
    cuda = torch.device(device).type == "cuda"
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    ts = []
    for _ in range(repeat):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            ts.append(time.perf_counter() - t0)
    return min(ts), out


def csv_line(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)
