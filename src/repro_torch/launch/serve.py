"""Serving driver: encode corpus -> Voronoi-prune -> pack -> serve.

Counterpart of the default path of ``repro.launch.serve.serve_retrieval``
(exhaustive route, one device, no index directory, no mutation,
``compress="none"``).  The encoder is randomly initialised from
``seed``, as in the reference.  The configuration is a parameter, so the
same function runs the smoke config in the CPU tests and the full
``colbert`` config on the card.  The reference's command-line flags are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs import colbert_base
from repro_torch.core import backend as backend_lib
from repro_torch.core import pruning_pipeline
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.models.colbert import ColBERTConfig, init_params
from repro_torch.serve.index import PackedIndex
from repro_torch.serve.retrieval import RetrievalServer, TokenIndex

ENCODE_BATCH = 512   # docs per encoder forward (bounds attention memory)
N_SAMPLES = 2048     # Monte-Carlo sphere samples, as the reference


@dataclasses.dataclass
class ServeResult:
    """What one ``serve_retrieval`` run produced: the served top-k; the
    encoded corpus, sphere samples, packed index, server and encoded
    queries (for further serving and checks); and the wall seconds of
    each stage (synchronized on the card)."""

    idx: object                 # (n_q, k) int32 numpy
    scores: object              # (n_q, k) float32 numpy
    d_emb: torch.Tensor
    d_mask: torch.Tensor
    samples: torch.Tensor
    packed: PackedIndex
    server: RetrievalServer
    q_emb: torch.Tensor
    timings: dict

    def __iter__(self):         # unpacks like the reference's (idx, scores)
        return iter((self.idx, self.scores))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def serve_retrieval(cfg: ColBERTConfig = colbert_base.SMOKE,
                    keep_fraction: float = 0.5, n_queries: int = 32,
                    seed: int = 0, backend: str | None = None,
                    n_first: int = 64, *, n_docs: int = 256,
                    device=None, model=None, samples=None) -> ServeResult:
    """The reference's default serving run on ``device`` (``cuda``
    unless the caller passes another; raises without a GPU).  ``model``
    and ``samples`` replace the seeded encoder and sphere samples when
    given (the parity tests carry the reference's across)."""
    device = backend_lib.resolve_device(device)
    timings = {}
    t = time.perf_counter()
    if model is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        model = init_params(gen, cfg, device)
    corpus = synthetic.token_corpus(seed, n_docs=n_docs, n_q=n_queries,
                                    vocab=cfg.vocab, m=cfg.doc_len,
                                    l=cfg.query_len)
    doc_ids = torch.as_tensor(corpus.doc_ids, device=device)
    embs, masks = [], []
    for a in range(0, n_docs, ENCODE_BATCH):
        e, mk = model.encode_docs(doc_ids[a:a + ENCODE_BATCH])
        embs.append(e.float())     # the fp32 index the kernels score
        masks.append(mk)
    d_emb, d_mask = torch.cat(embs), torch.cat(masks)
    if samples is None:
        gen = torch.Generator(device=device).manual_seed(1)
        samples = sample_sphere(gen, N_SAMPLES, cfg.out_dim)
    samples = samples.to(device=device, dtype=torch.float32)
    _sync(device)
    timings["encode_s"] = time.perf_counter() - t

    t = time.perf_counter()
    keep, _, _ = pruning_pipeline.prune_corpus(d_emb, d_mask, samples,
                                               keep_fraction,
                                               backend=backend)
    _sync(device)
    timings["prune_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pruned = TokenIndex.build(d_emb, d_mask).with_keep(keep)
    print(f"[serve] masked (reported): {pruned.storage()}")
    packed = pruned.pack()
    _sync(device)
    timings["pack_s"] = time.perf_counter() - t
    print(f"[serve] packed (measured): {packed.storage()}")

    serve_backend = backend if backend in backend_lib.SERVING else None
    if n_first <= 0:
        n_first = packed.n_docs                  # e2e exact-sweep route
    server = RetrievalServer(packed, k=10, n_first=n_first,
                             backend=serve_backend)
    sweep = "e2e" if n_first >= packed.n_docs else "two-stage"
    print(f"[serve] route: {sweep} (n_first={n_first}, "
          f"n_docs={packed.n_docs})")
    print(f"[serve] scoring backend: {server.backend}")
    q_emb, _ = model.encode_queries(
        torch.as_tensor(corpus.q_ids, device=device))
    q_emb = q_emb.float()
    t = time.perf_counter()
    idx, scores = server.query_batch(q_emb)
    timings["serve_s"] = time.perf_counter() - t
    print(f"[serve] {n_queries} queries in {timings['serve_s'] * 1e3:.1f} "
          f"ms ({timings['serve_s'] / n_queries * 1e3:.2f} ms/q)")
    return ServeResult(idx=idx, scores=scores, d_emb=d_emb, d_mask=d_mask,
                       samples=samples, packed=packed, server=server,
                       q_emb=q_emb, timings=timings)
