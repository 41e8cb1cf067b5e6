"""Serving driver: encode corpus -> Voronoi-prune -> pack -> serve.

Counterpart of ``repro.launch.serve.serve_retrieval`` on one device,
without an index directory or mutation: encode, prune, optionally pool
near-duplicate tokens (``pool_threshold``), pack with ``compress``
(``"none"`` keeps the encoder's dtype, bf16 at the full config, as the
reference stores it; ``"int8"``; ``"residual"`` at ``residual_bits``),
then serve.  The encoder is randomly initialised from ``seed``, as in
the reference.  The configuration is a parameter, so the same function
runs the smoke config in the CPU tests and the full ``colbert`` config
on the card.  Candidate routing is a library call here
(``RetrievalServer(route=..., routing=RoutingIndex.build(packed))``):
the reference ties ``--route`` to ``--index-dir``, which is not ported.
The reference's command-line flags are not ported yet.

The dense LM serving path: :func:`serve_lm` decodes greedily through
the KV cache (counterpart of the reference's ``serve_lm``) and
:func:`prefill_lm` is the reference's prefill step (``launch/steps.py``,
the last position's logits of ``hidden_states``), whose attention runs
the flash-attention kernel on the ``fused`` backend.

The recsys CTR path: :func:`serve_ctr` is the reference's ``serve``
cell of ``launch/steps.py`` (``ctr_serve_step``: sigmoid of the
forward on a CTR batch) for dlrm-rm2, dcn-v2 and wide-deep, and
:func:`retrieve_cand` its ``retrieval_cand`` cell (the two-tower user
vector scored against table 0's rows, top-k).  Their lookups run the
EmbeddingBag kernel on the ``fused`` backend.
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
from repro_torch.models import recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.colbert import ColBERTConfig, init_params
from repro_torch.serve.index import COMPRESSIONS, PackedIndex
from repro_torch.serve.retrieval import RetrievalServer, TokenIndex

ENCODE_BATCH = 512   # docs per encoder forward (bounds attention memory)
N_SAMPLES = 2048     # Monte-Carlo sphere samples, as the reference


@dataclasses.dataclass
class ServeResult:
    """What one ``serve_retrieval`` run produced: the served top-k; the
    encoded corpus (in the encoder's dtype, pooled when pooling ran),
    the keep mask, sphere samples, packed index, server and encoded
    queries (for further serving and checks); and the wall seconds of
    each stage (synchronized on the card)."""

    idx: object                 # (n_q, k) int32 numpy
    scores: object              # (n_q, k) float32 numpy
    d_emb: torch.Tensor
    d_mask: torch.Tensor
    keep: torch.Tensor
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


def _model_device(model, device):
    """``device``, resolved, where ``model`` lives there; raises where
    it lives elsewhere."""
    device = backend_lib.resolve_device(device)
    w = next(model.parameters()).device
    if w.type != device.type or device.index not in (None, w.index):
        raise ValueError(f"the model lives on {w}, not on {device}: move "
                         f"it there or pass device={str(w)!r}")
    return w


def _report_bytes(packed) -> None:
    """One grep-able storage line per run, as the reference prints."""
    st = packed.storage()
    ratio = st["bytes_stored"] / max(st["bytes_dense_fp32"], 1)
    print(f"[serve] storage: codec={packed.codec_tag() or 'fp32'} "
          f"bytes_stored={st['bytes_stored']} "
          f"ratio={ratio:.4f} of dense fp32")


@torch.no_grad()
def serve_retrieval(cfg: ColBERTConfig = colbert_base.SMOKE,
                    keep_fraction: float = 0.5, n_queries: int = 32,
                    seed: int = 0, backend: str | None = None,
                    n_first: int = 64, *, n_docs: int = 256,
                    compress: str = "none", residual_bits: int = 4,
                    pool_threshold: float = 0.0, device=None, model=None,
                    samples=None) -> ServeResult:
    """The reference's serving run on ``device`` (``cuda`` unless the
    caller passes another; raises without a GPU).  ``model`` and
    ``samples`` replace the seeded encoder and sphere samples when
    given (the parity tests carry the reference's across)."""
    if compress not in COMPRESSIONS:
        raise ValueError(f"compress={compress!r}; one of {COMPRESSIONS}")
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
        embs.append(e)
        masks.append(mk)
    d_emb, d_mask = torch.cat(embs), torch.cat(masks)
    if samples is None:
        gen = torch.Generator(device=device).manual_seed(1)
        samples = sample_sphere(gen, N_SAMPLES, cfg.out_dim)
    samples = samples.to(device=device, dtype=torch.float32)
    _sync(device)
    timings["encode_s"] = time.perf_counter() - t

    t = time.perf_counter()
    # the pruning kernels take fp32; widening bf16 is exact
    keep, _, _ = pruning_pipeline.prune_corpus(d_emb.float(), d_mask,
                                               samples, keep_fraction,
                                               backend=backend)
    _sync(device)
    timings["prune_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if pool_threshold:
        # Token pooling: merge near-duplicate kept tokens per doc before
        # packing; the pooled corpus is fp32, as in the reference.
        before = int((keep & d_mask).sum())
        pooled, kp = pruning_pipeline.pool_tokens(d_emb, keep & d_mask,
                                                  pool_threshold)
        d_emb = torch.as_tensor(pooled, device=device)
        keep = torch.as_tensor(kp, device=device)
        print(f"[serve] pooled tokens at cos>={pool_threshold}: "
              f"{before} -> {int(keep.sum())} kept")
    pruned = TokenIndex.build(d_emb, d_mask).with_keep(keep)
    print(f"[serve] masked (reported): {pruned.storage()}")
    packed = pruned.pack(compression=compress, residual_bits=residual_bits)
    _sync(device)
    timings["pack_s"] = time.perf_counter() - t
    print(f"[serve] packed (measured): {packed.storage()}")
    _report_bytes(packed)

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
                       keep=keep, samples=samples, packed=packed, server=server,
                       q_emb=q_emb, timings=timings)


@torch.no_grad()
def serve_lm(cfg: tfm.LMConfig, n_tokens: int = 32, batch: int = 2, *,
             device=None, seed: int = 0, model: tfm.Transformer | None = None):
    """Greedy decode of ``n_tokens`` tokens for ``batch`` sequences from
    token 0 with an empty cache, on ``device`` (``cuda`` unless the
    caller names another; raises without a GPU).  The LM is randomly
    initialised from ``seed`` on the device unless ``model`` is given.
    Unlike the reference (which always decodes its smoke config) the
    config is a parameter.  Returns (ids (batch, n_tokens) int32, the
    synchronized stage seconds)."""
    device = backend_lib.resolve_device(device)
    timings = {}
    t = time.perf_counter()
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = tfm.init_params(gen, cfg, device)
    cache = model.init_cache(batch, n_tokens)
    _sync(device)
    timings["init_s"] = time.perf_counter() - t
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    outs = []
    t = time.perf_counter()
    for s in range(n_tokens):
        logits, cache = model.decode_step(cache, tok, s)
        tok = logits.argmax(-1).to(torch.int32)
        outs.append(tok[:, 0])
    _sync(device)
    dt = time.perf_counter() - t
    timings["decode_s"] = dt
    timings["ms_per_token"] = dt / n_tokens * 1e3
    print(f"[serve] decoded {n_tokens} tokens x {batch} seqs "
          f"in {dt:.2f}s ({dt / n_tokens * 1e3:.1f} ms/token)")
    return torch.stack(outs, dim=1), timings


@torch.no_grad()
def prefill_lm(model: tfm.Transformer, tokens, *, backend: str | None = None,
               device=None):
    """The last position's logits (B, vocab) of a prompt batch tokens
    (B, S) — ``hidden_states`` then the LM head, the reference's prefill
    step — on ``device`` (``cuda`` unless the caller names another;
    raises without a GPU, and when ``model`` lives elsewhere).
    ``backend`` selects the attention path (``fused``: the
    flash-attention kernel; ``reference``: the reference's arithmetic).
    Returns (logits, the synchronized stage seconds)."""
    device = _model_device(model, device)
    tokens = torch.as_tensor(tokens, device=device)
    t = time.perf_counter()
    x = model.hidden_states(tokens, backend=backend)
    logits = model.logits(x[:, -1, :])
    _sync(device)
    return logits, {"prefill_s": time.perf_counter() - t}


def _recsys_model(cfg, model, device, seed, timings):
    """``model`` checked against ``device``, or a model of ``cfg`` drawn
    from ``seed`` on it; the init's synchronized seconds in
    ``timings``."""
    if model is not None:
        return model, _model_device(model, device)
    device = backend_lib.resolve_device(device)
    t = time.perf_counter()
    model = recsys.init_model(torch.Generator(device=device).manual_seed(seed),
                              cfg, device)
    _sync(device)
    timings["init_s"] = time.perf_counter() - t
    return model, device


@torch.no_grad()
def serve_ctr(cfg, batch: int = 512, *, backend: str | None = None,
              device=None, seed: int = 0, model=None):
    """Click probabilities sigmoid(forward) (batch,) f32 for one
    ``ctr_batch(seed, 0, batch, ...)`` of a dlrm-rm2, dcn-v2 or
    wide-deep config, on ``device`` (``cuda`` unless the caller names
    another; raises without a GPU, and when ``model`` lives elsewhere).
    The model is drawn from ``seed`` on the device unless ``model`` is
    given.  ``backend`` selects the lookups' path (``fused``: B8).
    Returns (probabilities, the synchronized stage seconds)."""
    timings = {}
    model, device = _recsys_model(cfg, model, device, seed, timings)
    t = time.perf_counter()
    b = synthetic.ctr_batch(seed, 0, batch, getattr(cfg, "n_dense", 0),
                            cfg.n_sparse, cfg.table_rows, device=device)
    _sync(device)
    timings["batch_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if isinstance(model, recsys.WideDeep):
        logits = model(b["sparse_ids"], backend=backend)
    else:
        logits = model(b["dense"], b["sparse_ids"], backend=backend)
    probs = torch.sigmoid(logits)
    _sync(device)
    timings["forward_s"] = time.perf_counter() - t
    return probs, timings


@torch.no_grad()
def retrieve_cand(cfg, *, k: int = 100, backend: str | None = None,
                  device=None, seed: int = 0, model=None):
    """The reference's ``retrieval_cand`` cell: the one user of
    ``ctr_batch(seed, 0, 1, ...)`` through the user tower (the dense
    features only where the model has a dense tower), scored against
    all of table 0's rows, top ``k`` (ties to the lowest id).  Device,
    model and backend as in :func:`serve_ctr`.  Returns ((values (1, k),
    int32 ids (1, k)), the synchronized stage seconds)."""
    timings = {}
    model, device = _recsys_model(cfg, model, device, seed, timings)
    b = synthetic.ctr_batch(seed, 0, 1, getattr(cfg, "n_dense", 0),
                            cfg.n_sparse, cfg.table_rows, device=device)
    dense = None if isinstance(model, recsys.WideDeep) else b["dense"]
    t = time.perf_counter()
    out = recsys.retrieve_topk(model, dense, b["sparse_ids"], k=k,
                               backend=backend)
    _sync(device)
    timings["retrieve_s"] = time.perf_counter() - t
    return out, timings
