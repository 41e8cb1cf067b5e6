"""Serving driver: encode corpus -> Voronoi-prune -> pack -> serve.

Counterpart of ``repro.launch.serve.serve_retrieval`` on one device:
encode, prune, optionally pool near-duplicate tokens
(``pool_threshold``), pack with ``compress`` (``"none"`` keeps the
encoder's dtype, bf16 at the full config, as the reference stores it;
``"int8"``; ``"residual"`` at ``residual_bits``), then serve.  The
encoder is randomly initialised from ``seed``, as in the reference.
The configuration is a parameter, so the same function runs the smoke
config in the CPU tests and the full ``colbert`` config on the card.

With ``index_dir`` the packed artifact is persisted there on the first
run (prune -> pack -> save -> load -> serve) and loaded directly on
later runs (``serve.index_io``).  ``upsert``/``delete``/``compact`` then
drive the live-mutation lifecycle against that artifact
(``serve.mutation``): durable WAL-logged delta buckets and tombstones
served beside the base epoch, folded into the next epoch by
compaction.  ``route`` (``"bounded"`` or ``"nprobe"``, with
``n_probe`` and ``centroids`` a bucket) serves through candidate
routing, its table an artifact sidecar, and reports recall@10 against
the exhaustive sweep.  The reference's command-line flags are not
ported yet.

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
from repro_torch.core import metrics, pruning_pipeline
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.models import recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.colbert import ColBERTConfig, init_params
from repro_torch.serve import index_io
from repro_torch.serve import mutation as mutation_lib
from repro_torch.serve.index import COMPRESSIONS, PackedIndex
from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex,
                                         topk_search)
from repro_torch.serve.routing import RoutingIndex

ENCODE_BATCH = 512   # docs per encoder forward (bounds attention memory)
N_SAMPLES = 2048     # Monte-Carlo sphere samples, as the reference


@dataclasses.dataclass
class ServeResult:
    """What one ``serve_retrieval`` run produced: the served top-k (the
    mutation lifecycle's last answer where it ran); the encoded corpus
    (in the encoder's dtype, pooled when pooling ran), the keep mask and
    sphere samples (None where the index was loaded from ``index_dir``),
    packed index, server and encoded queries (for further serving and
    checks); and the wall seconds of each stage (synchronized on the
    card)."""

    idx: object                 # (n_q, k) int32 numpy
    scores: object              # (n_q, k) float32 numpy
    d_emb: torch.Tensor | None
    d_mask: torch.Tensor | None
    keep: torch.Tensor | None
    samples: torch.Tensor | None
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


def _encode_docs(model, doc_ids, device):
    """The encoder's (embeddings, masks) of a token-id corpus, in
    batches of ``ENCODE_BATCH`` docs."""
    doc_ids = torch.as_tensor(doc_ids, device=device)
    embs, masks = [], []
    for a in range(0, doc_ids.shape[0], ENCODE_BATCH):
        e, mk = model.encode_docs(doc_ids[a:a + ENCODE_BATCH])
        embs.append(e)
        masks.append(mk)
    return torch.cat(embs), torch.cat(masks)


@torch.no_grad()
def serve_retrieval(cfg: ColBERTConfig = colbert_base.SMOKE,
                    keep_fraction: float = 0.5, n_queries: int = 32,
                    seed: int = 0, backend: str | None = None,
                    n_first: int = 64, *, n_docs: int = 256,
                    compress: str = "none", residual_bits: int = 4,
                    pool_threshold: float = 0.0, device=None, model=None,
                    samples=None, index_dir: str | None = None,
                    upsert: int = 0, delete: tuple = (),
                    compact: bool = False, route: str = "exhaustive",
                    n_probe: int = 1, centroids: int = 4) -> ServeResult:
    """The reference's serving run on ``device`` (``cuda`` unless the
    caller passes another; raises without a GPU).  ``model`` and
    ``samples`` replace the seeded encoder and sphere samples when
    given (the parity tests carry the reference's across).
    ``index_dir``, ``upsert`` (fresh docs), ``delete`` (doc ids),
    ``compact``, ``route``, ``n_probe`` and ``centroids`` are the
    reference's persistence, mutation and routing legs (module
    docstring); a routed run needs ``index_dir``."""
    if compress not in COMPRESSIONS:
        raise ValueError(f"compress={compress!r}; one of {COMPRESSIONS}")
    if route != "exhaustive" and not index_dir:
        raise ValueError(f"route={route!r} needs index_dir: the routing "
                         "table is an artifact sidecar")
    device = backend_lib.resolve_device(device)
    timings = {}
    t = time.perf_counter()
    if model is None:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        model = init_params(gen, cfg, device)
    corpus = synthetic.token_corpus(seed, n_docs=n_docs, n_q=n_queries,
                                    vocab=cfg.vocab, m=cfg.doc_len,
                                    l=cfg.query_len)
    if index_dir and (upsert or delete or compact):
        # Resolve any interrupted mutation a previous process left
        # behind first: landed intents roll forward, torn ones back.
        report = index_io.recover(index_dir)
        if any(report.values()):
            print(f"[serve] recovered artifact: {report}")
    d_emb = d_mask = keep = None
    if index_dir and index_io.has_index(index_dir):
        # The pruning job already ran: the artifact is authoritative,
        # and this run's pruning and packing arguments do not apply.
        packed = index_io.load_index(index_dir, device=device)
        _sync(device)
        timings["load_s"] = time.perf_counter() - t
        st = packed.storage()
        print(f"[serve] loaded packed index from {index_dir}: {st}")
        _report_bytes(packed)
        if compress != packed.compression:
            print(f"[serve] WARNING: compress={compress!r} ignored; the "
                  f"loaded artifact is {packed.compression!r}")
        if abs(st["remain_pct"] - 100.0 * keep_fraction) > 1.0:
            print(f"[serve] WARNING: keep_fraction={keep_fraction} "
                  f"ignored; the loaded artifact retains "
                  f"{st['remain_pct']:.1f}% of tokens")
    else:
        d_emb, d_mask, keep, samples, packed = _prune_and_pack(
            model, corpus, cfg, device, timings, t, samples=samples,
            keep_fraction=keep_fraction, backend=backend,
            pool_threshold=pool_threshold, compress=compress,
            residual_bits=residual_bits)
        if index_dir:
            index_io.save_index(index_dir, packed)
            # Serve what is on disk: the artifact a later job starts from.
            packed = index_io.load_index(index_dir, device=device)
            print(f"[serve] saved + reloaded packed index at {index_dir}")
    routing = None
    if route != "exhaustive":
        # The routing table is an artifact sidecar: load the live
        # epoch's, else build it once and persist it beside the epoch
        # it was built from, where the Compactor keeps it fresh.
        if index_io.has_routing(index_dir):
            routing = index_io.load_routing(index_dir, device=device)
            print(f"[serve] loaded routing table: {routing.n_buckets} "
                  f"buckets x {routing.n_centroids} centroids "
                  f"(epoch {routing.epoch})")
        else:
            routing = RoutingIndex.build(packed, n_centroids=centroids)
            index_io.save_routing(index_io.live_epoch_dir(index_dir),
                                  routing)
            print(f"[serve] built + saved routing table: "
                  f"{routing.n_buckets} buckets x {routing.n_centroids} "
                  f"centroids (epoch {routing.epoch})")

    serve_backend = backend if backend in backend_lib.SERVING else None
    if n_first <= 0:
        n_first = packed.n_docs                  # e2e exact-sweep route
    server = RetrievalServer(packed, k=10, n_first=n_first,
                             backend=serve_backend, route=route,
                             routing=routing, n_probe=n_probe)
    sweep = ("e2e" if n_first >= packed.n_docs or route != "exhaustive"
             else "two-stage")
    print(f"[serve] route: {sweep} (n_first={n_first}, "
          f"n_docs={packed.n_docs})"
          + (f" + candidate routing ({route})"
             if route != "exhaustive" else ""))
    print(f"[serve] scoring backend: {server.backend}")
    q_emb, _ = model.encode_queries(
        torch.as_tensor(corpus.q_ids, device=device))
    q_emb = q_emb.float()
    t = time.perf_counter()
    idx, scores = server.query_batch(q_emb)
    timings["serve_s"] = time.perf_counter() - t
    print(f"[serve] {n_queries} queries in {timings['serve_s'] * 1e3:.1f} "
          f"ms ({timings['serve_s'] / n_queries * 1e3:.2f} ms/q)")
    if route != "exhaustive":
        stats = {}
        topk_search(packed, q_emb, k=server.k, backend=server.backend,
                    route=route, routing=routing, n_probe=n_probe,
                    route_stats=stats)
        oi, _ = topk_search(packed, q_emb, k=server.k,
                            backend=server.backend)
        rec = metrics.recall_at_k(idx, oi.cpu().numpy())
        print(f"[serve] routed ({route}): {stats['buckets_scored']}/"
              f"{stats['n_buckets']} buckets scored (fraction "
              f"{stats['fraction']:.2f})")
        print(f"[serve] routed recall@{server.k} vs exhaustive: {rec:.3f}")
    if upsert or delete or compact:
        idx, scores = _mutation_lifecycle(
            index_dir, server, q_emb, model, cfg, seed, device, timings,
            upsert=upsert, delete=delete, compact=compact)
    return ServeResult(idx=idx, scores=scores, d_emb=d_emb, d_mask=d_mask,
                       keep=keep, samples=samples, packed=packed,
                       server=server, q_emb=q_emb, timings=timings)


def _prune_and_pack(model, corpus, cfg, device, timings, t, *, samples,
                    keep_fraction, backend, pool_threshold, compress,
                    residual_bits):
    """Encode the corpus, prune, pool and pack it: ``(d_emb, d_mask,
    keep, samples, packed)``, each stage's seconds in ``timings`` (the
    encode's counted from ``t``)."""
    d_emb, d_mask = _encode_docs(model, corpus.doc_ids, device)
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
    return d_emb, d_mask, keep, samples, packed


def _mutation_lifecycle(index_dir, server, q_emb, model, cfg, seed, device,
                        timings, *, upsert, delete, compact):
    """The live-mutation leg: durable upsert/delete against the
    artifact, serve the delta-log view beside the base epoch, then
    (optionally) compact to the next epoch and check that the swap
    serves what the view served (bit for bit for an fp32 ``"none"``
    base; int8 and residual re-quantize, and a bf16 base compacts to
    fp32).  Returns the last answer (ids, scores)."""
    routed = server.route != "exhaustive"
    t = time.perf_counter()
    if upsert:
        base_n = int(index_io._read_manifest(index_dir,
                                             index_io.MANIFEST)["n_docs"])
        new_ids = list(range(base_n, base_n + upsert))
        docs = synthetic.token_corpus(seed + 1, n_docs=upsert, n_q=1,
                                      vocab=cfg.vocab, m=cfg.doc_len,
                                      l=cfg.query_len)
        n_emb, n_mask = _encode_docs(model, docs.doc_ids, device)
        delta_id = mutation_lib.append_upsert(index_dir, n_emb, n_mask,
                                              new_ids)
        print(f"[serve] upserted {upsert} docs "
              f"(delta {delta_id}, ids {new_ids[0]}..{new_ids[-1]})")
    if delete:
        mutation_lib.append_delete(index_dir, delete)
        print(f"[serve] tombstoned doc ids {sorted(delete)}")
    log = mutation_lib.load_state(index_dir, device=device)
    view = log.view()
    # the base epoch is unchanged, so a routed server keeps its table
    server.swap_index(log.base, mutation=view,
                      routing=server.routing if routed else None)
    idx, scores = server.query_batch(q_emb)
    timings["mutate_s"] = time.perf_counter() - t
    print(f"[serve] serving live mutation view: {len(log.deltas)} "
          f"delta(s), {len(log.tombstones)} tombstone(s), "
          f"n_live={log.n_live}")
    if compact:
        ri, rv = topk_search(log.base, q_emb, k=server.k,
                             backend=server.backend, mutation=view)
        t = time.perf_counter()
        new_index = mutation_lib.Compactor(index_dir, device=device).run()
        _sync(device)
        timings["compact_s"] = dt = time.perf_counter() - t
        if new_index is None:
            print("[serve] nothing to compact")
            return idx, scores
        reloaded = index_io.load_index(index_dir, device=device)
        server.swap_index(reloaded, routing=(
            index_io.load_routing(index_dir, device=device)
            if routed else None))
        idx, scores = server.query_batch(q_emb)
        # parity on the route the view served: the e2e exact sweep
        pi, pv = topk_search(reloaded, q_emb, k=server.k,
                             backend=server.backend)
        parity = bool(torch.equal(ri, pi) and torch.equal(rv, pv))
        orphans = index_io.list_orphans(index_dir)
        print(f"[serve] compacted to epoch {reloaded.epoch} in "
              f"{dt * 1e3:.1f} ms; post-compact parity: {parity}; "
              f"orphans: {len(orphans)}")
    return idx, scores


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
