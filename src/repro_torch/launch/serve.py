"""Serving driver: encode corpus -> Voronoi-prune -> pack -> serve.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch colbert \\
        [--device cpu] [--index-dir D [--upsert N] [--delete 1,2]
        [--compact] [--route bounded|nprobe]] [--ckpt-dir C]
        [--serve-loop [--flush-ms 2] [--max-batch 8]]
        [--mesh host|grid [--hosts H] [--replicas R]
         [--on-group-loss degrade|rebalance|fail] [--kill-group G]]

Counterpart of ``repro.launch.serve``; its flags, defaults, choices and
parse-time checks are the reference's, plus ``--device`` (``cuda``
unless ``cpu`` is asked for; raises without a GPU).  ``--arch colbert``
runs :func:`serve_retrieval` at the smoke config, as the reference does;
another ported LM arch decodes its smoke config through
:func:`serve_lm`.

:func:`serve_retrieval`:
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
the exhaustive sweep.  ``ckpt_dir`` restores the encoder's parameters
from the newest valid train checkpoint there (``launch.train``'s) and
raises where there is none.  ``serve_loop`` ends the run with the
concurrent micro-batched leg (``serve.loop.ServeLoop``): client threads
stream single queries while one epoch swap lands mid-run, and every
answer must equal the serial batch's bit for bit.

Meshes (``mesh``, from ``launch.mesh.local_devices()``, every card of
the host, as the reference's come from ``jax.devices()``): with more
than one device both prune over a ``data`` mesh of them; ``"host"``
serves every bucket sharded over all of them; ``"grid"`` serves the
``hosts x candidates`` grid (``hosts`` groups, the largest power of two
whose square fits by default) with buckets placed by a
``PlacementPlan`` of ``replicas`` (the artifact's plan where
``index_dir`` holds one), a ``FleetMonitor`` and the ``on_group_loss``
policy; ``kill_group`` demotes that group before the query batch.  With
fewer devices than two groups ``"grid"`` says so and serves unsharded,
as the reference does; ``hosts`` that does not divide the device count
raises.

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

BERT4Rec: :func:`serve_bert4rec` is the body of the reference's
``serve_p99`` and ``retrieval_cand`` cells (``launch/steps.py``): pooled
user vectors of a batch of item sequences, scored against the whole
1,000,002-row embedding catalog, top-k with ties to the lowest id;
:func:`serve_bert4rec_bulk` is its ``serve_bulk`` cell (each user vector
dotted with one given target item).  The encoder has no key mask there,
so its attention runs the flash-attention kernel (B7) on ``fused``.

The CLI serves colbert and the LM family.  The reference's CLI has no
recsys or GNN path (for a non-LM arch it decodes an LM smoke config),
so the port's raises for a recsys arch and names the functions above,
and for gin-tu says that there is no GNN serving path (the family
trains through ``launch.train``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs import colbert_base
from repro_torch.core import backend as backend_lib
from repro_torch.core import metrics, pruning_pipeline
from repro_torch.core.sampling import sample_sphere
from repro_torch.data import synthetic
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.models import convert, recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.colbert import ColBERTConfig, init_params
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve import health, index_io
from repro_torch.serve import mutation as mutation_lib
from repro_torch.serve.index import COMPRESSIONS, PackedIndex
from repro_torch.serve.loop import ServeLoop
from repro_torch.serve.retrieval import (RetrievalServer, TokenIndex,
                                         topk_search)
from repro_torch.serve.routing import RoutingIndex
from repro_torch.sharding import (PlacementPlan, axis_rules, note_lookup,
                                  note_topk, serve_rules)
from repro_torch.train import checkpoint, train_step

ENCODE_BATCH = 512   # docs per encoder forward (bounds attention memory)
N_SAMPLES = 2048     # Monte-Carlo sphere samples, as the reference


@dataclasses.dataclass
class ServeResult:
    """What one ``serve_retrieval`` run produced: the served top-k (the
    mutation lifecycle's last answer where it ran); the encoded corpus
    (in the encoder's dtype, pooled when pooling ran), the keep mask and
    sphere samples (None where the index was loaded from ``index_dir``),
    packed index, server and encoded queries (for further serving and
    checks); the wall seconds of each stage (synchronized on the
    card); the serving loop's statistics where that leg ran; and the
    served batch's coverage (below 1 where a grid lost buckets)."""

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
    loop: dict | None = None
    coverage: float = 1.0

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
                    n_probe: int = 1, centroids: int = 4,
                    ckpt_dir: str | None = None, serve_loop: bool = False,
                    flush_ms: float = 2.0, max_batch: int = 8,
                    mesh: str = "none", hosts: int = 0, replicas: int = 1,
                    on_group_loss: str = "degrade",
                    kill_group: int | None = None) -> ServeResult:
    """The reference's serving run on ``device`` (``cuda`` unless the
    caller passes another; raises without a GPU).  ``model`` and
    ``samples`` replace the seeded encoder and sphere samples when
    given (the parity tests carry the reference's across); ``ckpt_dir``
    restores the encoder from a train checkpoint instead (raises
    ``FileNotFoundError`` where none is valid).  ``index_dir``,
    ``upsert`` (fresh docs), ``delete`` (doc ids), ``compact``,
    ``route``, ``n_probe`` and ``centroids`` are the reference's
    persistence, mutation and routing legs (module docstring); a routed
    run needs ``index_dir``.  ``serve_loop`` runs the serving loop's leg
    last, at ``flush_ms`` and ``max_batch``.  ``mesh``, ``hosts``,
    ``replicas``, ``on_group_loss`` and ``kill_group`` are the
    reference's multi-device legs (module docstring)."""
    if replicas < 1:
        raise ValueError(f"--replicas {replicas} < 1")
    if compress not in COMPRESSIONS:
        raise ValueError(f"compress={compress!r}; one of {COMPRESSIONS}")
    if route != "exhaustive" and not index_dir:
        raise ValueError(f"route={route!r} needs index_dir: the routing "
                         "table is an artifact sidecar")
    if model is not None and ckpt_dir:
        raise ValueError("pass model= or ckpt_dir=, not both")
    device = backend_lib.resolve_device(device)
    devices = mesh_lib.local_devices(device)
    if mesh == "grid" and hosts <= 0:
        hosts = mesh_lib.default_serve_hosts(devices)
    timings = {}
    t = time.perf_counter()
    if ckpt_dir:
        model = restore_encoder(ckpt_dir, cfg, device)
    elif model is None:
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
        if ckpt_dir:
            print("[serve] WARNING: --ckpt-dir ignored; the loaded "
                  "artifact was encoded by the job that built it")
    else:
        # Under a multi-device mesh the pruning job shards over `data`:
        # each bucket's docs split over the devices and the §4.2 global
        # cut runs its bitwise selection; equal to one device bit for bit.
        prune_rules = {}
        if mesh in ("host", "grid") and len(devices) > 1:
            data_mesh = mesh_lib.make_host_mesh(devices)
            print(f"[serve] sharded pruning over "
                  f"data={data_mesh.shape['data']}")
            prune_rules = {"__mesh__": data_mesh}
        d_emb, d_mask, keep, samples, packed = _prune_and_pack(
            model, corpus, cfg, device, timings, t, samples=samples,
            keep_fraction=keep_fraction, backend=backend,
            pool_threshold=pool_threshold, compress=compress,
            residual_bits=residual_bits, prune_rules=prune_rules)
        if index_dir:
            placement = None
            if mesh == "grid" and hosts > 1:
                r = min(replicas, hosts)
                if r != replicas:
                    print(f"[serve] WARNING: --replicas {replicas} clamped "
                          f"to {r} (chains must land on distinct groups, "
                          f"only {hosts} host groups)")
                placement = PlacementPlan.for_index(packed, hosts,
                                                    replicas=r)
            index_io.save_index(index_dir, packed, placement=placement)
            # Serve what is on disk: the artifact a later job starts from.
            packed = index_io.load_index(index_dir, device=device)
            print(f"[serve] saved + reloaded packed index at {index_dir}"
                  + (f" ({placement.n_groups} host-group bodies)"
                     if placement else ""))
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
            if routing.n_centroids != centroids:
                print(f"[serve] WARNING: centroids={centroids} ignored; "
                      f"the loaded table has {routing.n_centroids}")
        else:
            routing = RoutingIndex.build(packed, n_centroids=centroids)
            index_io.save_routing(index_io.live_epoch_dir(index_dir),
                                  routing)
            print(f"[serve] built + saved routing table: "
                  f"{routing.n_buckets} buckets x {routing.n_centroids} "
                  f"centroids (epoch {routing.epoch})")

    serve_backend = backend if backend in backend_lib.SERVING else None
    rules, monitor = _serving_mesh(mesh, hosts, replicas, devices, packed,
                                   index_dir)
    if n_first <= 0:
        n_first = packed.n_docs                  # e2e exact-sweep route
    with axis_rules(rules):
        return _serve(
            packed, model, cfg, corpus, device, timings, seed=seed,
            n_first=n_first, serve_backend=serve_backend, route=route,
            routing=routing, n_probe=n_probe, monitor=monitor,
            on_group_loss=on_group_loss, kill_group=kill_group,
            index_dir=index_dir, upsert=upsert, delete=delete,
            compact=compact, serve_loop=serve_loop, flush_ms=flush_ms,
            max_batch=max_batch, d_emb=d_emb, d_mask=d_mask, keep=keep,
            samples=samples)


def _serving_mesh(mesh, hosts, replicas, devices, packed, index_dir):
    """The serving rules and fleet monitor of ``mesh``: ``"host"`` shards
    over every device; ``"grid"`` with ``hosts > 1`` places buckets on
    the ``hosts x candidates`` grid (an artifact's plan is authoritative
    where the devices can form its grid; otherwise it is re-placed for
    this host, with a warning) under a ``FleetMonitor``; ``"grid"``
    with fewer groups serves unsharded, saying so."""
    if mesh == "host":
        serve_mesh = mesh_lib.make_serve_mesh(devices=devices)
        n_shards = serve_mesh.shape["model"]
        print(f"[serve] sharded serving mesh: {serve_mesh} "
              f"({n_shards} candidate shard{'s' if n_shards != 1 else ''})")
        return serve_rules(serve_mesh), None
    if mesh == "grid" and hosts > 1:
        placement = index_dir and index_io.load_placement(index_dir)
        if placement and placement.n_groups != hosts:
            if len(devices) % placement.n_groups == 0:
                print(f"[serve] --hosts {hosts} overridden by the "
                      f"artifact's placement ({placement.n_groups} host "
                      "groups)")
                hosts = placement.n_groups
            else:
                print(f"[serve] WARNING: artifact placement has "
                      f"{placement.n_groups} host groups but "
                      f"{len(devices)} devices cannot form that grid; "
                      f"rebalancing for {hosts} groups")
                placement = None
        if placement and replicas > 1 and placement.replicas != replicas:
            print(f"[serve] WARNING: --replicas {replicas} ignored; the "
                  f"artifact's plan stores replicas={placement.replicas} "
                  f"(delete {index_dir} to re-place)")
        placement = placement or PlacementPlan.for_index(
            packed, hosts, replicas=min(replicas, hosts))
        serve_mesh = mesh_lib.make_serve_mesh(hosts, devices)
        print(f"[serve] grid serving mesh: {serve_mesh.shape} "
              f"({serve_mesh.distinct()} distinct devices; placement "
              f"groups={list(placement.groups)}, "
              f"replicas={placement.replicas})")
        return (serve_rules(serve_mesh, placement=placement),
                health.FleetMonitor(hosts))
    if mesh == "grid":
        print("[serve] --mesh grid needs >= 2 host groups of >= 1 device; "
              "serving unsharded (set --hosts or add devices)")
    return {}, None


def _serve(packed, model, cfg, corpus, device, timings, *, seed, n_first,
           serve_backend, route, routing, n_probe, monitor, on_group_loss,
           kill_group, index_dir, upsert, delete, compact, serve_loop,
           flush_ms, max_batch, d_emb, d_mask, keep, samples):
    """The serving half of :func:`serve_retrieval`, under the mesh's
    rules: the server, the query batch, the routed report, the mutation
    lifecycle and the serving loop's leg."""
    server = RetrievalServer(packed, k=10, n_first=n_first,
                             backend=serve_backend, route=route,
                             routing=routing, n_probe=n_probe,
                             monitor=monitor, on_group_loss=on_group_loss)
    sweep = ("e2e" if n_first >= packed.n_docs or route != "exhaustive"
             else "two-stage")
    print(f"[serve] route: {sweep} (n_first={n_first}, "
          f"n_docs={packed.n_docs})"
          + (f" + candidate routing ({route})"
             if route != "exhaustive" else ""))
    print(f"[serve] scoring backend: {server.backend}")
    if kill_group is not None:
        if monitor is None:
            print("[serve] WARNING: --kill-group needs an active --mesh "
                  "grid; ignored")
        else:
            monitor.demote(kill_group)
            print(f"[serve] injected loss of host group {kill_group} "
                  f"(--on-group-loss {server.on_group_loss})")
    q_emb, _ = model.encode_queries(
        torch.as_tensor(corpus.q_ids, device=device))
    q_emb = q_emb.float()
    n_queries = q_emb.shape[0]
    t = time.perf_counter()
    out = server.query_batch(q_emb)
    idx, scores = out
    timings["serve_s"] = time.perf_counter() - t
    print(f"[serve] {n_queries} queries in {timings['serve_s'] * 1e3:.1f} "
          f"ms ({timings['serve_s'] / n_queries * 1e3:.2f} ms/q)")
    if monitor is not None:
        print(f"[serve] coverage: {out.coverage:.3f} "
              f"(live groups: {sorted(monitor.live())})")
    if route != "exhaustive":
        stats = {}
        topk_search(packed, q_emb, k=server.k, backend=server.backend,
                    route=route, routing=routing, n_probe=n_probe,
                    route_stats=stats)
        oi, _ = topk_search(packed, q_emb, k=server.k,
                            backend=server.backend)
        rec = metrics.recall_at_k(idx, oi.cpu().numpy())
        line = (f"[serve] routed ({route}): {stats['buckets_scored']}/"
                f"{stats['n_buckets']} buckets scored (fraction "
                f"{stats['fraction']:.2f})")
        if "groups_consulted" in stats:
            line += (f"; {stats['groups_consulted']}/{stats['n_groups']} "
                     "host groups consulted")
        print(line)
        print(f"[serve] routed recall@{server.k} vs exhaustive: {rec:.3f}")
    if upsert or delete or compact:
        idx, scores = _mutation_lifecycle(
            index_dir, server, q_emb, model, cfg, seed, device, timings,
            upsert=upsert, delete=delete, compact=compact)
    loop = None
    if serve_loop:
        # last, so the loop fronts the server's final state (the mutated
        # view or the compacted epoch included)
        loop = _serve_loop_leg(server, q_emb, flush_ms=flush_ms,
                               max_batch=max_batch)
        timings["loop_s"] = loop["wall_s"]
    return ServeResult(idx=idx, scores=scores, d_emb=d_emb, d_mask=d_mask,
                       keep=keep, samples=samples, packed=packed,
                       server=server, q_emb=q_emb, timings=timings,
                       loop=loop, coverage=out.coverage)


def restore_encoder(ckpt_dir: str, cfg: ColBERTConfig, device):
    """The ColBERT encoder of ``cfg`` on ``device`` with the ``params``
    subtree of the newest valid train checkpoint under ``ckpt_dir`` (as
    ``launch.train`` writes it: ``train_step.state_tree``).  Raises
    ``FileNotFoundError`` naming the directory where none restores —
    never serves the random initialisation in its place."""
    model = init_params(torch.Generator(device="cpu").manual_seed(0), cfg,
                        device)
    like = train_step.state_tree(train_step.make_train_state(model))
    step, tree = checkpoint.restore_latest(ckpt_dir, like)
    if tree is None:
        raise FileNotFoundError(
            f"no valid train checkpoint of {cfg.name!r} under {ckpt_dir!r}")
    model.load_state_dict(convert.params_from_jax(tree["params"]))
    print(f"[serve] restored encoder parameters from step {step} of "
          f"{ckpt_dir}")
    return model


def _serve_loop_leg(server, q_emb, *, flush_ms, max_batch):
    """The serving loop's leg: client threads stream single queries (host
    rows) through a :class:`~repro_torch.serve.loop.ServeLoop` while its
    dispatcher micro-batches them into pow2 shapes, and one epoch swap
    lands mid-run.  The swap re-serves the same corpus state under a new
    generation, so it shows only in ``epoch_key``; every streamed answer
    must be bit-equal to the serial batch's row.  Prints the reference's
    ``[serve] loop`` lines (the parity line is what scripts grep) and
    returns the loop's statistics, the parity and the wall seconds;
    raises where an answer differs."""
    q = q_emb.cpu().numpy()
    n = q.shape[0]
    oracle = server.query_batch(q_emb)
    key0 = server.epoch_key
    results = [None] * n
    errors = []

    def client(lo, hi):
        try:
            for i in range(lo, hi):
                results[i] = sl.query(q[i])
        except Exception as e:           # re-raised after the join
            errors.append(e)

    t0 = time.perf_counter()
    with ServeLoop(server, flush_ms=flush_ms, max_batch=max_batch) as sl:
        n_clients = max(1, min(4, n))
        bounds = [round(c * n / n_clients) for c in range(n_clients + 1)]
        threads = [threading.Thread(target=client, name=f"loop-client-{c}",
                                    args=(bounds[c], bounds[c + 1]))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        # Mid-run epoch swap: the server's write gate drains in-flight
        # flushes first, so the swap lands strictly between batches.
        sl.swap_index(server.index, mutation=server._mutation,
                      routing=server.routing)
        for t in threads:
            t.join(timeout=600)
    dt = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a serve-loop client did not finish in 600 s")
    snap = sl.stats.snapshot()
    pre = sum(1 for r in results if r.epoch_key == key0)
    keys = sorted({r.epoch_key for r in results})
    parity = all(
        np.array_equal(r.top_idx, oracle.top_idx[i])
        and np.array_equal(r.top_scores, oracle.top_scores[i])
        for i, r in enumerate(results))
    print(f"[serve] loop: {n} queries / {n_clients} clients in "
          f"{dt * 1e3:.1f} ms (flush_ms={flush_ms}, max_batch={max_batch})")
    print(f"[serve] loop stats: flushes={snap['flushes']} "
          f"batches={snap['batches']} cache_hits={snap['cache_hits']} "
          f"padded_rows={snap['padded_rows']} "
          f"p50={snap['p50_latency_s'] * 1e3:.2f} ms "
          f"p99={snap['p99_latency_s'] * 1e3:.2f} ms")
    print(f"[serve] loop epoch swap mid-run: {pre} answers pre-swap, "
          f"{n - pre} post-swap (epoch keys {keys})")
    print(f"[serve] loop parity vs serial: {parity}")
    if not parity:
        raise RuntimeError("serve-loop answers diverged from the serial "
                           "oracle (bitwise parity contract)")
    return {**snap, "parity": parity, "wall_s": dt, "pre_swap": pre,
            "epoch_keys": keys}


def _prune_and_pack(model, corpus, cfg, device, timings, t, *, samples,
                    keep_fraction, backend, pool_threshold, compress,
                    residual_bits, prune_rules):
    """Encode the corpus, prune (under ``prune_rules``: a ``data`` mesh
    shards it), pool and pack it: ``(d_emb, d_mask, keep, samples,
    packed)``, each stage's seconds in ``timings`` (the encode's counted
    from ``t``)."""
    d_emb, d_mask = _encode_docs(model, corpus.doc_ids, device)
    if samples is None:
        gen = torch.Generator(device=device).manual_seed(1)
        samples = sample_sphere(gen, N_SAMPLES, cfg.out_dim)
    samples = samples.to(device=device, dtype=torch.float32)
    _sync(device)
    timings["encode_s"] = time.perf_counter() - t

    t = time.perf_counter()
    # the pruning kernels take fp32; widening bf16 is exact
    with axis_rules(prune_rules):
        keep, _, _ = pruning_pipeline.prune_corpus(
            d_emb.float(), d_mask, samples, keep_fraction, backend=backend)
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
    probs = train_step.ctr_serve_step(recsys.ctr_forward,
                                      backend=backend)(model, b)
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


def _bert4rec_items(cfg, batch, seed, device):
    """``batch`` item sequences of ``cfg.seq_len`` uniform in [4,
    n_items) (``bert4rec_batch`` with nothing masked), on ``device``."""
    return synthetic.bert4rec_batch(seed, 0, batch, cfg.seq_len, cfg.n_items,
                                    mask_rate=0.0, device=device)["items"]


@torch.no_grad()
def bert4rec_topk(model, cfg, items, *, k: int = 100,
                  backend: str | None = None):
    """The pooled user vectors of ``items`` (B, S) scored against every
    row of the embedding catalog, top ``k`` (values, int32 ids;
    descending, ties to the lowest id)."""
    _, user = recsys.bert4rec_user_vectors(model, cfg, items,
                                           backend=backend)
    return topk_lowest_index(note_topk(recsys.score_candidates(
        user, model.embed.weight.to(user.dtype)), "batch", "candidates"), k)


@torch.no_grad()
def bert4rec_pair_scores(model, cfg, items, targets, *,
                         backend: str | None = None):
    """Each pooled user vector of ``items`` (B, S) dotted with the
    embedding of its target item (B,) -> (B,) scores."""
    _, user = recsys.bert4rec_user_vectors(model, cfg, items,
                                           backend=backend)
    table = model.embed.weight
    it = table[note_lookup(table, targets).long()].to(user.dtype)
    return (user * it).sum(-1)


@torch.no_grad()
def serve_bert4rec(cfg, batch: int = 512, *, k: int = 100,
                   backend: str | None = None, device=None, seed: int = 0,
                   model=None):
    """The reference's BERT4Rec ``serve_p99`` cell (batch 512) and, at
    batch 1, its ``retrieval_cand`` cell: the pooled user vectors of
    ``batch`` sequences drawn from ``seed`` scored against every row of
    the embedding catalog, top ``k`` (values and int32 ids, descending,
    ties to the lowest id: ``lax.top_k``'s rule), on ``device`` (``cuda``
    unless the caller names another; raises without a GPU, and when
    ``model`` lives elsewhere).  The model is drawn from ``seed`` on the
    device unless ``model`` is given; ``backend`` selects the attention
    path (``fused``: B7).  Returns ((values, ids), the synchronized
    stage seconds)."""
    timings = {}
    model, device = _recsys_model(cfg, model, device, seed, timings)
    items = _bert4rec_items(cfg, batch, seed, device)
    t = time.perf_counter()
    out = bert4rec_topk(model, cfg, items, k=k, backend=backend)
    _sync(device)
    timings["serve_s"] = time.perf_counter() - t
    return out, timings


@torch.no_grad()
def serve_bert4rec_bulk(cfg, batch: int = 262_144, *,
                        backend: str | None = None, device=None,
                        seed: int = 0, model=None):
    """The reference's BERT4Rec ``serve_bulk`` cell: each of ``batch``
    pooled user vectors dotted with the embedding of one target item ->
    (batch,) f32 scores.  Sequences as in :func:`serve_bert4rec`, the
    targets uniform in [4, n_items) from ``seed``; device, model and
    backend as there.  Returns (scores, the synchronized stage
    seconds)."""
    timings = {}
    model, device = _recsys_model(cfg, model, device, seed, timings)
    items = _bert4rec_items(cfg, batch, seed, device)
    targets = torch.as_tensor(np.random.default_rng((seed, 1)).integers(
        4, cfg.n_items, size=batch, dtype=np.int32), device=device)
    t = time.perf_counter()
    scores = bert4rec_pair_scores(model, cfg, items, targets,
                                  backend=backend)
    _sync(device)
    timings["serve_s"] = time.perf_counter() - t
    return scores, timings


def top_k_digest(idx, scores) -> str:
    """sha1 of a served top-k's int32 ids and fp32 scores: the CLI prints
    it, so a script can tell that two runs answered alike bit for bit."""
    h = hashlib.sha1(np.ascontiguousarray(idx, np.int32).tobytes())
    h.update(np.ascontiguousarray(scores, np.float32).tobytes())
    return h.hexdigest()


def build_parser() -> argparse.ArgumentParser:
    """The reference's serving CLI (flags, defaults, choices), plus
    ``--device``."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="colbert")
    ap.add_argument("--keep", type=float, default=0.5)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the encoder from the newest valid train "
                         "checkpoint here (repro_torch.launch.train's); "
                         "raises where there is none")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--backend", default=None,
                    choices=list(backend_lib.BACKENDS),
                    help="pruning/scoring path (default: shortlist_topk "
                         "pruning + fused serving on the GPU, reference "
                         "on the CPU; see repro_torch.core.backend)")
    ap.add_argument("--index-dir", default=None,
                    help="packed-index artifact directory: load and serve "
                         "if one exists there, else prune -> pack -> save "
                         "it first (repro_torch.serve.index_io)")
    ap.add_argument("--compress", default="none",
                    choices=["none", "int8", "residual"],
                    help="token compression when packing a new index; "
                         "'residual' stores each kept token as a centroid "
                         "id + --residual-bits quantized residual, decoded "
                         "inside the scoring kernels")
    ap.add_argument("--residual-bits", type=int, default=4, choices=[2, 4],
                    help="bits per residual dimension for --compress "
                         "residual (ignored otherwise)")
    ap.add_argument("--pool-threshold", type=float, default=0.0,
                    help="merge kept tokens within a doc whose cosine "
                         "similarity meets this threshold before packing "
                         "(token pooling; 0 disables)")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "grid"],
                    help="'host': shard serving (and pruning) over every "
                         "local GPU; 'grid': the hosts x candidates "
                         "placement layout (buckets pinned to host groups, "
                         "one k-wide candidate exchange per group)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="host-group count for --mesh grid (0 = auto)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica count for --mesh grid placement")
    ap.add_argument("--on-group-loss", default="degrade",
                    choices=["degrade", "rebalance", "fail"],
                    help="policy when every replica of some bucket is "
                         "unreachable under --mesh grid")
    ap.add_argument("--kill-group", type=int, default=None,
                    help="fault injection: demote this host group before "
                         "the query batch (needs --mesh grid)")
    ap.add_argument("--n-first", type=int, default=64,
                    help="first-stage candidate count; >= corpus size "
                         "(or 0) serves the e2e exact sweep")
    ap.add_argument("--upsert", type=int, default=0,
                    help="durably upsert this many freshly encoded docs "
                         "into the artifact as a WAL-logged delta bucket "
                         "set, then serve the mutated view "
                         "(repro_torch.serve.mutation; needs --index-dir)")
    ap.add_argument("--delete", default=None,
                    help="comma-separated doc ids to durably tombstone "
                         "(WAL intent -> atomic tombstone set -> commit; "
                         "needs --index-dir)")
    ap.add_argument("--route", default="exhaustive",
                    choices=["exhaustive", "bounded", "nprobe"],
                    help="candidate routing mode (repro_torch.serve."
                         "routing): 'exhaustive' scores every capacity "
                         "bucket; 'nprobe' scores only the --nprobe best "
                         "buckets per query by centroid MaxSim; 'bounded' "
                         "keeps every bucket whose provable score upper "
                         "bound clears the shortlist threshold — exact "
                         "results, fewer buckets.  Routed modes need "
                         "--index-dir (the routing table is an artifact "
                         "sidecar)")
    ap.add_argument("--nprobe", type=int, default=1,
                    help="buckets to score per query under --route "
                         "nprobe (and the seed width for --route "
                         "bounded); must be >= 1")
    ap.add_argument("--centroids-per-bucket", type=int, default=4,
                    dest="centroids",
                    help="k-means centroids per capacity bucket when "
                         "building a new routing table (ignored with a "
                         "WARNING when the artifact already carries one)")
    ap.add_argument("--serve-loop", action="store_true",
                    help="after the batch serve, run the concurrent "
                         "micro-batched serving loop (repro_torch.serve."
                         "loop.ServeLoop): client threads stream single "
                         "queries, the dispatcher flushes pow2 "
                         "micro-batches, one epoch swap lands mid-run, "
                         "and every answer is checked bitwise against "
                         "the serial oracle")
    ap.add_argument("--flush-ms", type=float, default=2.0,
                    help="serve-loop flush deadline in milliseconds: a "
                         "micro-batch dispatches when this much time "
                         "passed since its oldest query (or --max-batch "
                         "filled, whichever first)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="serve-loop micro-batch cap: flush immediately "
                         "once this many queries are waiting")
    ap.add_argument("--compact", action="store_true",
                    help="fold the artifact's delta log into the next "
                         "epoch (new epoch written beside the live one, "
                         "committed by one atomic manifest swap) and "
                         "re-serve from it")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse + validate: the reference's checks, in its order and with
    its messages, so a contradiction dies at parse time with an argparse
    usage error."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.kill_group is not None and args.mesh != "grid":
        ap.error(f"--kill-group {args.kill_group} requires --mesh grid: "
                 "fault injection demotes a host group of the grid "
                 "placement, and no other mesh has host groups")
    if args.replicas > 1 and args.mesh == "none":
        ap.error(f"--replicas {args.replicas} requires a serving mesh: "
                 "replica chains place buckets across host groups "
                 "(--mesh grid); unsharded serving has nowhere to "
                 "replicate to")
    if args.upsert < 0:
        ap.error(f"--upsert {args.upsert} must be >= 0")
    if args.delete is not None:
        try:
            args.delete = tuple(int(x) for x in args.delete.split(",")
                                if x.strip())
        except ValueError:
            ap.error(f"--delete expects comma-separated integer doc "
                     f"ids, got {args.delete!r}")
    else:
        args.delete = ()
    mutating = bool(args.upsert or args.delete or args.compact)
    if mutating and not args.index_dir:
        ap.error("--upsert/--delete/--compact mutate a persisted "
                 "artifact; set --index-dir")
    if mutating and args.mesh == "grid":
        ap.error("mutation serving is single-process; run --compact to "
                 "fold the delta log into a fresh epoch before serving "
                 "it under --mesh grid")
    if args.pool_threshold and not 0.0 < args.pool_threshold <= 1.0:
        ap.error(f"--pool-threshold {args.pool_threshold} must be in "
                 "(0, 1]: it is a cosine-similarity merge cutoff "
                 "(0 disables pooling)")
    if args.nprobe < 1:
        ap.error(f"--nprobe {args.nprobe} must be >= 1: the router "
                 "always scores at least the best bucket per query")
    if args.centroids < 1:
        ap.error(f"--centroids-per-bucket {args.centroids} must be >= 1")
    if args.route != "exhaustive" and not args.index_dir:
        ap.error(f"--route {args.route} needs --index-dir: the routing "
                 "table is a sidecar of a persisted artifact "
                 "(repro_torch.serve.index_io.save_routing)")
    if not args.serve_loop:
        if args.flush_ms != 2.0:
            ap.error(f"--flush-ms {args.flush_ms} only applies to the "
                     "micro-batched serving loop; set --serve-loop")
        if args.max_batch != 8:
            ap.error(f"--max-batch {args.max_batch} only applies to the "
                     "micro-batched serving loop; set --serve-loop")
    else:
        if args.flush_ms < 0:
            ap.error(f"--flush-ms {args.flush_ms} must be >= 0 (0 means "
                     "flush whatever arrived with the first query)")
        if args.max_batch < 1:
            ap.error(f"--max-batch {args.max_batch} must be >= 1: a "
                     "flush serves at least one query")
        if args.arch != "colbert":
            ap.error(f"--serve-loop serves the late-interaction retrieval "
                     f"stack; --arch {args.arch} decodes an LM")
    if args.route != "exhaustive" and mutating:
        ap.error(f"--route {args.route} with --upsert/--delete/--compact "
                 "is not supported by this driver: the mutation demo "
                 "swaps served views mid-run, and routed swaps require "
                 "the matching epoch's routing table (the library "
                 "handles this — serve the mutated view exhaustively, "
                 "or compact first and serve the new epoch routed)")
    return args


def main(argv=None):
    """Run the CLI: ``--arch colbert`` serves retrieval at the smoke
    config (returns its :class:`ServeResult`); a ported LM arch decodes
    its smoke config (returns the ids and timings)."""
    args = parse_args(argv)
    if args.arch == "colbert":
        res = serve_retrieval(
            colbert_base.SMOKE, keep_fraction=args.keep,
            ckpt_dir=args.ckpt_dir, backend=args.backend,
            index_dir=args.index_dir, compress=args.compress,
            residual_bits=args.residual_bits,
            pool_threshold=args.pool_threshold, n_first=args.n_first,
            upsert=args.upsert, delete=args.delete, compact=args.compact,
            route=args.route, n_probe=args.nprobe, centroids=args.centroids,
            serve_loop=args.serve_loop, flush_ms=args.flush_ms,
            max_batch=args.max_batch, device=args.device, mesh=args.mesh,
            hosts=args.hosts, replicas=args.replicas,
            on_group_loss=args.on_group_loss, kill_group=args.kill_group)
        print(f"[serve] top-{res.idx.shape[1]} sha1: "
              f"{top_k_digest(res.idx, res.scores)}")
        return res
    lms = [a for a in configs.all_archs() if configs.get(a).family == "lm"]
    if args.arch in configs.all_archs() and \
            configs.get(args.arch).family == "recsys":
        raise NotImplementedError(
            f"--arch {args.arch}: the serve CLI has no recsys path (the "
            f"reference's has none either); serve the recsys family through "
            f"launch.serve's serve_ctr, retrieve_cand, serve_bert4rec and "
            f"serve_bert4rec_bulk")
    if args.arch in configs.all_archs() and \
            configs.get(args.arch).family == "gnn":
        raise NotImplementedError(
            f"--arch {args.arch}: there is no GNN serving path (the "
            f"reference's CLI has none either); train the GNN family through "
            f"launch.train")
    if args.arch not in lms:
        raise NotImplementedError(
            f"--arch {args.arch}: no such arch; the port's serve CLI runs "
            f"colbert and the LM family ({', '.join(lms)})")
    return serve_lm(configs.get(args.arch).smoke, n_tokens=args.tokens,
                    device=args.device)


if __name__ == "__main__":
    main()
