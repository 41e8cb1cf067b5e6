"""Training driver: config-driven, checkpoint/restart-safe.

  PYTHONPATH=src python -m repro_torch.launch.train --arch colbert \\
      --preset smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20

Counterpart of ``repro.launch.train`` for the LM family (dense and
MoE: ``lm_train_step`` with MoE aux losses on ``lm_batch`` of ``seq``
tokens), the retrieval family (the ColBERT encoder) and the recsys
family: dlrm-rm2, dcn-v2 and wide-deep train through
``ctr_train_step`` on ``ctr_batch``, bert4rec through the
sampled-softmax step on ``bert4rec_sampled_batch`` (4 masked positions
and 32 negatives a batch, as the reference's ``launch.train`` draws
them; at ``preset="full"`` the ``train_batch`` shape's 30 and 1,024).
The GNN family, and every arch the port does not have, raise
``NotImplementedError`` until their train steps are ported (ROADMAP § A
item 8).  It trains on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu``), and raises without a GPU
otherwise.  An LM or recsys model is drawn from a generator on the
training device, so a full config is drawn on the card.

Restart semantics: the driver always restores the newest valid
checkpoint and resumes the step-indexed data pipeline at the restored
step — rerun the same command after a kill and training continues
bit-exactly.  Checkpoints are the reference's format and leaf layout
(``train.checkpoint``), so either package resumes the other's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import backend as backend_lib
from repro_torch.data import pipeline, synthetic
from repro_torch.models import colbert as colbert_lib
from repro_torch.models import recsys
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint, elastic, optimizer, train_step


def build_trainable(arch: str, preset: str, batch: int, seq: int,
                    opt_cfg: optimizer.AdamWConfig, device):
    """Returns (init_fn(seed) -> model on ``device``, step_fn,
    make_batch(step) -> dict of arrays or CPU tensors).  ``seq`` is the
    LM family's sequence length; the other families' lengths are their
    configs'."""
    if arch not in configs.all_archs():
        raise NotImplementedError(
            f"{arch}: the port has no such arch yet; it trains "
            f"{', '.join(_trainable())} (ROADMAP § A item 8)")
    entry = configs.get(arch)
    cfg = entry.smoke if preset == "smoke" else entry.config
    if entry.family == "recsys":
        return _recsys_trainable(arch, entry, cfg, preset, batch, opt_cfg,
                                 device)
    if entry.family == "lm":
        def init_lm(seed):
            gen = torch.Generator(device=device).manual_seed(seed)
            return tfm.init_params(gen, cfg, device)

        return (init_lm, train_step.lm_train_step(cfg, opt_cfg),
                lambda s: synthetic.lm_batch(0, s, batch, seq, cfg.vocab))
    if entry.family != "retrieval":
        raise NotImplementedError(
            f"{arch}: training the {entry.family} family is not ported yet "
            f"(ROADMAP § A item 8)")
    corpus = synthetic.token_corpus(0, n_docs=max(batch * 4, 64),
                                    n_q=max(batch * 4, 64), vocab=cfg.vocab,
                                    m=cfg.doc_len, l=cfg.query_len)
    rel = corpus.rel

    def make_batch(s):
        rng = np.random.default_rng(s)
        qi = rng.integers(0, corpus.q_ids.shape[0], batch)
        # positive doc: first relevant doc per query
        di = np.array([np.flatnonzero(rel[q])[0] if rel[q].any() else 0
                       for q in qi])
        return {"query_ids": corpus.q_ids[qi],
                "doc_ids": corpus.doc_ids[di]}

    def init_fn(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return colbert_lib.init_params(gen, cfg, device)

    return (init_fn,
            train_step.colbert_train_step(cfg, opt_cfg, reg="sim",
                                          alpha=0.1),
            make_batch)


def _trainable() -> list[str]:
    return [a for a in configs.all_archs()
            if configs.get(a).family in ("lm", "retrieval", "recsys")]


def _recsys_trainable(arch, entry, cfg, preset, batch, opt_cfg, device):
    """The recsys branch of the reference's ``launch.train``: bert4rec's
    sampled-softmax step, or the CTR step of dlrm-rm2, dcn-v2 and
    wide-deep."""
    def init_fn(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return recsys.init_model(gen, cfg, device)

    if arch == "bert4rec":
        dims = entry.shapes["train_batch"].dims
        n_masked, n_neg = ((dims["n_masked"], dims["n_negatives"])
                           if preset == "full" else (4, 32))

        def make_batch(s):
            return synthetic.bert4rec_sampled_batch(
                0, s, batch, cfg.seq_len, cfg.n_items, n_masked, n_neg)

        return (init_fn, train_step.bert4rec_sampled_train_step(cfg, opt_cfg),
                make_batch)

    def make_batch(s):
        return synthetic.ctr_batch(0, s, batch, 13, cfg.n_sparse,
                                   cfg.table_rows)

    return (init_fn, train_step.ctr_train_step(recsys.ctr_forward, opt_cfg),
            make_batch)


def run(arch: str, *, preset: str = "smoke", steps: int = 50, batch: int = 8,
        seq: int = 32, ckpt_dir: str | None = None, ckpt_every: int = 25,
        log_every: int = 10, lr: float = 1e-3, seed: int = 0,
        stop_after: int | None = None, device=None) -> dict:
    """`steps` fixes the optimizer schedule (the job's target length);
    `stop_after` simulates preemption mid-job — training halts there and
    a rerun of the same command resumes bit-exactly.  Returns the state,
    the losses, each step's wall seconds (ended by reading its loss on
    the host), the whole loop's wall seconds and the start step."""
    device = backend_lib.resolve_device(device)
    opt_cfg = optimizer.AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5),
                                    total_steps=steps)
    init_fn, step_fn, make_batch = build_trainable(arch, preset, batch, seq,
                                                   opt_cfg, device)
    state = train_step.make_train_state(init_fn(seed))
    start = 0
    if ckpt_dir:
        restored_step, tree = checkpoint.restore_latest(
            ckpt_dir, train_step.state_tree(state))
        if tree is not None:
            state = train_step.load_state_tree(state, tree)
            start = restored_step
            print(f"[train] resumed from step {start}")

    monitor = elastic.StragglerMonitor()
    pipe = pipeline.StepIndexedPipeline(make_batch, start_step=start,
                                        prefetch=2)
    losses, step_s = [], []
    t_train0 = time.perf_counter()
    stop = steps if stop_after is None else min(stop_after, steps)
    try:
        for s, batch_np in pipe:
            if s >= stop:
                break
            t0 = time.perf_counter()
            batch_d = {k: torch.as_tensor(v, device=device)
                       for k, v in batch_np.items()}
            state, metrics = step_fn(state, batch_d)
            loss = float(metrics["loss"])
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            monitor.record("host0", step_s[-1])
            if log_every and s % log_every == 0:
                acc = metrics.get("in_batch_acc")
                print(f"[train] step {s} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f}"
                      + ("" if acc is None else f" acc {float(acc):.3f}"))
            if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
                checkpoint.save_async(ckpt_dir, s + 1,
                                      train_step.state_tree(state))
    finally:
        pipe.close()
    if ckpt_dir:
        checkpoint.save(ckpt_dir, stop, train_step.state_tree(state))
        checkpoint.wait_pending()
    wall = time.perf_counter() - t_train0
    return {"state": state, "final_loss": losses[-1] if losses else None,
            "losses": losses, "step_s": step_s, "wall_s": wall,
            "start": start}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a ported arch; another raises naming what is "
                         "still to port")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args()
    out = run(args.arch, preset=args.preset, steps=args.steps,
              batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, lr=args.lr, device=args.device)
    loss = out["final_loss"]
    print(f"[train] done: final loss "
          f"{'none (no step run)' if loss is None else f'{loss:.4f}'} "
          f"({out['wall_s']:.1f}s)")


if __name__ == "__main__":
    main()
