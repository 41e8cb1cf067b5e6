"""The ColBERT train step and its train state.

Counterpart of ``make_train_state``, ``_apply_opt`` and
``colbert_train_step`` of ``repro.train.train_step``; the step is plain
torch differentiated by ``torch.autograd``, and it launches no kernel
of the port (the encoder passes key masks, so its attention takes the
plain branch; MaxSim is ``core.scoring.maxsim_matrix``).  The LM, GNN,
CTR and BERT4Rec steps are not ported yet (ROADMAP § A item 8).

The train state is a dict ``{"params": ColBERT, "opt": AdamWState,
"step": int}``; a step updates the module's parameters and the moments
in place.  :func:`state_tree` writes it as the reference's train-state
tree (leaf names and layouts), which the checkpointer saves, and
:func:`load_state_tree` reads such a tree back into a state.
"""

from __future__ import annotations

import torch

from repro_torch.models import convert
from repro_torch.models.colbert import ColBERT, ColBERTConfig
from repro_torch.train import losses, optimizer


def make_train_state(model: ColBERT) -> dict:
    return {"params": model,
            "opt": optimizer.init(dict(model.named_parameters())),
            "step": 0}


def _apply_opt(opt_cfg, state, grads, loss, extra=None, ranks=None):
    params = dict(state["params"].named_parameters())
    _, opt, stats = optimizer.apply(opt_cfg, params, grads, state["opt"],
                                    ranks=ranks)
    metrics = {"loss": loss.detach(), **stats}
    if extra:
        metrics.update(extra)
    return ({"params": state["params"], "opt": opt,
             "step": state["step"] + 1}, metrics)


def colbert_train_step(cfg: ColBERTConfig, opt_cfg: optimizer.AdamWConfig,
                       *, reg: str | None = None, alpha: float = 0.0):
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``query_ids`` and ``doc_ids`` as tensors on the model's device.
    Metrics: ``loss``, ``grad_norm``, ``lr``, ``in_batch_acc`` (0-d
    tensors)."""
    def step(state, batch):
        model = state["params"]
        params = dict(model.named_parameters())
        q_emb, q_mask = model.encode_queries(batch["query_ids"])
        d_emb, d_mask = model.encode_docs(batch["doc_ids"])
        loss, scores = losses.colbert_contrastive(
            q_emb, d_emb, d_mask, q_mask, reg=reg, alpha=alpha)
        labels = torch.arange(scores.shape[0], device=scores.device)
        acc = (scores.argmax(-1) == labels).float().mean()
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        return _apply_opt(opt_cfg, state, grads, loss,
                          {"in_batch_acc": acc}, convert.jax_ranks(params))

    return step


def state_tree(state) -> dict:
    """The train state as the reference's tree: ``{"opt": AdamWState(step,
    m, v), "params": ..., "step": int32}`` with the parameters and the
    moments under the reference's leaf names and layouts
    (``convert.params_to_jax``)."""
    opt = state["opt"]
    params = dict(state["params"].named_parameters())
    return {"opt": optimizer.AdamWState(opt.step,
                                        convert.params_to_jax(opt.m),
                                        convert.params_to_jax(opt.v)),
            "params": convert.params_to_jax(params),
            "step": torch.tensor(state["step"], dtype=torch.int32)}


def load_state_tree(state, tree) -> dict:
    """A train state holding ``tree`` (as :func:`state_tree` writes it):
    the parameters are copied into ``state``'s module, the moments are
    placed on its device in fp32."""
    model = state["params"]
    model.load_state_dict(convert.params_from_jax(tree["params"]))
    dev = next(model.parameters()).device
    opt = tree["opt"]

    def moments(t):
        return {n: x.to(dev, torch.float32).contiguous()
                for n, x in convert.params_from_jax(t).items()}
    return {"params": model,
            "opt": optimizer.AdamWState(
                torch.as_tensor(opt.step, dtype=torch.int32).cpu(),
                moments(opt.m), moments(opt.v)),
            "step": int(tree["step"])}
