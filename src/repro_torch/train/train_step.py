"""Train/serve steps and the train state.

Counterpart of ``repro.train.train_step`` for the LM (dense and MoE),
ColBERT, CTR (DLRM, DCN-v2, Wide & Deep) and BERT4Rec steps:
``make_train_state``, ``_apply_opt``, ``lm_train_step`` (MoE aux
losses folded in, optional microbatch accumulation), ``lm_serve_step``,
``colbert_train_step``, ``ctr_train_step``, ``ctr_serve_step``,
``bert4rec_train_step`` (full logits), and
:func:`bert4rec_sampled_train_step`, the sampled-softmax step that
``repro.launch.train`` defines inline.  The
steps are plain torch differentiated by ``torch.autograd`` on the
``reference`` path, and they launch no kernel of the port: neither
package has a backward kernel, and the kernel wrappers refuse an input
that requires grad.  The GNN step is not ported yet (ROADMAP § A item
8d).

The train state is a dict ``{"params": model, "opt": AdamWState,
"step": int}``; a step updates the module's parameters and the moments
in place.  :func:`state_tree` writes it as the reference's train-state
tree (leaf names and layouts of the model's family,
``models.convert``), which the checkpointer saves, and
:func:`load_state_tree` reads such a tree back into a state.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import convert, recsys
from repro_torch.models.colbert import ColBERTConfig
from repro_torch.models.transformer import LMConfig
from repro_torch.train import losses, optimizer

PLAIN = "reference"     # the differentiable backend every step runs


def make_train_state(model) -> dict:
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


def param_grads(model, loss) -> dict[str, torch.Tensor]:
    """d loss / d every parameter of ``model`` by name, zeros where a
    parameter does not reach the loss (``jax.grad`` gives zeros)."""
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def _ranks(model) -> dict[str, int]:
    return convert.jax_ranks(dict(model.named_parameters()),
                             convert.family_of(model))


def _loss_step(loss_fn, opt_cfg):
    """``step(state, batch)``: ``loss_fn(model, batch)`` differentiated,
    then one AdamW update with the reference's decay ranks."""
    def step(state, batch):
        model = state["params"]
        loss = loss_fn(model, batch)
        return _apply_opt(opt_cfg, state, param_grads(model, loss), loss,
                          ranks=_ranks(model))
    return step


# ------------------------------ LM family ---------------------------------

def lm_loss_fn(model, tokens, aux_weight: float = 0.01):
    """The reference's ``loss_fn`` of ``lm_train_step`` on the plain
    path: (loss + aux_weight * (load_balance + router_z), the next-token
    loss alone, the aux losses averaged over layers)."""
    logits, aux = model.forward_aux(tokens, backend=PLAIN)
    loss = losses.lm_loss(logits, tokens)
    total = loss + aux_weight * (aux["load_balance"] + aux["router_z"])
    return total, loss, aux


def lm_train_step(cfg: LMConfig, opt_cfg: optimizer.AdamWConfig, *,
                  aux_weight: float = 0.01, accum: int = 1):
    """Causal-LM step; ``batch`` holds ``tokens`` (B, S) on the model's
    device.  accum 1: the gradients of the total loss (MoE aux losses
    folded in), the metric ``loss`` the next-token loss alone.  accum >
    1: B splits into ``accum`` microbatches taken in order, their
    gradients summed into fp32 zeros and divided by ``accum``, the loss
    the mean of their next-token losses — the reference's ``acc_body``.
    Metrics: ``loss``, ``grad_norm``, ``lr`` (0-d tensors)."""
    del cfg                     # the model carries it; kept for parity

    def step(state, batch):
        model = state["params"]
        tokens = batch["tokens"]
        if accum == 1:
            total, loss, _ = lm_loss_fn(model, tokens, aux_weight)
            grads = param_grads(model, total)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in model.named_parameters()}
            loss = torch.zeros((), device=tokens.device)
            for mb in tokens.reshape(accum, tokens.shape[0] // accum,
                                     tokens.shape[1]):
                total, l_mb, _ = lm_loss_fn(model, mb, aux_weight)
                for n, g in param_grads(model, total).items():
                    grads[n].add_(g)
                loss = loss + l_mb.detach()
                del total, l_mb
            grads = {n: g / accum for n, g in grads.items()}
            loss = loss / accum
        return _apply_opt(opt_cfg, state, grads, loss, ranks=_ranks(model))

    return step


def lm_serve_step(cfg: LMConfig, *, window="cfg"):
    """One-token decode with a KV cache: ``step(model, cache, tokens (B,
    1), pos) -> (logits, cache)``."""
    del cfg

    @torch.no_grad()
    def step(model, cache, tokens, pos):
        return model.decode_step(cache, tokens, pos, window=window)

    return step


# ------------------------------ ColBERT -----------------------------------

def colbert_train_step(cfg: ColBERTConfig, opt_cfg: optimizer.AdamWConfig,
                       *, reg: str | None = None, alpha: float = 0.0):
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds
    ``query_ids`` and ``doc_ids`` as tensors on the model's device.
    Metrics: ``loss``, ``grad_norm``, ``lr``, ``in_batch_acc`` (0-d
    tensors)."""
    def step(state, batch):
        model = state["params"]
        q_emb, q_mask = model.encode_queries(batch["query_ids"])
        d_emb, d_mask = model.encode_docs(batch["doc_ids"])
        loss, scores = losses.colbert_contrastive(
            q_emb, d_emb, d_mask, q_mask, reg=reg, alpha=alpha)
        labels = torch.arange(scores.shape[0], device=scores.device)
        acc = (scores.argmax(-1) == labels).float().mean()
        return _apply_opt(opt_cfg, state, param_grads(model, loss), loss,
                          {"in_batch_acc": acc}, _ranks(model))

    return step


# ------------------------------ RecSys ------------------------------------

def ctr_loss(forward_fn: Callable, model, batch):
    """The binary CTR loss of ``forward_fn(model, batch, backend=...)``
    on the plain path."""
    return losses.bce_logits(forward_fn(model, batch, backend=PLAIN),
                             batch["labels"])


def ctr_train_step(forward_fn: Callable, opt_cfg: optimizer.AdamWConfig):
    """DLRM / DCN-v2 / Wide&Deep: binary CTR loss.  ``forward_fn(model,
    batch, backend=...)`` -> (B,) logits, e.g. ``recsys.ctr_forward``;
    ``batch`` holds ``dense``, ``sparse_ids`` and ``labels``."""
    return _loss_step(lambda model, batch: ctr_loss(forward_fn, model, batch),
                      opt_cfg)


def ctr_serve_step(forward_fn: Callable, *, backend: str | None = None):
    """``step(model, batch)`` -> click probabilities sigmoid(logits),
    without autograd; ``backend`` as the model's (``fused`` on the
    card: B8)."""
    @torch.no_grad()
    def step(model, batch):
        return torch.sigmoid(forward_fn(model, batch, backend=backend))
    return step


def bert4rec_loss(cfg: recsys.Bert4RecConfig, model, batch):
    """Masked-item CE over the full catalog's logits (plain path)."""
    logits = recsys.bert4rec_forward(model, cfg, batch["items"],
                                     batch["attn_mask"], backend=PLAIN)
    return losses.masked_item_loss(logits, batch["labels"],
                                   batch["mask_positions"])


def bert4rec_train_step(cfg: recsys.Bert4RecConfig,
                        opt_cfg: optimizer.AdamWConfig):
    """The full-logit BERT4Rec step on a ``synthetic.bert4rec_batch``."""
    return _loss_step(lambda model, batch: bert4rec_loss(cfg, model, batch),
                      opt_cfg)


def bert4rec_sampled_loss(cfg: recsys.Bert4RecConfig, model, batch):
    """Sampled softmax over the positives and the shared negatives
    (plain path)."""
    pos, neg = recsys.bert4rec_sampled_logits(
        model, cfg, batch["items"], batch["mask_idx"], batch["labels"],
        batch["negatives"], backend=PLAIN)
    return recsys.sampled_softmax_loss(pos, neg)


def bert4rec_sampled_train_step(cfg: recsys.Bert4RecConfig,
                                opt_cfg: optimizer.AdamWConfig):
    """The sampled-softmax step on a ``synthetic.bert4rec_sampled_batch``
    (the BERT4Rec step of the reference's ``launch.train``)."""
    return _loss_step(
        lambda model, batch: bert4rec_sampled_loss(cfg, model, batch),
        opt_cfg)


# ------------------------------ state <-> tree -----------------------------

def _layout(model):
    family = convert.family_of(model)
    n_features = getattr(getattr(model, "cfg", None), "n_sparse", None)
    return family, (lambda sd: convert.params_to_jax(
        sd, family, n_features=n_features))


def state_tree(state) -> dict:
    """The train state as the reference's tree: ``{"opt": AdamWState(step,
    m, v), "params": ..., "step": int32}`` with the parameters and the
    moments under the reference's leaf names and layouts of the model's
    family (``convert.params_to_jax``)."""
    opt = state["opt"]
    _, to_jax = _layout(state["params"])
    params = dict(state["params"].named_parameters())
    return {"opt": optimizer.AdamWState(opt.step, to_jax(opt.m),
                                        to_jax(opt.v)),
            "params": to_jax(params),
            "step": torch.tensor(state["step"], dtype=torch.int32)}


def load_state_tree(state, tree) -> dict:
    """A train state holding ``tree`` (as :func:`state_tree` writes it):
    the parameters are copied into ``state``'s module, the moments are
    placed on its device in fp32."""
    model = state["params"]
    family, _ = _layout(model)
    model.load_state_dict(convert.params_from_jax(tree["params"], family))
    dev = next(model.parameters()).device
    opt = tree["opt"]

    def moments(t):
        return {n: x.to(dev, torch.float32).contiguous()
                for n, x in convert.params_from_jax(t, family).items()}
    return {"params": model,
            "opt": optimizer.AdamWState(
                torch.as_tensor(opt.step, dtype=torch.int32).cpu(),
                moments(opt.m), moments(opt.v)),
            "step": int(tree["step"])}
