"""Cell builders: (architecture x input shape x mesh x variant) -> a step.

Counterpart of ``repro.launch.steps``.  :func:`build_cell` returns a
:class:`Cell`: the step function the trainer and the servers run
(``launch/train.py``, ``launch/serve.py``), its arguments at full scale
on the ``meta`` device (modules and train states built under
``torch.device("meta")``: nothing is allocated), the partition specs of
the production mesh, the rule set and the step's model FLOPs.  The dry
run (``launch.dryrun``) counts a cell's work on those meta arguments;
:func:`materialize` draws real ones on a device, where the same ``fn``
runs.  A train cell of the LM family also runs placed over its mesh by
its specs: ``sharding.placed`` cuts its state and batch over the mesh's
positions and steps them from one controller (``placed_step``).

Specs live on the reference's tree.  ``in_specs`` holds one spec tree an
argument, each in the layout :func:`cell_tree` writes the argument in:
a train state as ``train_step.state_tree`` (layers stacked, matrices
(in, out), AdamW's moments beside), a bare model as
``convert.params_to_jax``, the KV cache as ``{"k", "v"}`` of (L, B,
kv_heads, len, hd), an integer position as a 0-d int32.  A spec is a
tuple with one entry a dimension (``None``, a mesh axis or a tuple of
axes), the reference's ``PartitionSpec`` as a plain tuple, so
:func:`leaves` pairs each tensor of :func:`cell_tree` with its spec and
the specs compare leaf for leaf with the reference's.

``fn`` takes the port's own objects and passes ``backend`` down:
``None`` is the device's default (the kernels on the card: B2 for
pruning, B7 for LM prefill and BERT4Rec serving, B8 for the CTR
lookups), ``"reference"`` the plain path.  Training steps run the
plain path whatever ``backend`` says (no kernel has a backward).

Variants (``variant=``, joined by ``+``):
  baseline      the reference's posture
  ep_moe        experts over ``model`` (the rules and the MoE specs)
  attn_remat    ``remat_attn_chunk`` set: each query chunk of the plain
                attention recomputed in the backward pass
  rs_grads      gradients pinned to the parameters' sharding: the
                dry run counts a reduce-scatter where the baseline
                counts an all-reduce (``grads_pinned``); the step is
                the same
  zero_tables   recsys tables over (data, model) rows x dims, gradients
                pinned
  a2a_lookup    the CTR lookups by ``recsys.alltoall_lookup`` over the
                cell's mesh (``"__lookup__": "a2a"`` and ``"__mesh__"``
                in the rules), tables row-sharded over ``model``
  a2a_zero      the same exchange over every axis
                (``"__lookup_axes__"``), tables row-sharded over every
                axis, gradients pinned
  fused_top2[_bf16], shortlist[_bf16], shortlist_topk
                ColBERT's ``prune_index`` knobs (``fast``,
                ``bf16_scores``, ``shortlist``, ``backend``)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from repro_torch import sharding as shlib
from repro_torch.configs import base as cfgbase
from repro_torch.core import backend as backend_lib
from repro_torch.core import voronoi
from repro_torch.data import graph_sampler
from repro_torch.launch.serve import (bert4rec_pair_scores, bert4rec_topk,
                                      prefill_lm)
from repro_torch.models import colbert as colbert_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.sharding.specs import logical_to_spec
from repro_torch.train import optimizer, train_step

__all__ = ["Cell", "build_cell", "cell_tree", "leaves", "lm_param_specs",
           "lm_param_specs_fsdp", "materialize"]

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_id: str
    kind: str
    fn: Callable | None
    args: tuple                  # meta tensors, modules, train states
    in_specs: tuple              # one spec tree an argument (cell_tree's)
    out_specs: Any
    mesh: Any
    rules: dict
    model_flops_per_step: float  # 6*N*D (or the family's analogue)
    skip: str | None = None
    donate: tuple = ()
    variant: str = "baseline"
    compute_dtype: torch.dtype = F32
    remat: bool = False          # a train step recomputes its blocks
    grads_pinned: bool = False   # rs_grads / zero_tables / a2a_zero
    model_passes: int = 1        # model forwards a step (ColBERT's: 2)
    draws: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Trees: the reference's layout of the arguments, and specs beside them
# ---------------------------------------------------------------------------

def _is_state(x) -> bool:
    return isinstance(x, dict) and isinstance(x.get("params"), nn.Module)


def _tree(x):
    if _is_state(x):
        return train_step.state_tree(x)
    if isinstance(x, nn.Module):
        return train_step.param_tree(x)
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    if isinstance(x, int) and not isinstance(x, bool):
        return torch.tensor(x, dtype=I32)
    return x


def cell_tree(cell: Cell) -> tuple:
    """The cell's arguments in the reference's layout (module
    docstring): a tuple of trees of tensors, ``None`` where the
    reference passes ``None``."""
    return tuple(_tree(a) for a in cell.args)


def _walk(tree, specs, path):
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield path, tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, specs[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _walk(getattr(tree, k), getattr(specs, k),
                             path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, specs[i], path + (i,))
    else:
        raise TypeError(f"no tree leaf of type {type(tree).__name__}")


def leaves(cell: Cell, tree: tuple | None = None):
    """(path, tensor, spec) for every tensor of :func:`cell_tree`, the
    path a tuple of dict keys, field names and positions."""
    tree = cell_tree(cell) if tree is None else tree
    for i, (t, s) in enumerate(zip(tree, cell.in_specs)):
        yield from _walk(t, s, (i,))


def _map_path(fn, tree, path=()):
    """``fn(path, leaf)`` over every tensor of a nested dict / tuple
    tree, the structure kept."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_path(fn, getattr(tree, k), path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def _replicated(tree):
    return _map_path(lambda p, x: (), tree)


# ---------------------------------------------------------------------------
# LM param/state specs
# ---------------------------------------------------------------------------

def _vocab_ax(cfg):
    """Shard the vocab axis only when it divides the model axis (16);
    granite's 49,155 and bert4rec's 1,000,002 stay replicated."""
    return "model" if cfg.vocab % 16 == 0 else None


def lm_param_specs(cfg: tfm.LMConfig, *, ep_moe: bool = False) -> dict:
    """The reference's LM spec tree (FSDP over ``data``, TP over
    ``model``), in the stacked layout."""
    bias = (None, "model") if cfg.qkv_bias else None
    attn = {"wq": (None, "data", "model"), "wk": (None, "data", "model"),
            "wv": (None, "data", "model"), "wo": (None, "model", "data"),
            "bq": bias, "bk": bias, "bv": bias}
    layer = {"ln1": (None, None), "ln2": (None, None), "attn": attn}
    if cfg.moe_experts:
        if ep_moe:
            layer["moe"] = {"router": (None, "data", None),
                            "w_gate": (None, "model", "data", None),
                            "w_up": (None, "model", "data", None),
                            "w_down": (None, "model", None, "data")}
        else:
            layer["moe"] = {"router": (None, "data", None),
                            "w_gate": (None, None, "data", "model"),
                            "w_up": (None, None, "data", "model"),
                            "w_down": (None, None, "model", "data")}
    else:
        layer["ffn"] = {"w_gate": (None, "data", "model"),
                        "w_up": (None, "data", "model"),
                        "w_down": (None, "model", "data")}
    specs = {"embed": (_vocab_ax(cfg), "data"), "layers": layer,
             "ln_f": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ("data", _vocab_ax(cfg))
    return specs


def lm_param_specs_fsdp(params_tree, multi_pod: bool):
    """The training cells' pure FSDP posture: every parameter sharded on
    one dimension over as many devices as divide it (all of them first),
    never the stacked layer axis."""
    full = ("pod", "data", "model") if multi_pod else ("data", "model")
    n_full = 512 if multi_pod else 256
    combos = [(full, n_full), (("data", "model"), 256), (("model",), 16),
              (("data",), 16)]
    if multi_pod:
        combos.insert(1, (("data", "model"), 256))

    def spec(path, x):
        shape = x.shape
        lead = 1 if len(shape) >= 3 else 0
        for axes, n in combos:
            for d in range(len(shape) - 1, lead - 1, -1):
                if shape[d] % n == 0 and shape[d] >= n:
                    parts = [None] * len(shape)
                    parts[d] = axes if len(axes) > 1 else axes[0]
                    return tuple(parts)
        return (None,) * len(shape)

    return _map_path(spec, params_tree)


def _state_specs(param_specs):
    return {"params": param_specs,
            "opt": optimizer.AdamWState(step=(), m=param_specs,
                                        v=param_specs),
            "step": ()}


def _meta(cls, *a):
    with torch.device("meta"):
        return cls(*a)


def _meta_t(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _with_rules(rules, step):
    def fn(*a):
        with shlib.axis_rules(rules):
            return step(*a)
    return fn


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(entry, shape, mesh, multi_pod, variant, backend):
    cfg: tfm.LMConfig = entry.config
    vset = set(variant.split("+"))
    if "attn_remat" in vset:
        cfg = dataclasses.replace(cfg, remat_attn_chunk=True)
    ep = variant == "ep_moe" and cfg.moe_experts > 0
    pspecs = lm_param_specs(cfg, ep_moe=ep)
    mf = 6.0 * cfg.active_param_count()
    B = shape.dims["global_batch"]
    S = shape.dims["seq_len"]
    model = _meta(tfm.Transformer, cfg)
    common = dict(variant=variant, compute_dtype=cfg.compute_dtype)
    ids = ("ids", 0, cfg.vocab)

    if shape.kind == "train":
        rules = shlib.lm_train_rules(multi_pod)
        if ep:
            rules = shlib.lm_rules_ep_moe(rules)
        state = train_step.make_train_state(model)
        pfsdp = lm_param_specs_fsdp(train_step.param_tree(model), multi_pod)
        sspec = _state_specs(pfsdp)
        batch_spec = {"tokens": logical_to_spec(("batch", "seq"), rules)}
        step = train_step.lm_train_step(cfg, optimizer.CELL_CONFIG)
        return Cell(entry.arch_id, shape.shape_id, "train",
                    _with_rules(rules, step),
                    (state, {"tokens": _meta_t((B, S), I32)}),
                    (sspec, batch_spec), (sspec, None), mesh, rules,
                    mf * B * S, donate=(0,), remat=cfg.remat,
                    grads_pinned="rs_grads" in vset,
                    draws={(1, "tokens"): ids}, **common)

    if shape.kind == "prefill":
        rules = shlib.lm_prefill_rules(multi_pod)
        if ep:
            rules = shlib.lm_rules_ep_moe(rules)

        def prefill(model, tokens):
            return prefill_lm(model, tokens, backend=backend,
                              device=tokens.device)[0]

        return Cell(entry.arch_id, shape.shape_id, "prefill",
                    _with_rules(rules, prefill),
                    (model.eval(), _meta_t((B, S), I32)),
                    (pspecs, logical_to_spec(("batch", "seq"), rules)),
                    None, mesh, rules, 2.0 * cfg.active_param_count() * B * S,
                    draws={(1,): ids}, **common)

    # decode
    rules = shlib.lm_decode_rules(multi_pod, batch=B)
    if ep:
        rules = shlib.lm_rules_ep_moe(rules)
    window = cfg.window or cfg.attn_window_serving
    if shape.shape_id == "long_500k" and cfg.attn_window_serving:
        window = cfg.attn_window_serving
    cache = model.init_cache(B, S, window=window)
    # the step at the shape's last position (a full cache, or a ring
    # buffer wrapped around)
    kv = logical_to_spec((None, "batch", "kv_heads", "kv_len", None), rules)
    cache_spec = {"k": kv, "v": kv}
    serve = train_step.lm_serve_step(cfg, window=window)
    return Cell(entry.arch_id, shape.shape_id, "decode",
                _with_rules(rules, serve),
                (model.eval(), cache, _meta_t((B, 1), I32), S - 1),
                (pspecs, cache_spec, logical_to_spec(("batch", None), rules),
                 ()),
                (None, cache_spec), mesh, rules,
                2.0 * cfg.active_param_count() * B, donate=(1,),
                draws={(1, "k"): ("zeros",), (1, "v"): ("zeros",),
                       (2,): ids}, **common)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_SHAPE_META = {
    # shape_id: (d_feat, n_classes, task)
    "full_graph_sm": (1433, 7, "node"),
    "minibatch_lg": (602, 41, "node"),
    "ogb_products": (100, 47, "node"),
    "molecule": (16, 2, "graph"),
}


def _gnn_cell(entry, shape, mesh, multi_pod, variant, backend):
    d_feat, n_classes, task = GNN_SHAPE_META[shape.shape_id]
    cfg = dataclasses.replace(entry.config, d_feat=d_feat,
                              n_classes=n_classes)
    rules = shlib.gnn_rules(multi_pod)
    state = train_step.make_train_state(_meta(gnn_lib.GIN, cfg))
    sspec = _replicated(train_step.state_tree(state))

    dims = shape.dims
    # Edge lists pad to a multiple of 512 (a shard boundary on both
    # meshes); padded edges carry edge_mask False and point at node 0.
    if shape.shape_id == "molecule":
        n_nodes = dims["n_nodes"] * dims["batch"]
        e = dims["n_edges"] * dims["batch"]
        n_labels = dims["batch"]
        graph_ids = True
    elif shape.shape_id == "minibatch_lg":
        n_nodes, e = dims["max_nodes"], dims["max_edges"]
        n_labels = n_nodes
        graph_ids = False
    else:
        n_nodes, e = dims["n_nodes"], dims["n_edges"]
        n_labels = n_nodes
        graph_ids = False
    e_pad = -(-e // 512) * 512
    batch = {"x": _meta_t((n_nodes, d_feat), F32),
             "edge_index": _meta_t((2, e_pad), I32),
             "edge_mask": _meta_t((e_pad,), torch.bool),
             "labels": _meta_t((n_labels,), I32),
             "label_mask": _meta_t((n_labels,), F32)}
    espec = logical_to_spec(("edges",), rules)
    bspec = {"x": (), "edge_index": logical_to_spec((None, "edges"), rules),
             "edge_mask": espec, "labels": (), "label_mask": ()}
    if graph_ids:
        batch["graph_ids"] = _meta_t((n_nodes,), I32)
        bspec["graph_ids"] = ()
    step = train_step.gin_train_step(cfg, optimizer.CELL_CONFIG, task=task)
    # per-edge gather+add ~ 2*d_hidden flops x layers + node MLPs
    mf = (2.0 * e_pad * cfg.d_hidden * cfg.n_layers
          + 2.0 * n_nodes * cfg.param_count())
    graph = ("graph", shape.shape_id, n_nodes, e, d_feat, n_classes,
             dims.get("n_nodes"), dims.get("n_edges"), dims.get("batch"))
    return Cell(entry.arch_id, shape.shape_id, "train",
                _with_rules(rules, step), (state, batch), (sspec, bspec),
                (sspec, None), mesh, rules, mf, variant=variant,
                draws={(1,): graph})


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _name(path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _recsys_param_specs(params_tree, rows="model"):
    """Row-sharded tables over ``rows``: ``model`` (26 or 40 tables do
    not divide 16, and replicated tables with their moments would not
    fit), or every axis for ``a2a_zero``."""
    def leaf_spec(path, x):
        name = _name(path)
        if "tables" in name:
            return (None, rows, None)
        if "wide" in name:
            return (None, rows)
        return (None,) * x.dim()
    return _map_path(leaf_spec, params_tree)


def _recsys_param_specs_zero(params_tree, multi_pod):
    """ZeRO over rows x dims: rows over data (and pod), dims over
    ``model`` (1M rows do not divide 256)."""
    row_ax = ("pod", "data") if multi_pod else "data"

    def leaf_spec(path, x):
        name = _name(path)
        if "tables" in name:
            return (None, row_ax, "model")
        if "wide" in name:
            return (None, row_ax)
        return (None,) * x.dim()
    return _map_path(leaf_spec, params_tree)


_CTR_MODEL = {"dlrm-rm2": recsys_lib.DLRM, "dcn-v2": recsys_lib.DCN,
              "wide-deep": recsys_lib.WideDeep}


def _ctr_batch_specs(arch_id, cfg, B, rules):
    batch = {"sparse_ids": _meta_t((B, cfg.n_sparse), I32)}
    bspec = {"sparse_ids": logical_to_spec(("batch", None), rules)}
    if arch_id != "wide-deep":
        batch["dense"] = _meta_t((B, cfg.n_dense), F32)
        bspec["dense"] = logical_to_spec(("batch", None), rules)
    return batch, bspec


def _recsys_cell(entry, shape, mesh, multi_pod, variant, backend):
    if entry.arch_id == "bert4rec":
        return _bert4rec_cell(entry, shape, mesh, multi_pod, variant,
                              backend)
    cfg = entry.config
    rules = shlib.recsys_rules_rowsharded(multi_pod)
    every = ("pod", "data", "model") if multi_pod else ("data", "model")
    if variant in ("a2a_lookup", "a2a_zero"):
        rules = dict(rules) | {"__lookup__": "a2a", "__mesh__": mesh}
    if variant == "a2a_zero":
        # rows over every position: the exchange spans every axis, so a
        # table's gradient is its owner's alone (no reduction)
        rules["__lookup_axes__"] = every
    model = _meta(_CTR_MODEL[entry.arch_id], cfg)
    ptree = train_step.param_tree(model)
    if variant == "zero_tables":
        pspec = _recsys_param_specs_zero(ptree, multi_pod)
    elif variant == "a2a_zero":
        pspec = _recsys_param_specs(ptree, rows=every)
    else:
        pspec = _recsys_param_specs(ptree)
    # dense-tower flops dominate model flops for CTR models
    mlp_params = cfg.param_count() - cfg.n_sparse * cfg.table_rows * (
        cfg.embed_dim + (1 if entry.arch_id == "wide-deep" else 0))
    B = shape.dims["batch"]
    ids = ("ids", 0, cfg.table_rows)
    common = dict(variant=variant)

    if shape.kind == "train":
        sspec = _state_specs(pspec)
        batch, bspec = _ctr_batch_specs(entry.arch_id, cfg, B, rules)
        batch["labels"] = _meta_t((B,), F32)
        bspec["labels"] = logical_to_spec(("batch",), rules)
        step = train_step.ctr_train_step(recsys_lib.ctr_forward,
                                         optimizer.CELL_CONFIG)
        return Cell(entry.arch_id, shape.shape_id, "train",
                    _with_rules(rules, step), (train_step.make_train_state(model), batch),
                    (sspec, bspec), (sspec, None), mesh, rules,
                    6.0 * mlp_params * B,
                    grads_pinned=variant in ("zero_tables", "a2a_zero"),
                    draws={(1, "sparse_ids"): ids,
                           (1, "labels"): ("bernoulli",)}, **common)

    if shape.kind == "serve":
        batch, bspec = _ctr_batch_specs(entry.arch_id, cfg, B, rules)
        step = train_step.ctr_serve_step(recsys_lib.ctr_forward,
                                         backend=backend)
        return Cell(entry.arch_id, shape.shape_id, "serve",
                    _with_rules(rules, step), (model.eval(), batch),
                    (pspec, bspec), None, mesh, rules, 2.0 * mlp_params * B,
                    draws={(1, "sparse_ids"): ids}, **common)

    # retrieval_cand
    rules = dict(rules) | {"batch": None}
    has_dense = entry.arch_id != "wide-deep"

    @torch.no_grad()
    def retrieve(model, dense, sparse_ids):
        return recsys_lib.retrieve_topk(model, dense, sparse_ids, k=100,
                                        backend=backend)

    args = (model.eval(),
            _meta_t((B, cfg.n_dense), F32) if has_dense else None,
            _meta_t((B, cfg.n_sparse), I32))
    mf = 2.0 * B * shape.dims["n_candidates"] * cfg.embed_dim
    return Cell(entry.arch_id, shape.shape_id, "retrieval",
                _with_rules(rules, retrieve), args,
                (pspec, () if has_dense else None, ()), None, mesh, rules,
                mf, draws={(2,): ids}, **common)


def _bert4rec_cell(entry, shape, mesh, multi_pod, variant, backend):
    cfg: recsys_lib.Bert4RecConfig = entry.config
    lm = cfg.lm_config()
    rules = shlib.recsys_rules(multi_pod)
    pspecs = lm_param_specs(lm)
    model = _meta(tfm.Transformer, lm)
    dims = shape.dims
    S = dims.get("seq_len", cfg.seq_len)
    items = ("ids", 4, cfg.n_items)
    dense = cfg.param_count() - cfg.n_items * cfg.embed_dim
    common = dict(variant=variant)

    if shape.kind == "train":
        B, M, N = dims["batch"], dims["n_masked"], dims["n_negatives"]
        sspec = _state_specs(pspecs)
        batch = {"items": _meta_t((B, S), I32),
                 "mask_idx": _meta_t((B, M), I32),
                 "labels": _meta_t((B, M), I32),
                 "negatives": _meta_t((N,), I32)}
        bsp = logical_to_spec(("batch", None), rules)
        bspec = {"items": bsp, "mask_idx": bsp, "labels": bsp,
                 "negatives": ()}
        step = train_step.bert4rec_sampled_train_step(cfg,
                                                      optimizer.CELL_CONFIG)
        return Cell(entry.arch_id, shape.shape_id, "train",
                    _with_rules(rules, step), (train_step.make_train_state(model), batch),
                    (sspec, bspec), (sspec, None), mesh, rules,
                    6.0 * dense * B * S,
                    draws={(1, "items"): items, (1, "labels"): items,
                           (1, "negatives"): items,
                           (1, "mask_idx"): ("ids", 0, S)}, **common)

    bsp = logical_to_spec(("batch", None), rules)
    if shape.kind == "serve":
        B = dims["batch"]
        if dims.get("full_catalog"):
            def serve(model, items):
                return bert4rec_topk(model, cfg, items, k=100,
                                     backend=backend)
            args = (model.eval(), _meta_t((B, S), I32))
            specs = (pspecs, bsp)
            draws = {(1,): items}
        else:
            def serve(model, items, target_items):
                return bert4rec_pair_scores(model, cfg, items, target_items,
                                            backend=backend)
            args = (model.eval(), _meta_t((B, S), I32), _meta_t((B,), I32))
            specs = (pspecs, bsp, logical_to_spec(("batch",), rules))
            draws = {(1,): items, (2,): items}
        return Cell(entry.arch_id, shape.shape_id, "serve",
                    _with_rules(rules, serve), args, specs, None, mesh,
                    rules, 2.0 * dense * B * S, draws=draws, **common)

    # retrieval_cand
    B = dims["batch"]
    rules = dict(rules) | {"batch": None}

    def retrieve(model, items):
        return bert4rec_topk(model, cfg, items, k=100, backend=backend)

    return Cell(entry.arch_id, shape.shape_id, "retrieval",
                _with_rules(rules, retrieve),
                (model.eval(), _meta_t((B, S), I32)), (pspecs, ()), None,
                mesh, rules, 2.0 * B * dims["n_candidates"] * cfg.embed_dim,
                draws={(1,): items}, **common)


# ---------------------------------------------------------------------------
# ColBERT cells (the paper's own architecture)
# ---------------------------------------------------------------------------

def _colbert_cell(entry, shape, mesh, multi_pod, variant, backend):
    cfg: colbert_lib.ColBERTConfig = entry.config
    lm = cfg.lm_config()
    rules = shlib.lm_prefill_rules(multi_pod) | {
        "batch": (("pod", "data", "model") if multi_pod
                  else ("data", "model"))}
    pspecs = {"backbone": lm_param_specs(lm), "proj": (None, None)}
    model = _meta(colbert_lib.ColBERT, cfg)
    dims = shape.dims
    mf_tok = 2.0 * (lm.param_count() - lm.vocab * lm.d_model)
    ids = ("ids", 0, cfg.vocab)
    common = dict(variant=variant)

    if shape.shape_id == "train_contrastive":
        B = dims["batch"]
        sspec = _state_specs(pspecs)
        step = train_step.colbert_train_step(cfg, optimizer.CELL_CONFIG,
                                             reg="sim", alpha=0.1)
        batch = {"query_ids": _meta_t((B, dims["query_len"]), I32),
                 "doc_ids": _meta_t((B, dims["doc_len"]), I32)}
        bsp = logical_to_spec(("batch", None), rules)
        mf = 3.0 * mf_tok * B * (dims["query_len"] + dims["doc_len"])
        return Cell(entry.arch_id, shape.shape_id, "train",
                    _with_rules(rules, step), (train_step.make_train_state(model), batch),
                    (sspec, {"query_ids": bsp, "doc_ids": bsp}),
                    (sspec, None), mesh, rules, mf,
                    compute_dtype=cfg.compute_dtype, model_passes=2,
                    draws={(1, "query_ids"): ids, (1, "doc_ids"): ids},
                    **common)

    if shape.shape_id == "encode_corpus":
        B = dims["batch"]

        @torch.no_grad()
        def encode(model, doc_ids):
            return model.encode_docs(doc_ids)

        return Cell(entry.arch_id, shape.shape_id, "serve",
                    _with_rules(rules, encode),
                    (model.eval(), _meta_t((B, dims["doc_len"]), I32)),
                    (pspecs, logical_to_spec(("batch", None), rules)), None,
                    mesh, rules, mf_tok * B * dims["doc_len"],
                    compute_dtype=cfg.compute_dtype, draws={(1,): ids},
                    **common)

    if shape.shape_id == "prune_index":
        nd, m = dims["docs_per_block"], dims["doc_len"]
        N, dim = dims["n_samples"], dims["out_dim"]
        topk = variant == "shortlist_topk"
        fast = variant.startswith("fused_top2")
        shortl = variant.startswith("shortlist") and not topk
        bf16 = variant.endswith("bf16")

        @torch.no_grad()
        def prune(d_embs, d_masks, samples):
            return voronoi.pruning_order_batch(
                d_embs, d_masks, samples, fast=fast, bf16_scores=bf16,
                shortlist=shortl,
                backend=backend_lib.SHORTLIST_TOPK if topk else backend)

        args = (_meta_t((nd, m, dim), F32), _meta_t((nd, m), torch.bool),
                _meta_t((N, dim), F32))
        specs = (logical_to_spec(("batch", None, None), rules),
                 logical_to_spec(("batch", None), rules), ())
        return Cell(entry.arch_id, shape.shape_id, "serve",
                    _with_rules(rules, prune), args, specs, None, mesh,
                    rules, 2.0 * nd * N * m * dim,
                    draws={(0,): ("unit",), (2,): ("unit",)}, **common)

    # rerank: n_queries=128 < 256 devices -> the batch over data(+pod),
    # candidates over model (the rerank fan-out axis)
    nq, nc = dims["n_queries"], dims["n_candidates"]
    lq, m = dims["query_len"], dims["doc_len"]
    dim = cfg.out_dim
    rules = dict(rules) | {
        "batch": (("pod", "data") if multi_pod else ("data",)),
        "candidates": ("model",)}

    @torch.no_grad()
    def rerank(q_embs, d_embs, d_masks):
        s = torch.einsum("qld,qnmd->qnlm", q_embs, d_embs)
        s = torch.where(d_masks[:, :, None, :], s, -1e30)
        return shlib.constrain(s.amax(-1).sum(-1), "batch", "candidates")

    args = (_meta_t((nq, lq, dim), F32), _meta_t((nq, nc, m, dim), F32),
            _meta_t((nq, nc, m), torch.bool))
    specs = (logical_to_spec(("batch", None, None), rules),
             logical_to_spec(("batch", "candidates", None, None), rules),
             logical_to_spec(("batch", "candidates", None), rules))
    return Cell(entry.arch_id, shape.shape_id, "serve",
                _with_rules(rules, rerank), args, specs, None, mesh, rules,
                2.0 * nq * nc * lq * m * dim,
                draws={(0,): ("unit",), (1,): ("unit",)}, **common)


# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_id: str, mesh, *, multi_pod: bool = False,
               variant: str = "baseline", backend: str | None = None) -> Cell:
    """The cell of (arch, shape) on ``mesh`` (module docstring); a
    shape the reference skips gives ``Cell.skip`` with its reason."""
    entry = cfgbase.get(arch_id)
    shape = entry.shapes[shape_id]
    if shape.skip:
        return Cell(arch_id, shape_id, shape.kind, None, (), (), None, mesh,
                    {}, 0.0, skip=shape.skip, variant=variant)
    builders = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
                "retrieval": _colbert_cell}
    if entry.family not in builders:
        raise ValueError(f"unknown family {entry.family}")
    return builders[entry.family](entry, shape, mesh, multi_pod, variant,
                                  backend)


# ---------------------------------------------------------------------------
# Real arguments
# ---------------------------------------------------------------------------

def _init_model(model, generator, device):
    """A model of ``model``'s class and config drawn by its family's
    init from ``generator`` on ``device``."""
    cfg = model.cfg
    if isinstance(model, colbert_lib.ColBERT):
        return colbert_lib.init_params(generator, cfg, device)
    if isinstance(model, gnn_lib.GIN):
        return gnn_lib.init_params(generator, cfg, device)
    if isinstance(model, tfm.Transformer):
        return tfm.init_params(generator, cfg, device)
    return recsys_lib.init_model(generator, cfg, device)


def _graph(draw, generator, device):
    """A GNN batch at the cell's sizes: ``synthetic_graph``'s features,
    edges and labels (molecules: one small graph a block of nodes), the
    edges padded to the cell's multiple of 512 with masked edges to
    node 0; label mask all true."""
    _, shape_id, n_nodes, e, d_feat, n_classes, g_nodes, g_edges, nb = draw
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))
    if shape_id == "molecule":
        gs = [graph_sampler.synthetic_graph(seed + i, g_nodes, g_edges,
                                            d_feat, n_classes)
              for i in range(nb)]
        x = torch.cat([torch.as_tensor(g.x) for g in gs])
        ei = torch.cat([torch.as_tensor(g.edge_index) + i * g_nodes
                        for i, g in enumerate(gs)], dim=1)
        labels = torch.as_tensor([int(g.labels[0]) for g in gs],
                                 dtype=I32)
        extra = {"graph_ids": torch.arange(nb, dtype=I32).repeat_interleave(
            g_nodes)}
    else:
        g = graph_sampler.synthetic_graph(seed, n_nodes, e, d_feat,
                                          n_classes)
        x, ei = torch.as_tensor(g.x), torch.as_tensor(g.edge_index)
        labels, extra = torch.as_tensor(g.labels), {}
    e_pad = -(-e // 512) * 512
    mask = torch.zeros((e_pad,), dtype=torch.bool)
    mask[:e] = True
    ei = torch.cat([ei, torch.zeros((2, e_pad - e), dtype=ei.dtype)], dim=1)
    batch = {"x": x, "edge_index": ei.to(I32), "edge_mask": mask,
             "labels": labels.to(I32),
             "label_mask": torch.ones((labels.shape[0],)), **extra}
    return {k: v.to(device) for k, v in batch.items()}


def _draw(t, draw, generator, device):
    shape = tuple(t.shape)
    kind = draw[0] if draw else None
    if kind == "ids":
        return torch.randint(draw[1], draw[2], shape, generator=generator,
                             device=device, dtype=t.dtype)
    if kind == "zeros" or (kind is None and not t.is_floating_point()
                           and t.dtype != torch.bool):
        return torch.zeros(shape, dtype=t.dtype, device=device)
    if t.dtype == torch.bool:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if kind == "bernoulli":
        return (torch.rand(shape, generator=generator, device=device)
                < 0.3).to(t.dtype)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    if kind == "unit":
        x = x / x.norm(dim=-1, keepdim=True)
    return x.to(t.dtype)


def _real(x, path, draws, generator, device):
    if path in draws and draws[path][0] == "graph":
        return _graph(draws[path], generator, device)
    if _is_state(x):
        return train_step.make_train_state(
            _init_model(x["params"], generator, device).train())
    if isinstance(x, nn.Module):
        return _init_model(x, generator, device).eval()
    if isinstance(x, torch.Tensor):
        return _draw(x, draws.get(path), generator, device)
    if isinstance(x, dict):
        return {k: _real(v, path + (k,), draws, generator, device)
                for k, v in x.items()}
    return x


def materialize(cell: Cell, device=None, generator=None) -> Cell:
    """The cell with real arguments on ``device`` (``cuda`` unless the
    caller passes another; raises without a GPU): models and train
    states by their families' inits (moments zero, step 0), token and
    item ids uniform in their ranges, masks all true, the KV cache zero,
    embeddings and samples on the unit sphere where the cell scores
    them, other floats N(0, 1), GNN batches from ``synthetic_graph`` at
    the shape's sizes.  Everything is drawn from ``generator`` (seed 0
    on ``device`` by default)."""
    if cell.skip:
        return cell
    device = backend_lib.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    args = tuple(_real(a, (i,), cell.draws, generator, device)
                 for i, a in enumerate(cell.args))
    return dataclasses.replace(cell, args=args)
