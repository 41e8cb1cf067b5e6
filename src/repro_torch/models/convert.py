"""Carry the JAX reference's weights into the port.

``lm_params_from_jax(tree)`` takes the tree ``repro.models.transformer.
init_params`` returns, and ``params_from_jax(tree)`` the tree of
``repro.models.colbert.init_params`` — nested dicts of arrays, converted
to numpy by the caller — and each returns a ``state_dict`` for
``repro_torch.models.transformer.Transformer`` or
``repro_torch.models.colbert.ColBERT``.  Layouts:

* ``embed`` (vocab, d_model) -> ``embed.weight``, unchanged.
* ``layers`` is stacked on a leading (n_layers,) axis for ``lax.scan``;
  layer i becomes ``layers.{i}``.
* Every matrix is (in, out) in the reference (``x @ W``) and
  (out, in) in ``nn.Linear``, so each is transposed:
  ``attn.{wq,wk,wv}`` (d_model, heads*head_dim), ``attn.wo``
  (heads*head_dim, d_model), ``ffn.{w_gate,w_up}`` (d_model, d_ff) ->
  ``w_gate``/``w_up``, ``ffn.w_down`` (d_ff, d_model) -> ``w_down``,
  ``lm_head`` (d_model, vocab) -> ``lm_head.weight``, ColBERT's ``proj``
  (d_model, out_dim) -> ``proj.weight``.
* The q/k/v biases ``attn.{bq,bk,bv}`` -> ``attn.{wq,wk,wv}.bias`` when
  present; ``None`` leaves (no QKV bias) are skipped.
* ``lm_head`` is absent when the embeddings are tied: the head is then
  ``embed.T`` in both packages.
* ``ln1``/``ln2`` (d_model,) per layer and ``ln_f`` stay vectors.
* An MoE layer's ``moe.{router,w_gate,w_up,w_down}`` (router (d_model,
  E) fp32, experts (E, in, out)) -> ``layers.{i}.moe.{...}``, in the
  reference's layout, not transposed; such a layer has no ``ffn``.

``params_to_jax(sd, family)`` is the inverse of ``params_from_jax(tree,
family)``: it takes a state_dict of the family's model, or any dict of
tensors under its names (AdamW's moments), and returns the reference's
nested dict of tensors (layers stacked, matrices (in, out), tables
(F, V, D)), so the port's train state is written under the reference's
leaf names and layouts.  ``jax_ranks(sd, family)`` gives each entry's
rank in that tree (the optimizer's decay rule reads it: the reference
decays every leaf of rank >= 2), and ``jax_place(name, family)`` where
it lives there.  The families (``family_of(model)``): ``"colbert"``
(``ColBERT``, the default), ``"lm"`` (``Transformer``: the LM family,
dense and MoE — an MoE layer's router is rank 3 there and its experts
rank 4, so both decay — and BERT4Rec, whose tree is the LM tree with
tied embeddings and no ``lm_head``), and ``"dlrm-rm2"``, ``"dcn-v2"``, ``"wide-deep"``
(``DLRM``, ``DCN``, ``WideDeep``).

``recsys_params_from_jax(tree, arch_id)`` takes the tree of
``repro.models.recsys.dlrm_init``, ``dcn_init`` or ``widedeep_init``
(``arch_id`` "dlrm-rm2", "dcn-v2" or "wide-deep") and returns a
``state_dict`` for ``repro_torch.models.recsys.DLRM``, ``DCN`` or
``WideDeep``:

* ``tables`` (F, V, D) -> the stacked (F·V, D); W&D's ``wide`` (F, V)
  -> (F·V, 1).
* MLP layer i of ``bot``/``top``/``mlp`` (``ws[i]`` (in, out), ``bs[i]``)
  -> ``{bot,top,mlp}.{i}.weight`` (out, in) and ``.bias``; DCN's cross
  layer i (``w`` (d, d), ``b``) -> ``cross.{i}.weight`` (transposed)
  and ``.bias``; W&D's scalar ``bias`` stays a scalar.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _layer(a, i) -> torch.Tensor:
    """Layer i of a stacked (n_layers, ...) leaf."""
    return a[i] if isinstance(a, torch.Tensor) else _tensor(np.asarray(a)[i])


def lm_params_from_jax(tree) -> dict[str, torch.Tensor]:
    layers = tree["layers"]
    attn, ffn, moe = layers["attn"], layers.get("ffn"), layers.get("moe")
    sd = {"embed.weight": _tensor(tree["embed"]),
          "ln_f": _tensor(tree["ln_f"])}
    if tree.get("lm_head") is not None:
        sd["lm_head.weight"] = _tensor(tree["lm_head"]).T.contiguous()
    n_layers = layers["ln1"].shape[0]
    for i in range(n_layers):
        p = f"layers.{i}."
        sd[p + "ln1"] = _layer(layers["ln1"], i)
        sd[p + "ln2"] = _layer(layers["ln2"], i)
        for name in ("wq", "wk", "wv", "wo"):
            sd[p + f"attn.{name}.weight"] = _layer(attn[name],
                                                   i).T.contiguous()
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            if attn.get(b) is not None:
                sd[p + f"attn.{w}.bias"] = _layer(attn[b], i)
        for name in ("w_gate", "w_up", "w_down"):
            if ffn is not None:
                sd[p + f"{name}.weight"] = _layer(ffn[name], i).T.contiguous()
            else:
                sd[p + f"moe.{name}"] = _layer(moe[name], i)
        if moe is not None:
            sd[p + "moe.router"] = _layer(moe["router"], i)
    return sd


def params_from_jax(tree, family: str = "colbert") -> dict[str, torch.Tensor]:
    """The reference's tree of ``family`` (module docstring) -> a
    state_dict of the port's model."""
    if family in _RECSYS_MLPS:
        return recsys_params_from_jax(tree, family)
    if family == "lm":
        return lm_params_from_jax(tree)
    _check_family(family)
    sd = {f"backbone.{k}": t
          for k, t in lm_params_from_jax(tree["backbone"]).items()}
    sd["proj.weight"] = _tensor(tree["proj"]).T.contiguous()
    return sd


_LAYER_LEAF = re.compile(r"layers\.(\d+)\.(.+)")
_LAYER_PATHS = {"ln1": ("ln1",), "ln2": ("ln2",),
                "attn.wq.weight": ("attn", "wq"),
                "attn.wk.weight": ("attn", "wk"),
                "attn.wv.weight": ("attn", "wv"),
                "attn.wo.weight": ("attn", "wo"),
                "attn.wq.bias": ("attn", "bq"),
                "attn.wk.bias": ("attn", "bk"),
                "attn.wv.bias": ("attn", "bv"),
                "w_gate.weight": ("ffn", "w_gate"),
                "w_up.weight": ("ffn", "w_up"),
                "w_down.weight": ("ffn", "w_down"),
                "moe.router": ("moe", "router"),
                "moe.w_gate": ("moe", "w_gate"),
                "moe.w_up": ("moe", "w_up"),
                "moe.w_down": ("moe", "w_down")}
_LM_TOP = {"embed.weight": ("embed",), "ln_f": ("ln_f",),
           "lm_head.weight": ("lm_head",)}
_RECSYS_MLPS = {"dlrm-rm2": ("bot", "top"), "dcn-v2": ("mlp",),
                "wide-deep": ("mlp",)}
FAMILIES = ("colbert", "lm") + tuple(_RECSYS_MLPS)
_RECSYS_LEAF = re.compile(r"(bot|top|mlp|cross)\.(\d+)\.(weight|bias)")
_RECSYS_TOP = {"tables": ("tables",), "wide": ("wide",), "bias": ("bias",)}


def _check_family(family: str) -> None:
    if family not in FAMILIES:
        raise KeyError(f"no parameter layout for family {family!r}; have "
                       f"{list(FAMILIES)}")


def family_of(model) -> str:
    """The layout family of a port model (module docstring)."""
    from repro_torch.models import colbert, recsys, transformer
    for cls, family in ((colbert.ColBERT, "colbert"),
                        (transformer.Transformer, "lm"),
                        (recsys.DLRM, "dlrm-rm2"), (recsys.DCN, "dcn-v2"),
                        (recsys.WideDeep, "wide-deep")):
        if isinstance(model, cls):
            return family
    raise TypeError(f"no parameter layout for {type(model).__name__}")


def _lm_place(name: str, prefix: tuple[str, ...] = ()):
    m = _LAYER_LEAF.fullmatch(name)
    transposed = name.endswith(".weight") and name != "embed.weight"
    if m:
        return (prefix + ("layers",) + _LAYER_PATHS[m.group(2)],
                int(m.group(1)), transposed)
    return prefix + _LM_TOP[name], None, transposed


def jax_place(name: str, family: str = "colbert"
              ) -> tuple[tuple, int | None, bool]:
    """Where a state_dict entry of ``family``'s model lives in the
    reference's tree: (key path, layer index on the stacked axis or
    None, whether the reference holds it transposed: every matrix but
    the embeddings and tables).  A recsys path holds an int where the
    reference has a tuple (an MLP's ``ws``/``bs``, DCN's ``cross``)."""
    _check_family(family)
    if family == "lm":
        return _lm_place(name)
    if family == "colbert":
        if name == "proj.weight":
            return ("proj",), None, True
        if not name.startswith("backbone."):
            raise KeyError(name)
        return _lm_place(name[len("backbone."):], ("backbone",))
    if name in _RECSYS_TOP:
        return _RECSYS_TOP[name], None, False
    m = _RECSYS_LEAF.fullmatch(name)
    if not m:
        raise KeyError(name)
    group, i, kind = m.group(1), int(m.group(2)), m.group(3)
    if group == "cross":
        return ("cross", i, "w" if kind == "weight" else "b"), None, \
            kind == "weight"
    return (group, "ws" if kind == "weight" else "bs", i), None, \
        kind == "weight"


def jax_ranks(sd: dict[str, torch.Tensor], family: str = "colbert"
              ) -> dict[str, int]:
    """Each entry's rank in the reference's tree: one more than its own
    for a layer's entry (the reference stacks layers on a leading axis)
    and for the stacked (F·V, D) tables, which are (F, V, D) there
    (W&D's (F·V, 1) wide table is (F, V), rank 2 in both)."""
    _check_family(family)
    if family in _RECSYS_MLPS:
        return {n: t.dim() + (n == "tables") for n, t in sd.items()}
    return {n: t.dim() + (jax_place(n, family)[1] is not None)
            for n, t in sd.items()}


def params_to_jax(sd: dict[str, torch.Tensor], family: str = "colbert", *,
                  n_features: int | None = None) -> dict:
    """The inverse of :func:`params_from_jax`: a state_dict of
    ``family``'s model (or any dict of tensors under its names, such as
    AdamW's moments) -> the reference's nested dict, layers stacked on a
    leading axis, matrices (in, out), a recsys model's tables (F, V, D)
    and W&D's wide table (F, V) for ``n_features`` = F.  Stacked and
    transposed leaves are new tensors; the others are the entries
    themselves (or views of them), detached."""
    if family in _RECSYS_MLPS and not n_features:
        raise ValueError(f"{family}: the tables' feature count is needed")
    tree: dict = {}
    stacks: dict[tuple, dict[int, torch.Tensor]] = {}
    for name, t in sd.items():
        path, layer, transposed = jax_place(name, family)
        t = t.detach()
        if transposed:
            t = t.T.contiguous()
        if name == "tables":
            t = t.view(n_features, -1, t.shape[-1])
        elif name == "wide":
            t = t.view(n_features, -1)
        if layer is None:
            _put(tree, path, t)
        else:
            stacks.setdefault(path, {})[layer] = t
    for path, by_layer in stacks.items():
        _put(tree, path, torch.stack([by_layer[i]
                                      for i in range(len(by_layer))]))
    return _tuples(tree)


def _put(tree: dict, path: tuple, leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _tuples(tree):
    """Dicts keyed 0..n-1 by int (the recsys paths' tuple positions) ->
    tuples, as the reference holds them."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _tuples(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return tuple(out[i] for i in range(len(out)))
    return out


def recsys_params_from_jax(tree, arch_id: str) -> dict[str, torch.Tensor]:
    if arch_id not in _RECSYS_MLPS:
        raise KeyError(f"no recsys model for arch {arch_id!r}; have "
                       f"{sorted(_RECSYS_MLPS)}")
    tables = _tensor(tree["tables"])
    sd = {"tables": tables.reshape(-1, tables.shape[-1])}
    for name in _RECSYS_MLPS[arch_id]:
        for i, (w, b) in enumerate(zip(tree[name]["ws"], tree[name]["bs"])):
            sd[f"{name}.{i}.weight"] = _tensor(w).T.contiguous()
            sd[f"{name}.{i}.bias"] = _tensor(b)
    for i, layer in enumerate(tree.get("cross", ())):
        sd[f"cross.{i}.weight"] = _tensor(layer["w"]).T.contiguous()
        sd[f"cross.{i}.bias"] = _tensor(layer["b"])
    if arch_id == "wide-deep":
        sd["wide"] = _tensor(tree["wide"]).reshape(-1, 1)
        sd["bias"] = _tensor(tree["bias"])
    return sd
