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

``params_to_jax(sd)`` is the inverse of ``params_from_jax``: it takes a
``ColBERT`` state_dict, or any dict of tensors under its names (AdamW's
moments), and returns the reference's nested dict of tensors, layers
stacked and matrices (in, out), so the port's train state is written
under the reference's leaf names and layouts.  ``jax_ranks(sd)`` gives
each entry's rank in that tree (the optimizer's decay rule reads it).

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
    attn, ffn = layers["attn"], layers["ffn"]
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
            sd[p + f"{name}.weight"] = _layer(ffn[name], i).T.contiguous()
    return sd


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    sd = {f"backbone.{k}": t
          for k, t in lm_params_from_jax(tree["backbone"]).items()}
    sd["proj.weight"] = _tensor(tree["proj"]).T.contiguous()
    return sd


_LAYER_LEAF = re.compile(r"backbone\.layers\.(\d+)\.(.+)")
_LAYER_PATHS = {"ln1": ("ln1",), "ln2": ("ln2",),
                "attn.wq.weight": ("attn", "wq"),
                "attn.wk.weight": ("attn", "wk"),
                "attn.wv.weight": ("attn", "wv"),
                "attn.wo.weight": ("attn", "wo"),
                "w_gate.weight": ("ffn", "w_gate"),
                "w_up.weight": ("ffn", "w_up"),
                "w_down.weight": ("ffn", "w_down")}
_TOP_PATHS = {"backbone.embed.weight": ("backbone", "embed"),
              "backbone.ln_f": ("backbone", "ln_f"),
              "proj.weight": ("proj",)}


def jax_place(name: str) -> tuple[tuple[str, ...], int | None, bool]:
    """Where a ``ColBERT`` state_dict entry lives in the reference's
    tree: (key path, layer index on the stacked axis or None, whether
    the reference holds it transposed: every matrix but the
    embeddings)."""
    transposed = name.endswith(".weight") and name != "backbone.embed.weight"
    m = _LAYER_LEAF.fullmatch(name)
    if m:
        return (("backbone", "layers") + _LAYER_PATHS[m.group(2)],
                int(m.group(1)), transposed)
    return _TOP_PATHS[name], None, transposed


def jax_ranks(sd: dict[str, torch.Tensor]) -> dict[str, int]:
    """Each entry's rank in the reference's tree: one more than its own
    for a layer's entry (the reference stacks layers on a leading
    axis)."""
    return {n: t.dim() + (jax_place(n)[1] is not None)
            for n, t in sd.items()}


def params_to_jax(sd: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`params_from_jax`: a ``ColBERT`` state_dict
    (or any dict of tensors under its names, such as AdamW's moments) ->
    the reference's nested dict, layers stacked on a leading axis and
    matrices (in, out).  Stacked and transposed leaves are new tensors;
    the others are the entries themselves, detached."""
    tree: dict = {}
    stacks: dict[tuple[str, ...], dict[int, torch.Tensor]] = {}
    for name, t in sd.items():
        path, layer, transposed = jax_place(name)
        t = t.detach()
        if transposed:
            t = t.T.contiguous()
        if layer is None:
            _put(tree, path, t)
        else:
            stacks.setdefault(path, {})[layer] = t
    for path, by_layer in stacks.items():
        _put(tree, path, torch.stack([by_layer[i]
                                      for i in range(len(by_layer))]))
    return tree


def _put(tree: dict, path: tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


_RECSYS_MLPS = {"dlrm-rm2": ("bot", "top"), "dcn-v2": ("mlp",),
                "wide-deep": ("mlp",)}


def recsys_params_from_jax(tree, arch_id: str) -> dict[str, torch.Tensor]:
    if arch_id not in _RECSYS_MLPS:
        raise KeyError(f"no recsys model for arch {arch_id!r}; have "
                       f"{sorted(_RECSYS_MLPS)}")
    tables = np.asarray(tree["tables"])
    sd = {"tables": _tensor(tables.reshape(-1, tables.shape[-1]))}
    for name in _RECSYS_MLPS[arch_id]:
        for i, (w, b) in enumerate(zip(tree[name]["ws"], tree[name]["bs"])):
            sd[f"{name}.{i}.weight"] = _tensor(w).T.contiguous()
            sd[f"{name}.{i}.bias"] = _tensor(b)
    for i, layer in enumerate(tree.get("cross", ())):
        sd[f"cross.{i}.weight"] = _tensor(layer["w"]).T.contiguous()
        sd[f"cross.{i}.bias"] = _tensor(layer["b"])
    if arch_id == "wide-deep":
        sd["wide"] = _tensor(np.asarray(tree["wide"]).reshape(-1, 1))
        sd["bias"] = _tensor(tree["bias"])
    return sd
