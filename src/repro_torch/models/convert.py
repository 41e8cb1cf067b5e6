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

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_jax(tree) -> dict[str, torch.Tensor]:
    layers = tree["layers"]
    attn, ffn = layers["attn"], layers["ffn"]
    sd = {"embed.weight": _tensor(tree["embed"]),
          "ln_f": _tensor(tree["ln_f"])}
    if tree.get("lm_head") is not None:
        sd["lm_head.weight"] = _tensor(tree["lm_head"]).T.contiguous()
    n_layers = np.asarray(layers["ln1"]).shape[0]
    for i in range(n_layers):
        p = f"layers.{i}."
        sd[p + "ln1"] = _tensor(np.asarray(layers["ln1"])[i])
        sd[p + "ln2"] = _tensor(np.asarray(layers["ln2"])[i])
        for name in ("wq", "wk", "wv", "wo"):
            sd[p + f"attn.{name}.weight"] = _tensor(
                np.asarray(attn[name])[i]).T.contiguous()
        for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
            if attn.get(b) is not None:
                sd[p + f"attn.{w}.bias"] = _tensor(np.asarray(attn[b])[i])
        for name in ("w_gate", "w_up", "w_down"):
            sd[p + f"{name}.weight"] = _tensor(
                np.asarray(ffn[name])[i]).T.contiguous()
    return sd


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    sd = {f"backbone.{k}": t
          for k, t in lm_params_from_jax(tree["backbone"]).items()}
    sd["proj.weight"] = _tensor(tree["proj"]).T.contiguous()
    return sd


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
