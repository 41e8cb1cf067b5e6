"""Carry the JAX reference's ColBERT weights into the port.

``params_from_jax(tree)`` takes the tree ``repro.models.colbert.
init_params`` returns — nested dicts of arrays, converted to numpy by
the caller — and returns a ``state_dict`` for
``repro_torch.models.colbert.ColBERT``.  Layouts:

* ``backbone.embed`` (vocab, d_model) -> ``backbone.embed.weight``,
  unchanged.  The reference ties its LM head to this table; the encoder
  never uses the head, so nothing else reads it.
* ``backbone.layers`` is stacked on a leading (n_layers,) axis for
  ``lax.scan``; layer i becomes ``backbone.layers.{i}``.
* Every matrix is (in, out) in the reference (``x @ W``) and
  (out, in) in ``nn.Linear``, so each is transposed:
  ``attn.{wq,wk,wv}`` (d_model, heads*head_dim), ``attn.wo``
  (heads*head_dim, d_model), ``ffn.{w_gate,w_up}`` (d_model, d_ff) ->
  ``w_gate``/``w_up``, ``ffn.w_down`` (d_ff, d_model) -> ``w_down``,
  ``proj`` (d_model, out_dim) -> ``proj.weight`` (out_dim, d_model).
* ``ln1``/``ln2`` (d_model,) per layer and ``ln_f`` stay vectors.
* ``None`` leaves (the absent q/k/v biases) are skipped.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # numpy has no bf16: widen exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    bb = tree["backbone"]
    layers = bb["layers"]
    attn, ffn = layers["attn"], layers["ffn"]
    sd = {"backbone.embed.weight": _tensor(bb["embed"]),
          "backbone.ln_f": _tensor(bb["ln_f"]),
          "proj.weight": _tensor(tree["proj"]).T.contiguous()}
    n_layers = np.asarray(layers["ln1"]).shape[0]
    for i in range(n_layers):
        p = f"backbone.layers.{i}."
        sd[p + "ln1"] = _tensor(np.asarray(layers["ln1"])[i])
        sd[p + "ln2"] = _tensor(np.asarray(layers["ln2"])[i])
        for name in ("wq", "wk", "wv", "wo"):
            sd[p + f"attn.{name}.weight"] = _tensor(
                np.asarray(attn[name])[i]).T.contiguous()
        for name in ("w_gate", "w_up", "w_down"):
            sd[p + f"{name}.weight"] = _tensor(
                np.asarray(ffn[name])[i]).T.contiguous()
    return sd
