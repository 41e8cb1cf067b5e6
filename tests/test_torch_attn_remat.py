"""Chunk remat in the port's plain attention (``remat_attn_chunk``, the
reference's ``remat_chunk``): each query chunk of the blocked attention
runs under ``torch.utils.checkpoint`` while autograd records, nested in
the block's checkpoint, and recomputes the same arithmetic, so a smoke
LM's loss and every gradient are bit-equal with the flag on and off.
Under ``torch.no_grad`` (prefill, serving) no chunk is checkpointed.
"""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.models import attention
from repro_torch.models import transformer as tfm
from repro_torch.train import train_step


def _model(arch, flag):
    cfg = dataclasses.replace(configs.get(arch).smoke, attn_chunk=4,
                              remat=True, remat_attn_chunk=flag)
    return tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")


@pytest.mark.parametrize("arch", ["minitron-4b", "granite-moe-3b-a800m",
                                  "mixtral-8x7b"])
def test_loss_and_gradients_bit_equal(arch, monkeypatch):
    tokens = torch.randint(0, configs.get(arch).smoke.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    calls = []
    real = attention.checkpoint
    monkeypatch.setattr(attention, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for flag in (False, True):
        model = _model(arch, flag).train()
        total, _, _ = train_step.lm_loss_fn(model, tokens)
        out[flag] = (total, train_step.param_grads(model, total))
    # 4 chunks a layer, checkpointed only with the flag, in the block's
    # forward and again in its recomputation (remat)
    assert len(calls) == 2 * 4 * configs.get(arch).smoke.n_layers
    assert torch.equal(out[False][0], out[True][0])
    for name, g in out[False][1].items():
        assert torch.equal(g, out[True][1][name]), name


def test_no_checkpoint_without_autograd(monkeypatch):
    monkeypatch.setattr(attention, "checkpoint", None)   # would raise
    tokens = torch.randint(0, 256, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        on = _model("minitron-4b", True)(tokens, backend="reference")
        off = _model("minitron-4b", False)(tokens, backend="reference")
    assert torch.equal(on, off)
