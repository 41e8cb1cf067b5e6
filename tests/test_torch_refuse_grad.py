"""Training reaches no kernel of the port: neither package has a backward
kernel, so the B7 and B8 wrappers refuse an input that requires grad
where they would launch (``kernels.build.refuse_grad``), and the train
steps run the plain path.  No JAX here: the ``cuda`` cases run on the
card, where a CTR and a BERT4Rec step at the smoke configs launch no
kernel and give every matrix a nonzero gradient, and the serve steps
launch B8 and B7 as the forward path does.
"""

import pytest
import torch

from repro_torch.configs import bert4rec, dlrm_rm2
from repro_torch.data import synthetic
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.kernels.flash_attention.ops import flash_attention_op
from repro_torch.models import recsys
from repro_torch.train import optimizer, train_step


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    return torch.device("cuda")


def test_embedding_bag_refuses_an_input_that_requires_grad():
    """A launch would cut the graph; a tensor off the CPU that requires
    grad raises before any launch."""
    table = torch.zeros((8, 4), device="meta", requires_grad=True)
    ids = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="backend='reference'"):
        embedding_bag_op(table, ids)
    with torch.no_grad(), pytest.raises(ValueError, match="cpu or cuda"):
        embedding_bag_op(table, ids)
    # the plain version on the CPU is differentiable
    t = torch.randn((8, 4), requires_grad=True)
    embedding_bag_op(t, torch.tensor([[1, 1]], dtype=torch.int32)).sum(
    ).backward()
    assert t.grad[1].eq(2).all() and t.grad[0].eq(0).all()


def test_flash_attention_refuses_an_input_that_requires_grad():
    q = torch.zeros((1, 2, 8, 8), device="meta", requires_grad=True)
    k = torch.zeros((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="backend='reference'"):
        flash_attention_op(q, k, k)
    with torch.no_grad(), pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_op(q, k, k)


@pytest.mark.cuda
def test_wrappers_refuse_on_the_card():
    dev = _card()
    table = torch.zeros((8, 4), device=dev, requires_grad=True)
    ids = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        embedding_bag_op(table, ids)
    q = torch.zeros((1, 2, 8, 32), device=dev, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        flash_attention_op(q, q.detach(), q.detach())
    with torch.no_grad():                         # serving still launches
        n = embedding_bag_op.launches
        embedding_bag_op(table, ids)
        assert embedding_bag_op.launches == n + 1


def _launches():
    return embedding_bag_op.launches, flash_attention_op.launches


@pytest.mark.cuda
def test_ctr_step_on_the_card_launches_nothing():
    dev = _card()
    cfg = dlrm_rm2.SMOKE
    model = recsys.init_model(torch.Generator(device=dev).manual_seed(0),
                              cfg, dev)
    b = synthetic.ctr_batch(0, 0, 64, cfg.n_dense, cfg.n_sparse,
                            cfg.table_rows, device=dev)
    before = _launches()
    grads = train_step.param_grads(
        model, train_step.ctr_loss(recsys.ctr_forward, model, b))
    state, m = train_step.ctr_train_step(
        recsys.ctr_forward, optimizer.AdamWConfig())(
        train_step.make_train_state(model), b)
    assert _launches() == before
    assert torch.isfinite(m["loss"])
    for name, g in grads.items():
        if g.dim() == 2:
            assert bool(g.ne(0).any()), name
    p = train_step.ctr_serve_step(recsys.ctr_forward, backend="fused")(
        model, b)
    assert _launches()[0] == before[0] + 1 and p.shape == (64,)


@pytest.mark.cuda
def test_bert4rec_sampled_step_on_the_card_launches_nothing():
    dev = _card()
    cfg = bert4rec.SMOKE
    model = recsys.bert4rec_init(torch.Generator(device=dev).manual_seed(0),
                                 cfg, dev)
    b = synthetic.bert4rec_sampled_batch(0, 0, 8, cfg.seq_len, cfg.n_items,
                                         device=dev)
    before = _launches()
    grads = train_step.param_grads(
        model, train_step.bert4rec_sampled_loss(cfg, model, b))
    train_step.bert4rec_sampled_train_step(cfg, optimizer.AdamWConfig())(
        train_step.make_train_state(model), b)
    assert _launches() == before
    for name, g in grads.items():
        if g.dim() == 2:
            assert bool(g.ne(0).any()), name
    with torch.no_grad():
        recsys.bert4rec_user_vectors(model, cfg, b["items"], backend="fused")
    assert _launches()[1] == before[1] + cfg.n_blocks
