"""The MoE FFN of the PyTorch port against the JAX reference:
``models.moe.moe_ffn`` (blocking, capacity and drops, the router's ties,
the combine order, the aux losses) and its gradients, from the same
numpy inputs and the reference's ``init_moe`` weights.

Routing is discontinuous: a near-tie between the k-th and (k+1)-th
router choice may go either way when the two packages' logits differ
in the last bits.  Every fixture here asserts that the gap between the
k-th and (k+1)-th router logit (the probabilities' order) exceeds
``GAP_TOL`` wherever it compares outputs (no fixture was re-seeded to
pass it), except the tie case, whose ties are exact and must go to the
lowest expert id in both packages.

Tolerances: fp32 outputs within 1e-5 abs (the router and expert
products sum in other orders); aux losses within 1e-6 abs + 1e-6
relative (router_z, a mean of squared log-sum-exps of ~5, sums in
another order); bf16 outputs
within one bf16 rounding, 2^-7 relative (bit-equal on the hosts this
was written on: the products round once from fp32 and the SiLU and the
combine round op by op as the reference's HLO does); gradients within
1e-5 abs + 1e-4 relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro_torch.models import moe

ATOL = 1e-5
AUX_ATOL, AUX_RTOL = 1e-6, 1e-6
BF16_RTOL = 2 ** -7
GAP_TOL = 1e-5
G_ATOL, G_RTOL = 1e-5, 1e-4
LEAVES = ("router", "w_gate", "w_up", "w_down")
J_MOE = jax.jit(j_moe.moe_ffn,
                static_argnames=("top_k", "capacity_factor", "block_tokens"))


def _pair(seed, D, F, E, dtype=jnp.float32):
    p = j_moe.init_moe(jax.random.PRNGKey(seed), D, F, E, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    m = moe.MoE(D, F, E, tdt)
    m.load_state_dict({n: torch.from_numpy(np.array(
        getattr(p, n), np.float32)).to(getattr(m, n).dtype) for n in LEAVES})
    return p, m


def _x(seed, B, S, D):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


def _min_gap(m, x, k, block_tokens=2048):
    """The least gap between the k-th and (k+1)-th router logit over the
    tokens of x (the port's router).  Softmax keeps the order, so this
    is the margin of the top-k choice in the units the packages differ
    in; a probability gap shrinks with the probabilities and says
    nothing once they saturate."""
    B, S, D = x.shape
    nb = moe.n_blocks(B * S, block_tokens)
    logits, _, _, _ = moe.route(m, x.reshape(nb, -1, D), k)
    top = torch.sort(logits, dim=-1, descending=True).values
    return float((top[..., k - 1] - top[..., k]).min())


# name: (B, S, D, F, E, k, capacity_factor, block_tokens)
CASES = {
    "one_block": (2, 32, 64, 32, 8, 2, 1.25, 2048),
    "blocks": (2, 32, 64, 32, 8, 2, 1.25, 16),         # T 64 -> 4 blocks
    "blocks_drops": (2, 32, 64, 32, 8, 2, 0.5, 16),
    "one_block_drops": (2, 32, 64, 32, 8, 2, 0.5, 2048),
    "granite_smoke": (2, 16, 64, 32, 8, 2, 1.25, 2048),
    "mixtral_smoke": (2, 16, 64, 128, 4, 2, 1.25, 2048),
    "top3_blocks": (4, 16, 48, 24, 6, 3, 1.0, 32),
}


def _run_both(case, dtype=jnp.float32, seed=0):
    B, S, D, F, E, k, cf, bt = CASES[case]
    p, m = _pair(seed, D, F, E, dtype)
    x = _x(seed + 1, B, S, D)
    y, aux = J_MOE(p, jnp.asarray(x, dtype), top_k=k,
                           capacity_factor=cf, block_tokens=bt)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tx = torch.from_numpy(x).to(tdt)
    with torch.no_grad():
        ty, taux = moe.moe_ffn(m, tx, top_k=k, capacity_factor=cf,
                               block_tokens=bt)
        gap = _min_gap(m, tx, k, bt)
    return (np.asarray(y.astype(jnp.float32)), aux, ty, taux, gap, m, tx)


class TestMoeFfn:
    @pytest.mark.parametrize("case", list(CASES))
    def test_fp32_matches_jax(self, case):
        want, aux, got, taux, gap, m, tx = _run_both(case)
        assert gap > GAP_TOL, gap            # routing cannot flip
        assert got.dtype == torch.float32 and got.shape == tx.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        for name in ("load_balance", "router_z"):
            np.testing.assert_allclose(float(taux[name]), float(aux[name]),
                                       atol=AUX_ATOL, rtol=AUX_RTOL,
                                       err_msg=name)

    @pytest.mark.parametrize("case", ["blocks_drops", "one_block_drops"])
    def test_drops_happen_and_match(self, case):
        """At capacity factor 0.5 entries are dropped (the earliest tokens
        of a block keep their experts); a token whose every entry was
        dropped passes nothing, in both packages."""
        B, S, D, F, E, k, cf, bt = CASES[case]
        want, _, got, _, _, m, tx = _run_both(case)
        nb = moe.n_blocks(B * S, bt)
        tb = B * S // nb
        cap = moe.capacity(tb, k, E, cf)
        _, _, ids, _ = moe.route(m, tx.reshape(nb, tb, D), k)
        _, _, slot, counts = moe.dispatch(ids, E, cap)
        dropped = slot >= cap
        assert bool(dropped.any()) and int(counts.max()) > cap
        # within an expert, kept slots are the earliest tokens: a dropped
        # entry's token comes after every kept one of its expert
        for b in range(nb):
            for e in range(E):
                at = (ids[b] == e)
                toks = at.any(-1).nonzero()[:, 0]
                kept = slot[b][at] < cap
                assert bool(kept[:cap].all()) and not bool(kept[cap:].any())
                assert toks.numel() == int(counts[b, e])
        none_kept = dropped.reshape(B * S, k).all(-1)
        if bool(none_kept.any()):
            rows = got.reshape(B * S, D)[none_kept]
            assert bool(rows.eq(0).all())
            assert np.all(want.reshape(B * S, D)[none_kept.numpy()] == 0)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("case", ["one_block", "blocks_drops",
                                      "granite_smoke", "mixtral_smoke"])
    def test_bf16_matches_jax(self, case):
        want, aux, got, taux, gap, *_ = _run_both(case, jnp.bfloat16)
        assert gap > GAP_TOL, gap
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL, atol=1e-6)
        for name in ("load_balance", "router_z"):
            np.testing.assert_allclose(float(taux[name]), float(aux[name]),
                                       atol=AUX_ATOL, rtol=AUX_RTOL,
                                       err_msg=name)

    def test_ties_go_to_the_lowest_expert(self):
        """A zero router gives every expert the same probability: the
        top-k are experts 0..k-1 in both packages, every token lands on
        them, and the capacity cascade drops the later tokens."""
        B, S, D, F, E, k = 2, 16, 32, 16, 8, 3
        p, m = _pair(3, D, F, E)
        p = p._replace(router=jnp.zeros_like(p.router))
        with torch.no_grad():
            m.router.zero_()
        x = _x(4, B, S, D)
        y, aux = J_MOE(p, jnp.asarray(x), top_k=k)
        logits = jnp.asarray(x).reshape(1, B * S, D) @ p.router
        _, j_ids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
        tx = torch.from_numpy(x)
        with torch.no_grad():
            _, _, ids, gates = moe.route(m, tx.reshape(1, B * S, D), k)
            got, taux = moe.moe_ffn(m, tx, top_k=k)
        assert np.array_equal(np.asarray(j_ids[0]),
                              np.broadcast_to(np.arange(k), (B * S, k)))
        assert torch.equal(ids[0], torch.arange(k).expand(B * S, k))
        torch.testing.assert_close(gates, torch.full_like(gates, 1 / k))
        cap = moe.capacity(B * S, k, E, 1.25)
        assert cap < B * S            # later tokens are dropped
        assert bool(got.reshape(B * S, D)[cap:].eq(0).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(y), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(float(taux["load_balance"]),
                                   float(aux["load_balance"]),
                                   atol=AUX_ATOL)

    def test_decode_drops_a_second_token(self):
        """Decode: batch 2, one token each, so one block of 2 and capacity
        ceil(1.25 * 2 * 2 / 8) = 1.  Both tokens' first choice is expert
        3: the first token keeps it, the second's entry is dropped (the
        reference's behaviour), and its output is its other expert's
        term alone."""
        B, D, F, E, k = 2, 32, 16, 8, 2
        p, m = _pair(5, D, F, E)
        x = _x(6, B, 1, D)
        rng = np.random.default_rng(7)
        router = 0.05 * rng.standard_normal((D, E)).astype(np.float32)
        router[:, 3] += 0.1 * (x[0, 0] + x[1, 0])
        p = p._replace(router=jnp.asarray(router))
        with torch.no_grad():
            m.router.copy_(torch.from_numpy(router))
        assert moe.capacity(B, k, E, 1.25) == 1
        y, aux = J_MOE(p, jnp.asarray(x), top_k=k)
        tx = torch.from_numpy(x)
        with torch.no_grad():
            got, taux = moe.moe_ffn(m, tx, top_k=k)
            _, _, ids, gates = moe.route(m, tx.reshape(1, B, D), k)
            _, _, slot, counts = moe.dispatch(ids, E, 1)
            assert _min_gap(m, tx, k) > GAP_TOL
        assert ids[0, :, 0].tolist() == [3, 3]
        assert slot[0, :, 0].tolist() == [0, 1]       # second token dropped
        assert int(counts[0, 3]) == 2
        # token 1: only its second expert's term, times its gate
        e2 = int(ids[0, 1, 1])
        assert int(slot[0, 1, 1]) == 0 and e2 != int(ids[0, 0, 1])
        with torch.no_grad():
            xe = tx[1, 0]
            h = moe.silu(xe @ m.w_gate[e2]) * (xe @ m.w_up[e2])
            alone = (h @ m.w_down[e2]) * gates[0, 1, 1]
        torch.testing.assert_close(got[1, 0], alone, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(y), atol=ATOL,
                                   rtol=0)
        np.testing.assert_allclose(float(taux["router_z"]),
                                   float(aux["router_z"]), atol=AUX_ATOL)

    @pytest.mark.parametrize("case", ["blocks_drops", "granite_smoke"])
    def test_gradients_match_jax(self, case):
        """d/d(x, router, experts) of sum(y * w) + load_balance +
        router_z against ``jax.grad``."""
        B, S, D, F, E, k, cf, bt = CASES[case]
        p, m = _pair(8, D, F, E)
        x = _x(9, B, S, D)
        w = np.random.default_rng(10).standard_normal((B, S, D)).astype(
            np.float32)

        def j_loss(p, x):
            y, aux = j_moe.moe_ffn(p, x, top_k=k, capacity_factor=cf,
                                   block_tokens=bt)
            return (jnp.sum(y * w) + aux["load_balance"]
                    + aux["router_z"])

        jg_p, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
            p, jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_(True)
        y, aux = moe.moe_ffn(m, tx, top_k=k, capacity_factor=cf,
                             block_tokens=bt)
        loss = (y * torch.from_numpy(w)).sum() + aux["load_balance"] \
            + aux["router_z"]
        names = list(LEAVES)
        grads = torch.autograd.grad(loss, [getattr(m, n) for n in names]
                                    + [tx])
        with torch.no_grad():
            assert _min_gap(m, tx, k, bt) > GAP_TOL
        for n, g in zip(names + ["x"], grads):
            want = np.asarray(jg_x if n == "x" else getattr(jg_p, n))
            assert np.abs(want).max() > 0, n
            np.testing.assert_allclose(g.numpy(), want, atol=G_ATOL,
                                       rtol=G_RTOL, err_msg=n)

    def test_gradient_is_deterministic(self):
        """The gathers' backward adds a token's k repeats in a fixed
        order: two backward passes give the same bits."""
        B, S, D, F, E, k, cf, bt = CASES["blocks_drops"]
        _, m = _pair(11, D, F, E)
        x = torch.from_numpy(_x(12, B, S, D)).requires_grad_(True)
        out = []
        for _ in range(2):
            y, aux = moe.moe_ffn(m, x, top_k=k, capacity_factor=cf,
                                 block_tokens=bt)
            out.append(torch.autograd.grad(
                y.square().sum() + aux["load_balance"],
                [x, m.router, m.w_gate]))
        for a, b in zip(*out):
            assert torch.equal(a, b)

    def test_init_distributions(self):
        """``init_moe``: router fp32 N(0, 1/d_model), experts N(0, 1)/√in
        in the parameter dtype, on the generator's device."""
        gen = torch.Generator().manual_seed(0)
        m = moe.init_moe(gen, 256, 128, 16, torch.bfloat16)
        assert m.router.dtype == torch.float32
        assert m.w_gate.dtype == m.w_down.dtype == torch.bfloat16
        assert m.w_gate.shape == (16, 256, 128)
        assert m.w_down.shape == (16, 128, 256)
        for w, fan_in in ((m.router, 256), (m.w_gate, 256), (m.w_up, 256),
                          (m.w_down, 128)):
            std = float(w.detach().float().std())
            assert abs(std * math.sqrt(fan_in) - 1) < 0.05, std
