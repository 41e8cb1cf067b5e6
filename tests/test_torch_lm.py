"""The LM serving slice of the PyTorch port against the JAX reference:
GQA attention (both backends, the chunked branch, decode with its ring
buffer), the transformer LM at the smoke configs of minitron-4b,
stablelm-3b, qwen2.5-32b and the MoE archs granite-moe-3b-a800m and
mixtral-8x7b (logits and aux losses), ``serve_lm`` and ``prefill_lm``.
Weights are the reference's, carried across by ``lm_params_from_jax``;
token ids are numpy arrays fed to both.  An MoE layer's routing may flip
at a near-tie of its k-th and (k+1)-th router logit: every MoE case
asserts each such gap it met exceeds ``GAP_TOL`` (no fixture was
re-seeded to pass it).

Tolerances: fp32 within 1e-5 abs (the two frameworks sum the products
and softmax in different orders).  bf16 attention: the ``reference``
backend rounds where the reference rounds, within 1e-3 abs (a
product's accumulation may round its last bit otherwise); ``fused``
keeps scores and p in fp32 and rounds once at the end, within 2e-2 abs:
one bf16 rounding (2^-8 relative) of outputs up to |4|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch.serve import serve_lm as j_serve_lm
from repro.models import attention as j_attn
from repro.models import transformer as j_tfm
from repro_torch import configs
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch.serve import prefill_lm, serve_lm
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.models.transformer import Transformer, init_params

ATOL = 1e-5
BF16_ATOL = 1e-3
BF16_FUSED_ATOL = 2e-2
GAP_TOL = 1e-5
ARCHS = ["minitron-4b", "stablelm-3b", "qwen2.5-32b", "granite-moe-3b-a800m",
         "mixtral-8x7b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _attn_pair(seed, D, H, KV, hd, bias, dtype=jnp.float32):
    """JAX AttnParams (random biases when ``bias``) and the port's
    Attention holding the same weights."""
    p = j_attn.init_attn(jax.random.PRNGKey(seed), D, H, KV, hd, bias, dtype)
    if bias:
        rng = np.random.default_rng(seed)
        p = p._replace(**{b: jnp.asarray(rng.standard_normal(
            getattr(p, b).shape), dtype) for b in ("bq", "bk", "bv")})
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    m = attn.Attention(D, H, hd, n_kv_heads=KV, qkv_bias=bias, dtype=tdt)
    sd = {f"{w}.weight": torch.from_numpy(
        np.asarray(getattr(p, w), np.float32).T.copy()).to(tdt)
        for w in ("wq", "wk", "wv", "wo")}
    if bias:
        sd.update({f"w{b[1]}.bias": torch.from_numpy(
            np.array(getattr(p, b), np.float32)).to(tdt)
            for b in ("bq", "bk", "bv")})
    m.load_state_dict(sd)
    return p, m.eval()


ATTN_CASES = {
    # name: (H, KV, S, kwargs)
    "mha": (4, 4, 40, dict(causal=False)),
    "gqa_causal": (4, 2, 40, dict(causal=True)),
    "window": (4, 2, 40, dict(causal=True, window=8)),
    "bias": (4, 2, 40, dict(causal=True, bias=True)),
    "no_rope": (4, 2, 40, dict(causal=True, rope_theta=None)),
    "positions": (4, 2, 40, dict(causal=True, positions=True)),
    "chunked": (4, 2, 40, dict(causal=True, chunk=16)),
    "chunked_window": (4, 2, 40, dict(causal=True, window=8, chunk=16)),
    "chunked_bidirectional": (4, 4, 40, dict(causal=False, chunk=16)),
    "key_mask": (4, 4, 40, dict(causal=False, key_mask=True)),
}


def _attn_case(name, dtype=jnp.float32, hd=16):
    H, KV, S, kw = ATTN_CASES[name]
    kw = dict(kw)
    D, B = 32, 2
    p, m = _attn_pair(len(name), D, H, KV, hd, kw.pop("bias", False), dtype)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    if kw.pop("positions", False):
        kw["positions"] = (np.arange(S)[None, :] * 3 + 5).astype(np.int32)
    if kw.pop("key_mask", False):
        mask = np.ones((B, S), bool)
        mask[0, 30:] = False
        mask[1, ::3] = False
        kw["attn_mask"] = mask
    kw.setdefault("rope_theta", 1e4)
    jx = jnp.asarray(x, dtype)
    want = j_attn.attention(p, jx, n_heads=H, n_kv_heads=KV, head_dim=hd,
                            **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tx = torch.from_numpy(x).to(torch.float32 if dtype == jnp.float32
                                else torch.bfloat16)
    return m, tx, tkw, np.asarray(want.astype(jnp.float32))


class TestAttention:
    @pytest.mark.parametrize("name", list(ATTN_CASES))
    def test_fp32_matches_jax(self, name):
        m, x, kw, want = _attn_case(name)
        with torch.no_grad():
            ref = m(x, backend="reference", **kw)
            fused = m(x, backend="fused", **kw)
        np.testing.assert_allclose(ref.numpy(), want, atol=ATOL, rtol=0)
        # fused on a CPU tensor: the flash kernel's plain version (or the
        # plain key-mask branch), the same function
        np.testing.assert_allclose(fused.numpy(), ref.numpy(), atol=ATOL,
                                   rtol=0)

    @pytest.mark.parametrize("name", ["gqa_causal", "chunked_window"])
    def test_bf16_matches_jax(self, name):
        m, x, kw, want = _attn_case(name, jnp.bfloat16)
        with torch.no_grad():
            ref = m(x, backend="reference", **kw)
            fused = m(x, backend="fused", **kw)
        assert ref.dtype == fused.dtype == torch.bfloat16
        np.testing.assert_allclose(ref.float().numpy(), want, atol=BF16_ATOL,
                                   rtol=0)
        assert np.abs(want).max() <= 4
        np.testing.assert_allclose(fused.float().numpy(), want,
                                   atol=BF16_FUSED_ATOL, rtol=0)

    @pytest.mark.parametrize("hd", [80, 128])
    @pytest.mark.parametrize("name", ["gqa_causal", "chunked"])
    def test_bf16_head_dims_match_jax(self, name, hd):
        """The LM configs' head dims, where √hd is not a bf16 value: the
        reference divides by √hd rounded to bf16, and so must the
        ``reference`` backend."""
        m, x, kw, want = _attn_case(name, jnp.bfloat16, hd=hd)
        with torch.no_grad():
            ref = m(x, backend="reference", **kw)
        assert ref.dtype == torch.bfloat16
        np.testing.assert_allclose(ref.float().numpy(), want, atol=BF16_ATOL,
                                   rtol=0)

    def test_bf16_decode_matches_jax(self):
        """Token-by-token bf16 decode at head dim 128 (the divisor rounded
        to bf16, as in prefill)."""
        H, KV, D, hd, B, steps = 4, 2, 32, 128, 2, 6
        p, m = _attn_pair(7, D, H, KV, hd, False, jnp.bfloat16)
        jc = j_attn.init_cache(B, KV, steps, hd, jnp.bfloat16)
        tc = attn.init_cache(B, KV, steps, hd, torch.bfloat16)
        xs = np.random.default_rng(8).standard_normal(
            (steps, B, 1, D)).astype(np.float32)
        for pos in range(steps):
            want, jc = j_attn.decode_attention(
                p, jnp.asarray(xs[pos], jnp.bfloat16), jc, jnp.int32(pos),
                n_heads=H, n_kv_heads=KV, head_dim=hd)
            with torch.no_grad():
                got, tc = attn.decode_attention(
                    m, torch.from_numpy(xs[pos]).bfloat16(), tc, pos)
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                atol=BF16_ATOL, rtol=0)

    @pytest.mark.parametrize("window,steps", [(None, 10), (4, 11)])
    def test_decode_matches_jax(self, window, steps):
        """Token-by-token decode; with window 4 the ring buffer wraps
        twice (pos > window)."""
        H, KV, D, hd, B = 4, 2, 32, 16, 2
        p, m = _attn_pair(5, D, H, KV, hd, True)
        C = window or steps
        jc = j_attn.init_cache(B, KV, C, hd, jnp.float32)
        tc = attn.init_cache(B, KV, C, hd, torch.float32)
        xs = np.random.default_rng(6).standard_normal(
            (steps, B, 1, D)).astype(np.float32)
        for pos in range(steps):
            want, jc = j_attn.decode_attention(
                p, jnp.asarray(xs[pos]), jc, jnp.int32(pos), n_heads=H,
                n_kv_heads=KV, head_dim=hd, window=window)
            with torch.no_grad():
                got, tc = attn.decode_attention(m, torch.from_numpy(xs[pos]),
                                                tc, pos, window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)


def _record_gap(gaps):
    """A pre-hook on an MoE layer: the least gap between the k-th and
    (k+1)-th router logit of the tokens it is about to route."""
    def hook(module, args, kwargs):
        x, k = args[0], kwargs["top_k"]
        B, S, D = x.shape
        nb = moe.n_blocks(B * S, kwargs.get("block_tokens", 2048))
        with torch.no_grad():
            logits = moe.route(module, x.reshape(nb, -1, D), k)[0]
        top = torch.sort(logits, dim=-1, descending=True).values
        gaps.append(float((top[..., k - 1] - top[..., k]).min()))
    return hook


def _check_routing(model):
    """Every routing the model made since ``_lm_pair`` was clear of a
    near-tie (dense models route nothing)."""
    assert bool(model.gaps) == bool(model.cfg.moe_experts)
    assert not model.gaps or min(model.gaps) > GAP_TOL, min(model.gaps)


def _lm_pair(arch, **changes):
    jcfg = dataclasses.replace(j_configs.get(arch).smoke, **changes)
    tcfg = dataclasses.replace(configs.get(arch).smoke, **changes)
    params = j_tfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = Transformer(tcfg)
    model.load_state_dict(lm_params_from_jax(_np_tree(params)))
    model.gaps = []
    for layer in model.layers:
        if tcfg.moe_experts:
            layer.moe.register_forward_pre_hook(_record_gap(model.gaps),
                                                with_kwargs=True)
    return jcfg, params, model.eval()


def _j_prefill(params, tokens, jcfg):
    """The reference's prefill step (launch/steps.py, kind "prefill")."""
    x = j_tfm.hidden_states(params, tokens, jcfg)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return x[:, -1, :] @ head.astype(jcfg.compute_dtype)


LM_CASES = [(a, {}) for a in ARCHS] + [
    ("minitron-4b", {"attn_chunk": 8}),
    ("minitron-4b", {"window": 4}),
    ("granite-moe-3b-a800m", {"capacity_factor": 4.0}),     # E / k: no drops
]


def _case_id(c):
    return c[0] + "".join(f"-{k}{v}" for k, v in c[1].items())


class TestLM:
    @pytest.mark.parametrize("case", LM_CASES, ids=_case_id)
    def test_forward_and_hidden_states(self, case):
        arch, changes = case
        jcfg, params, model = _lm_pair(arch, **changes)
        tok = lm_batch(1, 0, 2, 20, jcfg.vocab)["tokens"]
        want_logits, want_aux = j_tfm.forward(params, jnp.asarray(tok), jcfg)
        want_h = j_tfm.hidden_states(params, jnp.asarray(tok), jcfg)
        with torch.no_grad():
            for backend in ("reference", "fused"):
                got = model(torch.from_numpy(tok), backend=backend)
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(want_logits),
                                           atol=ATOL, rtol=0)
                got, aux = model.forward_aux(torch.from_numpy(tok),
                                             backend=backend)
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(want_logits),
                                           atol=ATOL, rtol=0)
                for name, v in want_aux.items():    # zeros when dense
                    np.testing.assert_allclose(float(aux[name]), float(v),
                                               atol=1e-6, rtol=1e-6,
                                               err_msg=name)
                h = model.hidden_states(torch.from_numpy(tok),
                                        backend=backend)
                np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                           atol=ATOL, rtol=0)
        _check_routing(model)

    @pytest.mark.parametrize("case", LM_CASES, ids=_case_id)
    def test_decode_step(self, case):
        arch, changes = case
        jcfg, params, model = _lm_pair(arch, **changes)
        tok = lm_batch(2, 0, 2, 9, jcfg.vocab)["tokens"]
        jc = j_tfm.init_cache(jcfg, 2, 9)
        tc = model.init_cache(2, 9)
        assert tc["k"].shape == jc["k"].shape
        for pos in range(9):
            want, jc = j_tfm.decode_step(params, jc,
                                         jnp.asarray(tok[:, pos:pos + 1]),
                                         jnp.int32(pos), jcfg)
            with torch.no_grad():
                got, tc = model.decode_step(
                    tc, torch.from_numpy(tok[:, pos:pos + 1]), pos)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)
        _check_routing(model)

    @pytest.mark.parametrize("case", LM_CASES, ids=_case_id)
    def test_prefill_matches_jax_and_decode(self, case):
        """``prefill_lm`` equals the reference's prefill step, and
        decoding the prompt token by token ends at the same logits.  An
        MoE layer routes each decode step's 2 tokens with capacity
        ceil(cf * 2 * k / E) (1 at the smoke configs) and the prefill's
        34 with its own, so the two drop different entries unless
        capacity_factor >= E / k drops none: there the decode is held to
        the reference's decode of the prompt instead."""
        arch, changes = case
        jcfg, params, model = _lm_pair(arch, **changes)
        tok = lm_batch(3, 0, 2, 17, jcfg.vocab)["tokens"]
        want = np.asarray(_j_prefill(params, jnp.asarray(tok), jcfg))
        for backend in ("reference", "fused"):
            got, t = prefill_lm(model, tok, backend=backend,
                                device="cpu")
            assert got.shape == (2, jcfg.vocab) and t["prefill_s"] >= 0
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
        cache = model.init_cache(2, tok.shape[1])
        with torch.no_grad():
            for pos in range(tok.shape[1]):
                logits, cache = model.decode_step(
                    cache, torch.from_numpy(tok[:, pos:pos + 1]), pos)
        drops = jcfg.moe_experts and (
            jcfg.capacity_factor < jcfg.moe_experts / jcfg.moe_top_k)
        if drops:
            jc = j_tfm.init_cache(jcfg, 2, tok.shape[1])
            j_dec = jax.jit(j_tfm.decode_step, static_argnums=4)
            for pos in range(tok.shape[1]):
                j_last, jc = j_dec(params, jc,
                                   jnp.asarray(tok[:, pos:pos + 1]),
                                   jnp.int32(pos), jcfg)
            want = np.asarray(j_last[:, 0])
            assert np.abs(want - got.numpy()).max() > ATOL   # drops differ
        else:
            want = got.numpy()
        np.testing.assert_allclose(logits[:, 0].numpy(), want, atol=ATOL,
                                   rtol=0)
        _check_routing(model)

    @pytest.mark.parametrize("arch", ["minitron-4b", "qwen2.5-32b"]
                             + MOE_ARCHS)
    def test_serve_lm_matches_jax(self, arch):
        """Greedy ids equal the reference's ``serve_lm`` (its weights from
        PRNGKey(0)) up to the first step whose top-2 logit gap is within
        the tolerance, where a near-tie may flip."""
        jcfg, params, model = _lm_pair(arch)
        want = np.asarray(j_serve_lm(arch, n_tokens=12, batch=2))
        got, t = serve_lm(configs.get(arch).smoke, n_tokens=12, batch=2,
                          device="cpu", model=model)
        assert got.dtype == torch.int32 and got.shape == (2, 12)
        assert t["decode_s"] > 0
        cache = j_tfm.init_cache(jcfg, 2, 12)
        tok = jnp.zeros((2, 1), jnp.int32)
        gaps = []
        for pos in range(12):
            logits, cache = j_tfm.decode_step(params, cache, tok,
                                              jnp.int32(pos), jcfg)
            top2 = np.sort(np.asarray(logits[:, 0]), axis=-1)[:, -2:]
            gaps.append(top2[:, 1] - top2[:, 0])
            tok = jnp.asarray(want[:, pos:pos + 1])
        gaps = np.stack(gaps, 1)
        for b in range(2):
            close = np.nonzero(gaps[b] <= ATOL)[0]
            upto = close[0] if len(close) else 12
            assert upto >= 4, gaps[b]
            np.testing.assert_array_equal(got[b, :upto].numpy(),
                                          want[b, :upto])
        _check_routing(model)

    def test_serve_lm_raises_without_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: the entry point runs on it")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_lm(configs.get("minitron-4b").smoke, n_tokens=2)

    def test_prefill_lm_runs_only_where_asked(self):
        """Without a GPU ``prefill_lm`` raises unless given the CPU, and it
        refuses a device its model does not live on."""
        model = init_params(torch.Generator().manual_seed(0),
                            configs.get("minitron-4b").smoke, "cpu")
        tok = np.zeros((1, 4), np.int32)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                prefill_lm(model, tok)
        with pytest.raises(ValueError, match="lives on cpu"):
            prefill_lm(model, tok, device="cuda")
        logits, _ = prefill_lm(model, tok, device="cpu")
        assert logits.shape == (1, model.cfg.vocab)


class TestConfigs:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_transcribed(self, arch):
        """Every field of CONFIG and SMOKE equals the reference's
        (dtypes by name), and the parameter counts agree."""
        for which in ("config", "smoke"):
            jc = getattr(j_configs.get(arch), which)
            tc = getattr(configs.get(arch), which)
            for f in dataclasses.fields(jc):
                a, b = getattr(jc, f.name), getattr(tc, f.name)
                if f.name.endswith("dtype"):
                    assert str(b) == f"torch.{jnp.dtype(a).name}", f.name
                else:
                    assert a == b, f.name
            assert tc.hd == jc.hd
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
        assert (configs.get(arch).shapes.keys()
                == j_configs.get(arch).shapes.keys())

    def test_minitron_size(self):
        cfg = configs.get("minitron-4b").config
        assert cfg.param_count() == 4_309_847_040     # 8.6 GB in bf16
        assert cfg.hd == 128 and cfg.n_heads % cfg.n_kv_heads == 0

    def test_moe_raises(self):
        """An MoE config builds a ``Transformer`` of the config's size
        whose blocks hold an MoE FFN (fp32 router) instead of the dense
        one, and it runs forward (finite logits, positive aux losses)
        and a decode step."""
        cfg = dataclasses.replace(configs.get("minitron-4b").smoke,
                                  moe_experts=4, moe_top_k=2)
        assert cfg.active_param_count() < cfg.param_count()
        model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count()
        layer = model.layers[0]
        assert not hasattr(layer, "w_gate") and isinstance(layer.moe,
                                                           moe.MoE)
        assert layer.moe.router.dtype == torch.float32
        tok = torch.from_numpy(lm_batch(0, 0, 2, 8, cfg.vocab)["tokens"])
        with torch.no_grad():
            logits, aux = model.forward_aux(tok)
            step, _ = model.decode_step(model.init_cache(2, 8), tok[:, :1],
                                        0)
        assert logits.shape == (2, 8, cfg.vocab)
        assert bool(torch.isfinite(logits).all() & torch.isfinite(step).all())
        assert float(aux["load_balance"]) > 0 and float(aux["router_z"]) > 0

    def test_moe_sizes(self):
        """The full MoE configs' parameter budgets (the ranges of
        tests/test_arch_smoke.py) and each smoke model's count."""
        for arch, (lo, hi), (alo, ahi) in (
                ("granite-moe-3b-a800m", (3.0e9, 3.6e9), (0.6e9, 1.1e9)),
                ("mixtral-8x7b", (45e9, 48e9), (11e9, 15e9))):
            cfg = configs.get(arch).config
            assert lo <= cfg.param_count() <= hi, arch
            assert alo <= cfg.active_param_count() <= ahi, arch
            _, _, model = _lm_pair(arch)
            assert sum(p.numel() for p in model.parameters()) == \
                configs.get(arch).smoke.param_count()
        assert configs.get("granite-moe-3b-a800m").config.param_count() \
            == 3_298_793_472          # 6.6 GB in bf16

    def test_tied_and_untied_heads(self):
        for arch, tied in (("minitron-4b", True), ("stablelm-3b", False)):
            _, params, model = _lm_pair(arch)
            assert ("lm_head" in params) != tied
            assert (model.lm_head is None) == tied

    def test_lm_batch(self):
        a = lm_batch(0, 3, 4, 16, 100)["tokens"]
        b = lm_batch(0, 3, 4, 16, 100)["tokens"]
        c = lm_batch(0, 4, 4, 16, 100)["tokens"]
        assert a.dtype == np.int32 and a.shape == (4, 16)
        assert np.array_equal(a, b) and not np.array_equal(a, c)
        assert a.min() >= 0 and a.max() < 100
