"""The ColBERT encoder and the end-to-end serving slice of the PyTorch
port against the JAX reference, at the smoke config, with the
reference's weights carried across by ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.core.sampling import sample_sphere as j_sample_sphere
from repro.data import synthetic as j_synth
from repro.launch.serve import serve_retrieval as j_serve_retrieval
from repro.models import colbert as j_colbert
from repro_torch.configs import colbert_base
from repro_torch.data import synthetic
from repro_torch.launch.serve import serve_retrieval
from repro_torch.models.colbert import ColBERT, init_params
from repro_torch.models.convert import params_from_jax

J_SMOKE = configs.get("colbert").smoke


def _port(jcfg, tcfg, seed=0):
    params = j_colbert.init_params(jax.random.PRNGKey(seed), jcfg)
    model = ColBERT(tcfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, model.eval()


def _corpus():
    c = synthetic.token_corpus(3, n_docs=6, n_q=4, vocab=J_SMOKE.vocab,
                               m=J_SMOKE.doc_len, l=5)
    return c.doc_ids, c.q_ids


class TestEncoder:
    def test_token_corpus_is_the_reference_copy(self):
        got = synthetic.token_corpus(5, n_docs=20, n_q=7)
        want = j_synth.token_corpus(5, n_docs=20, n_q=7)
        for f in ("doc_ids", "q_ids", "q_topics", "d_topics", "rel",
                  "stopword_set", "idf"):
            np.testing.assert_array_equal(getattr(got, f),
                                          np.asarray(getattr(want, f)))

    @pytest.mark.parametrize("norm", ["sphere", "ball"])
    def test_fp32_encode_matches_jax(self, norm):
        jcfg = dataclasses.replace(J_SMOKE, norm=norm)
        tcfg = dataclasses.replace(colbert_base.SMOKE, norm=norm)
        params, model = _port(jcfg, tcfg)
        docs, qs = _corpus()
        jd, jm = j_colbert.encode_docs(params, jcfg, jnp.asarray(docs))
        jq, _ = j_colbert.encode_queries(params, jcfg, jnp.asarray(qs))
        with torch.no_grad():
            td, tm = model.encode_docs(torch.tensor(docs))
            tq, tqm = model.encode_queries(torch.tensor(qs))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert tq.shape == (4, J_SMOKE.query_len) + (J_SMOKE.out_dim,)
        assert bool(tqm.all())
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-5)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-5)

    def test_bf16_encode_matches_jax(self):
        """bf16 params and compute in both packages: the two round at the
        same places but their bf16 matmuls accumulate differently, so a
        unit-norm embedding agrees to 5e-2 (a few bf16 ulps at 1.0)."""
        jcfg = dataclasses.replace(J_SMOKE, param_dtype=jnp.bfloat16,
                                   compute_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(colbert_base.SMOKE,
                                   param_dtype=torch.bfloat16,
                                   compute_dtype=torch.bfloat16)
        params, model = _port(jcfg, tcfg)
        docs, _ = _corpus()
        jd, _ = j_colbert.encode_docs(params, jcfg, jnp.asarray(docs))
        with torch.no_grad():
            td, _ = model.encode_docs(torch.tensor(docs))
        assert td.dtype == torch.bfloat16
        np.testing.assert_allclose(td.float().numpy(),
                                   np.asarray(jd.astype(jnp.float32)),
                                   atol=5e-2)

    def test_init_params_shapes_and_scales(self):
        model = init_params(torch.Generator().manual_seed(0),
                            colbert_base.SMOKE)
        sd = model.state_dict()
        ref = params_from_jax(jax.tree_util.tree_map(
            np.asarray, j_colbert.init_params(jax.random.PRNGKey(0),
                                              J_SMOKE)))
        assert sd.keys() == ref.keys()
        for k in sd:
            assert sd[k].shape == ref[k].shape, k
            assert abs(sd[k].float().std() - ref[k].float().std()) \
                <= 0.1 * ref[k].float().std() + 1e-6, k


class TestServeSlice:
    def test_serve_retrieval_matches_jax(self):
        """encode -> prune -> pack -> two-stage serve, end to end, with
        the reference's weights and sphere samples carried across."""
        ji, js = j_serve_retrieval(n_queries=8)
        _, model = _port(J_SMOKE, colbert_base.SMOKE)
        samples = torch.from_numpy(np.array(j_sample_sphere(
            jax.random.PRNGKey(1), 2048, J_SMOKE.out_dim)))
        res = serve_retrieval(colbert_base.SMOKE, n_queries=8, device="cpu",
                              model=model, samples=samples)
        ti, ts = res
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), atol=1e-5)
        assert res.packed.storage()["remain_pct"] == pytest.approx(50.0,
                                                                   abs=0.1)
