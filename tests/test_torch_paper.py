"""The paper drivers of the PyTorch port (``repro_torch.paper``) against
the reference's (``benchmarks/bench_*.py``).

In this process only, the reference's ``benchmarks.common.train_encoder``
is replaced by the seeded ``init_params`` of its own bench configs (no
training) and its corpus is cut to 64 docs and 32 queries; no file
under ``benchmarks/`` is edited.  Each port driver's "rows from
embeddings" step then takes the embeddings the reference's ``run()``
scores, with the reference's sample sets (``common.samples``) and random
draws (``common.random_keep``) fed in, and its rows are held to the
reference's: MRR@10, nDCG@10, remain %, Mean Errors and the Fig. 1/4/5
statistics within 1e-6 (Norm-pruning's row as its test states), the linear fit within 1e-4, and every
``CLAIM_*`` boolean that does not compare two timings equal (a timing
claim compares one framework's clock with itself).  The port's "train
and encode" step is held separately: the encoders' embeddings within
1e-5 and the received attention within 1e-6 of the reference's from
identical weights, and three steps of ``train_encoder`` within 1e-5 of
the reference's losses.
"""

import contextlib
import dataclasses
import inspect
import io
import re
import types

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from benchmarks import (bench_fig1_geometry, bench_fig3_aggressive,
                            bench_fig45_positions, bench_fig6_me_ndcg,
                            bench_kernels, bench_speedup,
                            bench_table1_indomain, bench_table2_ablation,
                            bench_table3_beir)
    from benchmarks import common as j_common
    from repro.core import baselines as j_base
    from repro.core.sampling import sample_sphere as j_sample_sphere
    from repro.models import colbert as j_colbert
except ImportError:     # a GPU host without JAX
    jax = None
from repro_torch.core import baselines
from repro_torch.models.colbert import ColBERT
from repro_torch.models.convert import params_from_jax
from repro_torch.paper import (common, fig1_geometry, fig3_aggressive,
                               fig45_positions, fig6_me_ndcg, kernels, run,
                               speedup, table1_indomain, table2_ablation,
                               table3_beir)

pytestmark = pytest.mark.skipif(jax is None, reason="needs the JAX package")

N_DOCS, N_Q = 64, 32
SCALE = common.Scale(n_docs=N_DOCS, n_q=N_Q)
TOL = 1e-6


def _j_init(cfg, seed=0):
    return j_colbert.init_params(jax.random.PRNGKey(seed), cfg)


def _port_model(jcfg, tcfg, seed=0):
    model = ColBERT(tcfg)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, _j_init(jcfg, seed))))
    return model.eval()


@pytest.fixture
def reference_draws(monkeypatch):
    """The reference untrained and cut to size, and the port fed the
    reference's sample sets and random draws."""
    monkeypatch.setattr(j_common, "train_encoder",
                        lambda cfg, **kw: _j_init(cfg, kw.get("seed", 0)))
    monkeypatch.setattr(j_common, "N_DOCS", N_DOCS)
    monkeypatch.setattr(j_common, "N_Q", N_Q)

    def samples(n, dim, seed, device):
        return torch.from_numpy(np.asarray(
            j_sample_sphere(jax.random.PRNGKey(seed), n, dim))).to(device)

    def random_keep(d_mask, f, seed):
        keep = j_base.random_prune(jax.random.PRNGKey(seed),
                                   jnp.asarray(d_mask.cpu().numpy()), f)
        return torch.from_numpy(np.asarray(keep)).to(d_mask.device)

    monkeypatch.setattr(common, "samples", samples)
    monkeypatch.setattr(common, "random_keep", random_keep)


def _encoded(cfg, c):
    """The reference's embeddings of corpus ``c`` (as ``encode_all``)
    in the port's ``Encoded``."""
    params = _j_init(cfg)
    d, dm = j_colbert.encode_docs(params, cfg, c.doc_ids)
    q, qm = j_colbert.encode_queries(params, cfg, c.q_ids)
    t = lambda a: torch.from_numpy(np.array(a))
    return common.Encoded(c, t(jnp.asarray(d, jnp.float32)), t(dm),
                          t(jnp.asarray(q, jnp.float32)), t(qm))


def _ref_claims(module, rows):
    """The reference's CLAIM lines printed by its ``main()`` over
    ``rows``: {claim: holds}."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(module, "run", lambda *a, **k: rows)
        module.main()
    out = {}
    for line in buf.getvalue().splitlines():
        if "/CLAIM_" in line:
            name = line.split("/CLAIM_")[1].split(",")[0]
            out[name] = line.split("holds=")[1].split(";")[0] == "True"
    return out


def _claims_equal(module, port_module, rows, port_rows, timing=()):
    want = _ref_claims(module, rows)
    got = {k: v[0] for k, v in port_module.claims(port_rows).items()}
    assert set(got) == set(want)
    for k in set(got) - set(timing):
        assert got[k] == want[k], k


def _near(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=0)


class TestRows:
    def test_table1(self, reference_draws):
        want = bench_table1_indomain.run()
        c = common.corpus(SCALE)
        enc = _encoded(j_common.CFG_SPHERE, c)
        _, _, recv = j_colbert.encode_docs_with_attention(
            _j_init(j_common.CFG_SPHERE), j_common.CFG_SPHERE, c.doc_ids)
        enc_b = _encoded(j_common.CFG_BALL, c)
        got = table1_indomain.rows(enc, enc_b,
                                   torch.from_numpy(np.array(recv)))
        assert [r[0] for r in got] == [r[0] for r in want]
        for g, w in zip(got, want):
            if g[0] != "norm_pruning":
                _near(g[2:], w[2:])
        # Norm-pruning's 50 % threshold sits on the ball's surface: most
        # tokens are projected to norm 1 and differ from it by an ulp,
        # summed in another order in each package.  Its keep mask is held
        # where |norm - theta| > 1e-6, and its remain % to the tokens
        # inside that band.
        db, mb = enc_b.d_emb, enc_b.d_mask
        norms = torch.linalg.vector_norm(db, dim=-1)
        theta = common.quantile(norms[mb], 0.5)
        keep = baselines.norm_prune(db, mb, theta=theta).numpy()
        j_keep = np.asarray(j_base.norm_prune(db.numpy(), mb.numpy(),
                                              theta=theta))
        clear = np.abs(norms.numpy() - theta) > 1e-6
        np.testing.assert_array_equal(keep[clear], j_keep[clear])
        band = 100.0 * (~clear & mb.numpy()).sum() / mb.sum().item()
        g, w = (next(r for r in rows if r[0] == "norm_pruning")
                for rows in (got, want))
        assert abs(g[4] - w[4]) <= band
        _claims_equal(bench_table1_indomain, table1_indomain, want, got)

    def test_table2(self, reference_draws):
        want = bench_table2_ablation.run()
        got = table2_ablation.rows(_encoded(j_common.CFG_SPHERE,
                                            common.corpus(SCALE)))
        assert [r[0] for r in got] == [r[0] for r in want]
        for g, w in zip(got, want):
            _near(g[2], w[2])
        by = {r[0]: r for r in got}
        assert by["beam_3"][4] != by["voronoi_full"][4]   # the beam quirk
        _claims_equal(bench_table2_ablation, table2_ablation, want, got,
                      timing=("step3_faster",))

    def test_table3(self, reference_draws):
        want = bench_table3_beir.run()
        encs = {dom: _encoded(j_common.CFG_SPHERE,
                              table3_beir.shifted_corpus(seed, SCALE))
                for dom, seed in table3_beir.DOMAINS.items()}
        got = table3_beir.rows(encs)
        assert [r[:3] for r in got] == [r[:3] for r in want]
        _near([r[3] for r in got], [r[3] for r in want])
        _claims_equal(bench_table3_beir, table3_beir, want, got)

    def test_fig1(self, reference_draws):
        want_rep, want_l1 = bench_fig1_geometry.run()
        got = fig1_geometry.rows(_encoded(j_common.CFG_SPHERE,
                                          common.corpus(SCALE)))
        rep, l1 = got
        _near(l1, want_l1)
        for k in ("mean_abs_off_corr", "max_abs_off_corr"):
            _near(float(rep[k]), float(want_rep[k]))
        _claims_equal(bench_fig1_geometry, fig1_geometry,
                      (want_rep, want_l1), got)

    def test_fig3(self, reference_draws):
        want = bench_fig3_aggressive.run()
        got = fig3_aggressive.rows(_encoded(j_common.CFG_BALL,
                                            common.corpus(SCALE)))
        assert [r[0] for r in got] == [r[0] for r in want]
        for g, w in zip(got, want):
            _near(g[1:4], w[1:4])
        _claims_equal(bench_fig3_aggressive, fig3_aggressive, want, got)

    def test_fig45(self, reference_draws):
        want = bench_fig45_positions.run()
        got = fig45_positions.rows(_encoded(j_common.CFG_SPHERE,
                                            common.corpus(SCALE)))
        assert [r[0] for r in got] == [r[0] for r in want]
        for g, w in zip(got, want):
            _near(g[1:], w[1:])
        _claims_equal(bench_fig45_positions, fig45_positions, want, got)

    def test_fig6(self, reference_draws):
        want_rows, want_fit = bench_fig6_me_ndcg.run()
        got = fig6_me_ndcg.rows(_encoded(j_common.CFG_SPHERE,
                                         common.corpus(SCALE)))
        rows, fit = got
        assert [r[0] for r in rows] == [r[0] for r in want_rows]
        for g, w in zip(rows, want_rows):
            _near(g[1:3], w[1:3])
        for k in ("slope", "intercept", "r2"):
            _near(fit[k], want_fit[k], 1e-4)
        _claims_equal(bench_fig6_me_ndcg, fig6_me_ndcg,
                      (want_rows, want_fit), got)

    def test_speedup_and_harness(self, capsys):
        t_vp, t_lp, n = speedup.run(n_docs=2, m=12, dim=16, n_samples=64,
                                    lp_iters=5, device="cpu")
        assert n == 2 and t_vp > 0 and t_lp > 0
        speedup.report((t_vp, t_lp, n), lp_iters=5)
        out = capsys.readouterr().out
        assert "speedup/CLAIM_vp_order_of_magnitude_faster,0.0,holds=" in out
        with pytest.raises(SystemExit):
            run.main(["--device", "cpu", "nope"])

    def test_pruning_sweeps_match_reference_names(self, capsys):
        """The two sweeps at shapes below the reference's: every backend
        at a rate above 0, and ``main``'s CSV names (and the ragged
        claim's name) those of the reference's ``main`` fed the same
        results."""
        bk = speedup.run_pruning_backends(n_docs=2, m=10, dim=16,
                                          n_samples=64, device="cpu")
        rg = speedup.run_ragged_pruning(n_docs=5, m=12, dim=16,
                                        n_samples=64, device="cpu")
        assert set(bk) == set(speedup.BACKEND_RUNS) | {"shape"}
        assert all(bk[n] > 0 for n in speedup.BACKEND_RUNS)
        assert rg["flat"] > 0 and rg["bucketed"] > 0
        assert 4 <= rg["shape"]["mean_len"] <= 12
        capsys.readouterr()

        def names(module, port):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(module, "run", lambda *a, **k: (1.0, 2.0, 2))
                mp.setattr(module, "run_pruning_backends",
                           lambda *a, **k: bk)
                mp.setattr(module, "run_ragged_pruning", lambda *a, **k: rg)
                module.main(**({"device": "cpu"} if port else {}))
            out = capsys.readouterr().out.splitlines()
            return [line.split(",")[0] for line in out]

        want = names(bench_speedup, False)
        assert names(speedup, True) == want
        assert "speedup/CLAIM_bucketed_pipeline_beats_flat_on_ragged" in want

    def test_kernels_rows_and_claim(self, capsys):
        """``paper.kernels`` prints the reference's row names in its order
        and ``CLAIM_fused_matches_oracle`` holds (on the CPU the kernel
        column is the plain version, and the rows say so)."""
        kernels.main(device="cpu")
        out = capsys.readouterr().out.splitlines()
        want = re.findall(r'"(kernels/[A-Za-z0-9_]+)"',
                          inspect.getsource(bench_kernels))
        assert [line.split(",")[0] for line in out] == want
        assert all("plain version" in line for line in out)
        claim = out[-1]
        assert claim.startswith("kernels/CLAIM_fused_matches_oracle,0.0,"
                                "holds=True;"), claim


class TestTrainAndEncode:
    def test_encode_matches_reference(self):
        jcfg = j_common.CFG_SPHERE
        c = common.corpus(SCALE)
        enc = common.encode_all(_port_model(jcfg, common.CFG_SPHERE), c)
        want = _encoded(jcfg, c)
        for k in ("d_emb", "q_emb"):
            _near(getattr(enc, k).numpy(), getattr(want, k).numpy(), 1e-5)
        for k in ("d_mask", "q_mask"):
            assert torch.equal(getattr(enc, k), getattr(want, k))
        _, _, recv = j_colbert.encode_docs_with_attention(
            _j_init(jcfg), jcfg, c.doc_ids)
        with torch.no_grad():
            _, _, got = _port_model(jcfg, common.CFG_SPHERE) \
                .encode_docs_with_attention(torch.as_tensor(c.doc_ids))
        _near(got.numpy(), np.asarray(recv))

    def test_table1_encode_matches_reference(self):
        """Table 1's one sphere pass (embeddings and received attention
        together) and its ball pass against the reference's."""
        c = common.corpus(SCALE)
        enc, enc_b, recv = table1_indomain.encode(
            _port_model(j_common.CFG_SPHERE, common.CFG_SPHERE),
            _port_model(j_common.CFG_BALL, common.CFG_BALL), SCALE)
        for got, jcfg in ((enc, j_common.CFG_SPHERE),
                          (enc_b, j_common.CFG_BALL)):
            want = _encoded(jcfg, c)
            for k in ("d_emb", "q_emb"):
                _near(getattr(got, k).numpy(), getattr(want, k).numpy(),
                      1e-5)
            for k in ("d_mask", "q_mask"):
                assert torch.equal(getattr(got, k), getattr(want, k))
        _, _, want = j_colbert.encode_docs_with_attention(
            _j_init(j_common.CFG_SPHERE), j_common.CFG_SPHERE, c.doc_ids)
        _near(recv.numpy(), np.asarray(want))

    def test_scales(self):
        assert dataclasses.asdict(common.CFG_SPHERE) == {
            **dataclasses.asdict(j_common.CFG_SPHERE),
            "param_dtype": torch.float32, "compute_dtype": torch.float32}
        assert common.BENCH.ball is common.CFG_BALL
        assert dataclasses.asdict(common.CFG_BALL) == {
            **dataclasses.asdict(j_common.CFG_BALL),
            "param_dtype": torch.float32, "compute_dtype": torch.float32}
        full = common.FULL
        assert (full.sphere.n_layers, full.sphere.d_model, full.sphere.vocab,
                full.sphere.doc_len, full.n_docs, full.n_q) == (
            12, 768, 30_522, 180, 1024, 256)
        assert full.ball.norm == "ball" and full.ball.d_model == 768

    @pytest.mark.parametrize("cfg_name,reg,alpha", [("sphere", None, 0.0),
                                                    ("ball", "sim", 0.1)])
    def test_train_encoder_matches_reference(self, cfg_name, reg, alpha,
                                             monkeypatch, tmp_path):
        """Three steps of the recipe in both packages from the same
        weights: the losses within 1e-5."""
        jcfg = getattr(j_common, f"CFG_{cfg_name.upper()}")
        tcfg = getattr(common, f"CFG_{cfg_name.upper()}")
        losses = []

        def jit(fn, **kw):
            step = jax.jit(fn, **kw)

            def recorded(state, batch):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                return state, m
            return recorded

        proxy = types.SimpleNamespace(jit=jit, random=jax.random)
        monkeypatch.setattr(j_common, "jax", proxy)
        monkeypatch.setattr(j_common, "CACHE", str(tmp_path / "jax"))
        monkeypatch.setattr(j_common, "N_DOCS", N_DOCS)
        monkeypatch.setattr(j_common, "N_Q", N_Q)
        j_common.train_encoder(jcfg, reg=reg, alpha=alpha, steps=3)
        model, info = common.train_encoder(
            tcfg, reg=reg, alpha=alpha, steps=3, scale=SCALE, device="cpu",
            model=_port_model(jcfg, tcfg), cache_dir=str(tmp_path / "port"))
        assert len(info["losses"]) == len(losses) == 3
        _near(info["losses"], losses, 1e-5)
        # the cached run is restored, not retrained
        again, info2 = common.train_encoder(
            tcfg, reg=reg, alpha=alpha, steps=3, scale=SCALE, device="cpu",
            cache_dir=str(tmp_path / "port"))
        assert info2["losses"] == []
        for (n, p), (_, q) in zip(model.named_parameters(),
                                  again.named_parameters()):
            assert torch.equal(p, q), n
