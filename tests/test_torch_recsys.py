"""The recsys CTR slice of the PyTorch port against the JAX reference:
the configs, the model-level ``embedding_bag``, the per-feature table
lookup on the stacked table, DLRM, DCN-v2 and Wide & Deep at their smoke
configs, ``serve_ctr``, and the two-tower head (``user_tower``,
``score_candidates``, ``retrieve_topk``).  Weights are the reference's,
carried across by ``recsys_params_from_jax``; batches are numpy arrays
from the port's ``ctr_batch``, fed to both.

Tolerances: lookups are gathers, equal bit for bit (NaN where the id is
out of range); bags and the user vector within 1e-6 abs (fp32 sums of
at most 40 rows of scale 0.02, added in another order by XLA); logits
and scores within rtol 1e-5, atol 1e-6 (the fp32 matmuls sum in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import recsys as j_recsys
from repro_torch import configs
from repro_torch.data.synthetic import ctr_batch
from repro_torch.kernels.embedding_bag.ops import embedding_bag_op
from repro_torch.kernels.maxsim_topk.ref import topk_lowest_index
from repro_torch.launch.serve import retrieve_cand, serve_ctr
from repro_torch.models import recsys
from repro_torch.models.convert import recsys_params_from_jax

ARCHS = ["dlrm-rm2", "dcn-v2", "wide-deep"]
RTOL, ATOL, BAG_TOL = 1e-5, 1e-6, 1e-6
J_INIT = {"dlrm-rm2": j_recsys.dlrm_init, "dcn-v2": j_recsys.dcn_init,
          "wide-deep": j_recsys.widedeep_init}
MODEL = {"dlrm-rm2": recsys.DLRM, "dcn-v2": recsys.DCN,
         "wide-deep": recsys.WideDeep}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0):
    """(JAX params, JAX smoke config, the port's model with the same
    weights, the port's smoke config)."""
    j_cfg = j_configs.get(arch).smoke
    cfg = configs.get(arch).smoke
    params = J_INIT[arch](jax.random.PRNGKey(seed), j_cfg)
    model = MODEL[arch](cfg)
    model.load_state_dict(recsys_params_from_jax(_np_tree(params), arch))
    return params, j_cfg, model.eval(), cfg


def _batch(cfg, batch=16, seed=3):
    b = ctr_batch(seed, 0, batch, getattr(cfg, "n_dense", 0), cfg.n_sparse,
                  cfg.table_rows)
    return b, {k: jnp.asarray(v.numpy()) for k, v in b.items()}


def _j_logits(arch, params, j_cfg, jb):
    if arch == "wide-deep":
        return j_recsys.widedeep_forward(params, j_cfg, jb["sparse_ids"])
    fwd = {"dlrm-rm2": j_recsys.dlrm_forward,
           "dcn-v2": j_recsys.dcn_forward}[arch]
    return fwd(params, j_cfg, jb["dense"], jb["sparse_ids"])


def _logits(arch, model, b, backend=None):
    """Through the reference's public names (``*_forward``)."""
    with torch.no_grad():
        if arch == "wide-deep":
            return recsys.widedeep_forward(model, b["sparse_ids"],
                                           backend=backend)
        fwd = {"dlrm-rm2": recsys.dlrm_forward,
               "dcn-v2": recsys.dcn_forward}[arch]
        return fwd(model, b["dense"], b["sparse_ids"], backend=backend)


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _ids_agree(ids, want_ids, want_vals, tol=1e-6):
    """Top-k ids equal position by position wherever the reference's
    value there is more than ``tol`` from its neighbours'."""
    v = np.asarray(want_vals)
    gap_prev = np.full(v.shape, np.inf)
    gap_prev[:, 1:] = v[:, :-1] - v[:, 1:]
    gap_next = np.full(v.shape, np.inf)
    gap_next[:, :-1] = v[:, :-1] - v[:, 1:]
    untied = (gap_prev > tol) & (gap_next > tol)
    bad = (np.asarray(ids) != np.asarray(want_ids)) & untied
    assert not bad.any(), (ids, want_ids)


class TestConfigs:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("which", ["config", "smoke"])
    def test_fields_match_reference(self, arch, which):
        j = getattr(j_configs.get(arch), which)
        t = getattr(configs.get(arch), which)
        for f in dataclasses.fields(j):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name.endswith("dtype"):
                assert str(tv).split(".")[-1] == jnp.dtype(jv).name, f.name
            else:
                assert jv == tv, f.name
        assert t.param_count() == j.param_count()
        if arch == "dcn-v2":
            assert t.x0_dim == j.x0_dim
        entry, j_entry = configs.get(arch), j_configs.get(arch)
        assert entry.family == j_entry.family == "recsys"
        assert {k: (s.kind, s.dims) for k, s in entry.shapes.items()} == \
            {k: (s.kind, s.dims) for k, s in j_entry.shapes.items()}

    @pytest.mark.parametrize("arch,count", [("dlrm-rm2", 1_745_592_641),
                                            ("dcn-v2", 438_776_259),
                                            ("wide-deep", 1_386_088_449)])
    def test_param_counts(self, arch, count):
        assert configs.get(arch).config.param_count() == count

    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_shapes_and_distributions(self, arch):
        cfg = configs.get(arch).smoke
        gen = torch.Generator().manual_seed(0)
        model = recsys.init_model(gen, cfg, "cpu")
        n = sum(p.numel() for p in model.parameters())
        assert n == cfg.param_count() + (arch == "wide-deep")  # W&D bias
        assert model.tables.shape == (cfg.n_sparse * cfg.table_rows,
                                      cfg.embed_dim)
        assert abs(model.tables.std().item() - 0.02) < 2e-3
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                assert not p.any(), name


class TestLookups:
    def test_model_level_embedding_bag(self):
        """Variable bags with weights, sum and mean, an empty bag (mean
        over max(count, 1)) and an id out of range (a NaN bag)."""
        rng = np.random.default_rng(0)
        table = rng.standard_normal((20, 6)).astype(np.float32)
        ids = np.array([3, 7, 7, 19, -1, 0, 5, 20], np.int32)
        bags = np.array([0, 0, 1, 1, 1, 3, 3, 4], np.int32)
        w = rng.uniform(0.5, 2.0, ids.shape).astype(np.float32)
        for weights in (None, w):
            for mode in ("sum", "mean"):
                want = j_recsys.embedding_bag(
                    jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags),
                    5, None if weights is None else jnp.asarray(weights),
                    mode)
                got = recsys.embedding_bag(
                    torch.from_numpy(table), torch.from_numpy(ids),
                    torch.from_numpy(bags), 5,
                    None if weights is None else torch.from_numpy(weights),
                    mode)
                _close(got, want, rtol=0, atol=BAG_TOL)
                assert not got[2].any()                  # the empty bag
                assert torch.isnan(got[4]).all()         # id 20 of 20 rows

    @pytest.mark.parametrize("backend", ["reference", "fused"])
    def test_table_lookup_matches_reference(self, backend):
        """(F, V, D) lookup of the reference vs the stacked one, with ids
        out of range per feature: -1 wraps to the feature's own last
        row, V and -V-1 give NaN, never a row of the next feature."""
        F_, V, D = 5, 7, 4
        rng = np.random.default_rng(1)
        tables = rng.standard_normal((F_, V, D)).astype(np.float32)
        ids = rng.integers(0, V, (6, F_)).astype(np.int32)
        ids[0] = [-1, -V, V, -V - 1, V - 1]
        ids[1] = [V, V + 1, 2 * V - 1, -1, 0]
        want = np.asarray(j_recsys._table_lookup(jnp.asarray(tables),
                                                 jnp.asarray(ids)))
        got = recsys._table_lookup(torch.from_numpy(tables.reshape(-1, D)),
                                   torch.from_numpy(ids),
                                   backend=backend).numpy()
        np.testing.assert_array_equal(got, want)        # NaN == NaN here
        np.testing.assert_array_equal(got[0, 0], tables[0, V - 1])
        assert np.isnan(got[1, :3]).all() and np.isnan(got[0, 2:4]).all()

    def test_stacked_ids(self):
        ids = torch.tensor([[0, 1, -1], [4, -5, 5]], dtype=torch.int32)
        got = recsys.stacked_ids(ids, 5)
        assert got.dtype == torch.int32
        assert got.tolist() == [[0, 6, 14], [4, 5, 2 ** 31 - 1]]
        with pytest.raises(ValueError, match="2\\^31"):
            recsys.stacked_ids(ids, 2 ** 30)


class TestForwards:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_logits_match_reference(self, arch):
        params, j_cfg, model, _ = _pair(arch)
        b, jb = _batch(model.cfg)
        want = _j_logits(arch, params, j_cfg, jb)
        for backend in ("reference", "fused"):
            got = _logits(arch, model, b, backend)
            assert got.shape == (16,) and got.dtype == torch.float32
            _close(got, want)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_backends_equal_on_cpu(self, arch):
        """Both backends are plain on the CPU: equal bit for bit, and
        the kernel wrapper launches nothing."""
        *_, model, _ = _pair(arch, seed=1)
        b, _ = _batch(model.cfg, seed=4)
        before = embedding_bag_op.launches
        ref = _logits(arch, model, b, "reference")
        fused = _logits(arch, model, b, "fused")
        assert torch.equal(ref, fused)
        assert embedding_bag_op.launches == before

    @pytest.mark.parametrize("arch", ARCHS)
    def test_serve_ctr(self, arch):
        params, j_cfg, model, cfg = _pair(arch)
        probs, tm = serve_ctr(cfg, 32, device="cpu", seed=5, model=model)
        b = ctr_batch(5, 0, 32, getattr(cfg, "n_dense", 0), cfg.n_sparse,
                      cfg.table_rows)
        jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
        want = jax.nn.sigmoid(_j_logits(arch, params, j_cfg, jb))
        _close(probs, want)
        assert set(tm) == {"batch_s", "forward_s"}

    def test_serve_ctr_draws_its_model(self):
        cfg = configs.get("dlrm-rm2").smoke
        p1, tm = serve_ctr(cfg, 8, device="cpu", seed=1)
        p2, _ = serve_ctr(cfg, 8, device="cpu", seed=1)
        assert "init_s" in tm and torch.equal(p1, p2)
        assert bool(((p1 > 0) & (p1 < 1)).all())


class TestRetrieval:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_user_tower_and_scores(self, arch):
        params, j_cfg, model, cfg = _pair(arch)
        b, jb = _batch(cfg, 4)
        dense = None if arch == "wide-deep" else b["dense"]
        j_dense = None if arch == "wide-deep" else jb["dense"]
        want_u = j_recsys.user_tower(params, j_cfg, j_dense,
                                     jb["sparse_ids"])
        for backend in ("reference", "fused"):
            u = recsys.user_tower(model, dense, b["sparse_ids"],
                                  backend=backend)
            tol = BAG_TOL if arch == "wide-deep" else ATOL
            _close(u, want_u, atol=tol)
        items = params["tables"][0]
        want_s = j_recsys.score_candidates(want_u, items)
        got_s = recsys.score_candidates(torch.from_numpy(np.array(want_u)),
                                        torch.from_numpy(np.array(items)))
        _close(got_s, want_s)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_retrieve_topk(self, arch):
        params, j_cfg, model, cfg = _pair(arch)
        b, jb = _batch(cfg, 4, seed=6)
        dense = None if arch == "wide-deep" else b["dense"]
        j_dense = None if arch == "wide-deep" else jb["dense"]
        want_v, want_i = j_recsys.retrieve_topk(params, j_cfg, j_dense,
                                                jb["sparse_ids"], k=5)
        v, i = recsys.retrieve_topk(model, dense, b["sparse_ids"], k=5)
        assert v.shape == (4, 5) and i.dtype == torch.int32
        _close(v, want_v)
        _ids_agree(i.numpy(), want_i, want_v)

    def test_retrieve_cand(self):
        params, j_cfg, model, cfg = _pair("dlrm-rm2")
        (v, i), tm = retrieve_cand(cfg, k=5, device="cpu", seed=7,
                                   model=model)
        b = ctr_batch(7, 0, 1, cfg.n_dense, cfg.n_sparse, cfg.table_rows)
        want_v, want_i = j_recsys.retrieve_topk(
            params, j_cfg, jnp.asarray(b["dense"].numpy()),
            jnp.asarray(b["sparse_ids"].numpy()), k=5)
        _close(v, want_v)
        _ids_agree(i.numpy(), want_i, want_v)
        assert set(tm) == {"retrieve_s"}

    def test_ties_go_to_the_lowest_id(self):
        """A constructed tie fixture against jax.lax.top_k: equal scores
        rank by ascending id, as the reference's top_k ranks them."""
        scores = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5, 0.9, 0.0],
                           [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]],
                          np.float32)
        want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 5)
        v, i = topk_lowest_index(torch.from_numpy(scores), 5)
        np.testing.assert_array_equal(v.numpy(), want_v)
        np.testing.assert_array_equal(i.numpy(), want_i)
        assert i[0].tolist() == [1, 3, 6, 0, 2]

    def test_tied_items_through_the_head(self):
        """Item rows 5 and 10-19 equal and the best for the user: the
        head returns the tied ids in ascending order, as the reference
        does.  The user's feature-0 id avoids those rows, so the user
        vector does not depend on them."""
        params, j_cfg, model, cfg = _pair("dcn-v2")
        b, jb = _batch(cfg, 1, seed=8)
        b["sparse_ids"][:, 0] = 0
        jb["sparse_ids"] = jnp.asarray(b["sparse_ids"].numpy())
        u = np.asarray(j_recsys.user_tower(params, j_cfg, None,
                                           jb["sparse_ids"]))
        tables = np.array(params["tables"])
        tables[0, [5, *range(10, 20)]] = 100 * u[0]
        params = dict(params, tables=jnp.asarray(tables))
        with torch.no_grad():
            model.tables.copy_(torch.from_numpy(tables.reshape(
                -1, tables.shape[-1])))
        want_v, want_i = j_recsys.retrieve_topk(params, j_cfg, None,
                                                jb["sparse_ids"], k=12)
        v, i = recsys.retrieve_topk(model, None, b["sparse_ids"], k=12)
        _close(v, want_v)
        np.testing.assert_array_equal(i.numpy(), want_i)
        assert i[0, :11].tolist() == [5, *range(10, 20)]
