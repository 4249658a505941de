"""The port's HPF/PF, SKMeans, FM and SANSA against the JAX package's, on
the CPU.

- SANSA: W1 and W2 equal to the JAX package's exactly (the same host
  float64 factorisation), over both factorizers; ``score``,
  ``score_batch``, ``score_pairs``, ``forward`` and the ANN vectors within
  rtol 1e-6 (the port multiplies on the device with ``torch.sparse``,
  scipy on the host).
- SKMeans: the same partition and the same iteration count as the JAX
  ``while_loop``, centroids within rtol 1e-5 / atol 1e-7.
- HPF and PF: the initial tables byte-identical; three sweeps within rtol
  1e-5 / atol 1e-7 (digamma and the scatter's order of sums differ by
  ulps); the whole 100-sweep fit's Theta and Beta within rtol 1e-3 / atol
  1e-6 (the ulps compound over the sweeps: 1.5e-4 at most on these data)
  and its ranking metrics within 1e-3.
- FM: one SGD epoch on the JAX package's own permutation
  (``permutation(fold_in(key, e), n_total) % n``), sgd and sgda, within
  rtol 1e-5 / atol 1e-6; one MCMC sweep on the JAX package's own gamma and
  normal draws within rtol 1e-4 / atol 1e-5 (the sweep divides by sums
  over every case); ``_seg_sum`` within rtol 1e-6 / atol 1e-5; the whole
  ALS fit (20 sweeps) within rtol 1e-3 / atol 1e-3 (the float32
  cumulative sums differ in order); ``score_pairs`` and ``score_batch`` on
  the same tables within rtol 1e-12.
- ``convert``: a JAX fit's arrays carried into the port score the same.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.eval_methods import RatioSplit as JRatioSplit
from cornac_tpu.experiment import Experiment as JExperiment
from cornac_tpu.metrics import AUC as JAUC, MAE as JMAE, NDCG as JNDCG, RMSE as JRMSE
import cornac_tpu.models as J
from cornac_tpu.models.fm import _fm_mcmc as j_fm_mcmc
from cornac_tpu.models.fm import _fm_sgd as j_fm_sgd, _seg_sum as j_seg_sum
from cornac_tpu.models.hpf import _hpf_cavi as j_hpf_cavi
from cornac_tpu.models.skm import _skmeans_fit as j_skmeans_fit
from cornac_tpu.utils import get_rng as j_get_rng
from cornac_tpu.utils.init_utils import gamma as j_gamma
from cornac_tpu_torch import Experiment
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import factor_model_from_arrays, sansa_from_arrays
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.eval_methods import RatioSplit
from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE
from cornac_tpu_torch.models import fm as fm_mod, hpf as hpf_mod, skm as skm_mod
from cornac_tpu_torch.utils.init_utils import gamma

cornac_tpu_torch.set_default_device("cpu")

SWEEPS = dict(rtol=1e-5, atol=1e-7)


def _uir(seed=5, n_users=90, n_items=70, n=2000):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    ub, ib = rng.normal(0, 0.7, n_users), rng.normal(0, 0.7, n_items)
    return [(f"u{u}", f"i{i}",
             float(np.clip(np.rint(3.5 + ub[u] + ib[i] + rng.normal(0, 0.5)), 1, 5)))
            for u, i in pairs]


@pytest.fixture(scope="module")
def sets():
    data = _uir()
    return JDataset.from_uir(data, seed=1), Dataset.from_uir(data, seed=1)


def _meta(model):
    return {name: getattr(model, name) for name in (
        "num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
        "global_mean")}


# ------------------------------------------------------------------- SANSA


@pytest.mark.parametrize("factorizer", ["ICF", "CHOLMOD"])
def test_sansa_weights_exact_and_scores(sets, factorizer):
    jd, pd = sets
    kw = dict(l2=5.0, weight_matrix_density=0.1, factorizer_class=factorizer, verbose=False)
    j = J.SANSA(**kw).fit(jd)
    p = P.SANSA(**kw).fit(pd)
    for a, b in zip(j.weights, p.weights):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    users = np.array([0, 3, 17, 40, pd.num_users - 1])
    np.testing.assert_allclose(p.score_batch(users), j.score_batch(users), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(p.score(3), j.score(3), rtol=1e-6, atol=1e-12)
    assert p.score(3, 5) == pytest.approx(j.score(3, 5), rel=1e-6, abs=1e-12)
    rows = pd.matrix[users]
    np.testing.assert_allclose(p.forward(rows).numpy(), j.forward(rows).toarray(),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(p.get_user_vectors(), j.get_user_vectors(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(p.get_item_vectors(), j.get_item_vectors())
    pairs = (np.array([0, 3, 3, 17, -1, 2]), np.array([1, 5, 0, 9, 2, pd.num_items + 3]))
    np.testing.assert_allclose(p.score_pairs(*pairs), j.score_pairs(*pairs), rtol=1e-6,
                               atol=1e-12)


def test_sansa_absolute_scores_and_convert(sets):
    jd, pd = sets
    j = J.SANSA(l2=5.0, weight_matrix_density=0.1, use_absolute_value_scores=True,
                verbose=False).fit(jd)
    arrays = {}
    for name, M in (("W1", j.weights[0]), ("W2", j.weights[1]), ("U", j.U)):
        arrays.update({f"{name}_data": M.data, f"{name}_indices": M.indices,
                       f"{name}_indptr": M.indptr, f"{name}_shape": M.shape})
    p = sansa_from_arrays(arrays, {"use_absolute_value_scores": True, **_meta(j)}, device="cpu")
    users = np.arange(pd.num_users)
    np.testing.assert_allclose(p.score_batch(users), j.score_batch(users), rtol=1e-6,
                               atol=1e-12)
    assert (p.score_batch(users) >= 0).all()


def test_sansa_catalog_gate(monkeypatch):
    # compute_gramian=False factorizes the given item-item matrix itself:
    # the gate is reached without the Gramian's product
    n = 32769
    X = sp.identity(n, format="csr", dtype=np.float32)
    ds = Dataset.from_uir([("u0", "i0", 1.0)], seed=1)
    monkeypatch.setattr(type(ds), "matrix", property(lambda self: X))
    with pytest.raises(ValueError, match="gated to catalogs <= 32768 items"):
        P.SANSA(compute_gramian=False, factorizer_class="CHOLMOD", verbose=False).fit(ds)


# ----------------------------------------------------------------- SKMeans


@pytest.mark.parametrize("seed", [3, 8])
def test_skmeans_loop_stops_where_jax_stops(sets, seed):
    jd, pd = sets
    X = np.asarray(pd.matrix.todense(), np.float32)
    X = X / (np.linalg.norm(X, axis=1, keepdims=True) + 1e-20)
    par0 = np.random.RandomState(seed).randint(5, size=X.shape[0])
    jMU, jpar, jl, jit = j_skmeans_fit(jnp.asarray(X), jnp.asarray(par0, jnp.int32), k=5,
                                       max_iter=jnp.int32(100), tol=jnp.float32(1e-6))
    MU, par, lik, it = skm_mod._skmeans_fit(torch.as_tensor(X), torch.as_tensor(par0), 5, 100,
                                            1e-6)
    assert it == int(jit) > 1
    np.testing.assert_array_equal(par.numpy(), np.asarray(jpar))
    np.testing.assert_allclose(MU.numpy(), np.asarray(jMU), rtol=1e-5, atol=1e-7)
    assert float(lik) == pytest.approx(float(jl), rel=1e-6)
    # a cut loop stops at max_iter
    assert skm_mod._skmeans_fit(torch.as_tensor(X), torch.as_tensor(par0), 5, 1, 1e-6)[3] == 1


def test_skmeans_fit_and_scores(sets):
    jd, pd = sets
    j = J.SKMeans(k=5, max_iter=100, seed=3, verbose=False).fit(jd)
    p = P.SKMeans(k=5, max_iter=100, seed=3, verbose=False).fit(pd)
    np.testing.assert_array_equal(p.final_par, j.final_par)
    np.testing.assert_allclose(p.centroids, j.centroids, rtol=1e-5, atol=1e-7)
    users = np.array([0, 5, 11, -1, pd.num_users + 4])
    np.testing.assert_allclose(p.score_batch(users), j.score_batch(users), rtol=1e-5, atol=1e-7)
    conv = factor_model_from_arrays("SKMeans", {"centroids": j.centroids,
                                                "user_center_sim": j.user_center_sim},
                                    {"k": 5, **_meta(j)}, device="cpu")
    np.testing.assert_allclose(conv.score_batch(users), j.score_batch(users), rtol=1e-12)
    np.testing.assert_allclose(conv.score_batch_device(users[:3]).numpy(),
                               j.score_batch(users[:3]), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------- HPF


@pytest.mark.parametrize("hierarchical", [True, False])
def test_hpf_initial_tables_and_three_sweeps(sets, hierarchical):
    jd, pd = sets
    model = P.HPF(k=5, seed=7, hierarchical=hierarchical)
    model.num_users, model.num_items = pd.num_users, pd.num_items
    tables = model._initial_tables()
    rng = j_get_rng(7)
    a_, b_ = (0.3, 0.3) if hierarchical else (0.3, 1.0)
    for t, rows in zip(tables, (pd.num_users, pd.num_users, pd.num_items, pd.num_items)):
        want = j_gamma((rows, 5), shape_param=a_, scale_param=b_ / a_, random_state=rng,
                       dtype=np.float64)
        np.testing.assert_array_equal(t, want)
    assert gamma((3, 2), 0.3, 1.0, random_state=1).dtype == np.float32

    rid, cid, val = pd.uir_tuple
    f32 = [np.asarray(t, np.float32) for t in tables]
    f32 += [np.ones(pd.num_users, np.float32), np.ones(pd.num_items, np.float32)]
    want = j_hpf_cavi(*(jnp.asarray(t.copy()) for t in f32), jnp.asarray(rid, jnp.int32),
                      jnp.asarray(cid, jnp.int32), jnp.asarray(val, jnp.float32), jnp.int32(3),
                      hierarchical=hierarchical)
    got = hpf_mod._hpf_cavi(*(torch.tensor(t) for t in f32), torch.as_tensor(rid),
                            torch.as_tensor(cid), torch.as_tensor(val, dtype=torch.float32), 3,
                            hierarchical)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SWEEPS)


@pytest.mark.parametrize("hierarchical", [True, False])
def test_hpf_whole_fit(hierarchical, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the experiments' logs
    data = _uir(seed=11)
    kw = dict(k=5, max_iter=100, seed=123, hierarchical=hierarchical)
    j_split = JRatioSplit(data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False)
    p_split = RatioSplit(data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False)
    jm, pm = J.HPF(**kw), P.HPF(**kw)
    JExperiment(j_split, [jm], [JAUC(), JNDCG(k=10)]).run()
    Experiment(p_split, [pm], [AUC(), NDCG(k=10)]).run()
    np.testing.assert_allclose(pm.Theta, jm.Theta, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(pm.Beta, jm.Beta, rtol=1e-3, atol=1e-6)
    for name in ("AUC", "NDCG@10"):
        assert abs(pm_metric(pm, p_split, name) - pm_metric(jm, j_split, name)) < 1e-3
    users = np.arange(10)
    conv = factor_model_from_arrays("HPF", {"Theta": jm.Theta, "Beta": jm.Beta},
                                    {"k": 5, "hierarchical": hierarchical, **_meta(jm)},
                                    device="cpu")
    np.testing.assert_allclose(conv.score_batch(users), jm.score_batch(users), rtol=1e-6)
    pairs = (np.array([0, 1, 2, -1]), np.array([3, 4, 10**6, 0]))
    np.testing.assert_allclose(conv.score_pairs(*pairs), jm.score_pairs(*pairs), rtol=1e-12)


def pm_metric(model, split, name):
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval
    from cornac_tpu_torch.metrics import AUC, NDCG

    metric = {"AUC": AUC(), "NDCG@10": NDCG(k=10)}[name]
    return ranking_eval(model, [metric], split.train_set, split.test_set,
                        rating_threshold=4.0)[0][0]


def test_mesh_raises():
    # mesh= is ported (tests/test_torch_parallel_models.py): anything but a
    # parallel.make_mesh mesh is refused
    for make in (lambda: P.HPF(mesh=object()), lambda: P.FM(mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make()


# ---------------------------------------------------------------------- FM


def _fm_inputs(pd, k2=4, seed=2):
    rng = np.random.RandomState(seed)
    n_feat = pd.num_users + pd.num_items
    rid, cid, val = pd.uir_tuple
    cid_off = np.asarray(cid, np.int64) + pd.num_users
    w = rng.normal(0, 0.1, n_feat).astype(np.float32)
    V = rng.normal(0, 0.1, (n_feat, k2)).astype(np.float32)
    return n_feat, np.asarray(rid, np.int64), cid_off, np.asarray(val, np.float32), w, V


@pytest.mark.parametrize("method", ["sgd", "sgda"])
def test_fm_one_sgd_epoch_on_jax_permutation(sets, method, bs=512, lr=0.01,
                                             regs=(0.01, 0.02, 0.03)):
    jd, pd = sets
    n_feat, rid, cid_off, val, w, V = _fm_inputs(pd)
    n = len(val)
    n_total = n + (-n) % bs
    key = jax.random.PRNGKey(31)
    jw0, jw, jV, jloss = j_fm_sgd(
        jnp.float32(0.2), jnp.asarray(w.copy()), jnp.asarray(V.copy()), key,
        jnp.asarray(rid, jnp.int32), jnp.asarray(cid_off, jnp.int32), jnp.asarray(val),
        jnp.float32(lr), tuple(jnp.float32(r) for r in regs), batch_size=bs, use_w0=True,
        use_w=True, use_v=True, n_epochs=jnp.int32(1))
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(key, 0), n_total)) % n
    pad_mask = (np.arange(n_total) < n).astype(np.float32)
    w0, pw, pV, loss = fm_mod._fm_sgd_epoch(
        torch.tensor(0.2), torch.tensor(w), torch.tensor(V), torch.as_tensor(perm, dtype=torch.long),
        torch.as_tensor(rid), torch.as_tensor(cid_off), torch.as_tensor(val),
        torch.as_tensor(pad_mask), lr, regs, bs, True, True, True)
    assert float(w0) == pytest.approx(float(jw0), rel=1e-5, abs=1e-6)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pV.numpy(), np.asarray(jV), rtol=1e-5, atol=1e-6)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def _jax_blocks(pd, rid, cid_off):
    model = J.FM(k2=4)
    model.w = np.zeros(pd.num_users + pd.num_items, np.float32)
    return model._make_blocks(rid, cid_off)


def test_fm_seg_sum(sets):
    jd, pd = sets
    n_feat, rid, cid_off, val, w, V = _fm_inputs(pd)
    x = np.random.RandomState(4).normal(size=(len(val), 2)).astype(np.float32)
    for jb, pb in zip(_jax_blocks(pd, rid, cid_off), fm_mod.make_blocks(rid, cid_off, n_feat,
                                                                       "cpu")):
        want = j_seg_sum(jnp.asarray(x), jb[1], jb[2], jb[3])
        got = fm_mod._seg_sum(torch.as_tensor(x), pb.perm, pb.starts, pb.ends)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(pb.cnt.numpy(), np.asarray(jb[4]))


def test_fm_one_mcmc_sweep_on_jax_draws(sets, regs=(0.01, 0.05, 0.1)):
    jd, pd = sets
    n_feat, rid, cid_off, val, w, V = _fm_inputs(pd)
    n, k2 = len(val), V.shape[1]
    key = jax.random.PRNGKey(17)
    jblocks = _jax_blocks(pd, rid, cid_off)
    jw0, jw, jV = j_fm_mcmc(
        jnp.float32(0.3), jnp.asarray(w), jnp.asarray(V), key, jnp.asarray(val), jblocks[0][0],
        jblocks[1][0], jblocks, *(jnp.float32(r) for r in regs), use_w0=True, use_w=True,
        use_v=True, n_feat=n_feat, n_sweeps=jnp.int32(1))

    # the sweep's draws, made as _fm_mcmc makes them from fold_in(key, 0)
    ks = jax.random.fold_in(key, 0)
    fold = jax.random.fold_in
    a_alpha, a_w, a_v = (jnp.float32(1.0) + n) / 2.0, (jnp.float32(1.0) + n_feat + 1) / 2.0, \
        (jnp.float32(1.0) + n_feat + 1) / 2.0
    t = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    draws = fm_mod.McmcDraws(
        g_alpha=t(jax.random.gamma(fold(ks, 0), a_alpha)),
        z_w0=t(jax.random.normal(fold(ks, 1))),
        g_w_lambda=t(jax.random.gamma(fold(ks, 2), a_w)),
        z_w_mu=t(jax.random.normal(fold(ks, 3))),
        z_w=t(np.stack([np.asarray(jax.random.normal(fold(ks, 4 + j), (n_feat,)))
                        for j in range(2)])),
        g_v_lambda=t(jax.random.gamma(fold(ks, 6), a_v)),
        z_v_mu=t(jax.random.normal(fold(ks, 7), (k2,))),
        z_v=t(np.stack([[np.asarray(jax.random.normal(fold(fold(ks, 8 + j), f), (n_feat,)))
                         for j in range(2)] for f in range(k2)])),
    )
    assert fm_mod.mcmc_shapes(n, n_feat) == (float(a_alpha), float(a_w), float(a_v))
    blocks = fm_mod.make_blocks(rid, cid_off, n_feat, "cpu")
    state = fm_mod.mcmc_initial_state(torch.tensor(0.3), torch.tensor(w), torch.tensor(V),
                                      regs[1], regs[2])
    out = fm_mod._fm_mcmc_sweep(state, draws, torch.as_tensor(val), blocks, regs[0],
                                use_w0=True, use_w=True, use_v=True, n_feat=n_feat)
    assert float(out[0]) == pytest.approx(float(jw0), rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jw), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(jV), rtol=1e-4, atol=1e-5)


def test_fm_whole_als_fit(sets):
    jd, pd = sets
    kw = dict(k2=4, max_iter=20, method="als", reg1=0.1, reg2=0.2, seed=3, verbose=False)
    j = J.FM(**kw).fit(jd)
    p = P.FM(**kw).fit(pd)
    assert p.w0 == pytest.approx(j.w0, rel=1e-5)
    np.testing.assert_allclose(p.w, j.w, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(p.V, j.V, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("method", ["als", "mcmc", "sgd"])
def test_fm_scores_on_the_same_tables(sets, method):
    jd, pd = sets
    j = J.FM(k2=4, max_iter=3, method=method, seed=3, verbose=False).fit(jd)
    p = factor_model_from_arrays("FM", {"w0": np.asarray(j.w0), "w": j.w, "V": j.V},
                                 {"k0": 1, "k1": 1, "k2": 4, "method": method, **_meta(j)},
                                 device="cpu")
    users = np.array([0, 2, 9, -1, pd.num_users + 1])
    items = np.array([1, 0, 5, 3, 2])
    np.testing.assert_allclose(p.score_pairs(users, items), j.score_pairs(users, items),
                               rtol=1e-12)
    np.testing.assert_allclose(p.score_batch(users), j.score_batch(users), rtol=1e-12)
    np.testing.assert_allclose(p.score(4), j.score(4), rtol=1e-12)


@pytest.mark.parametrize("method", ["sgd", "mcmc", "als"])
def test_fm_seeded_fits_repeat(sets, method):
    jd, pd = sets
    fits = [P.FM(k2=4, max_iter=3, method=method, seed=5, verbose=False).fit(pd)
            for _ in range(2)]
    np.testing.assert_array_equal(fits[0].V, fits[1].V)
    np.testing.assert_array_equal(fits[0].w, fits[1].w)
    assert np.isfinite(fits[0].V).all()


# -------------------------------------------------------------- Experiment


def test_experiment_deterministic_models_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the experiments' logs
    data = _uir(seed=13)
    makers = [
        lambda m: m.SKMeans(k=5, max_iter=100, seed=123, verbose=False),
        lambda m: m.FM(k2=4, max_iter=10, method="als", seed=123, verbose=False),
        lambda m: m.SANSA(l2=5.0, weight_matrix_density=0.1, verbose=False),
    ]
    j_split = JRatioSplit(data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False)
    p_split = RatioSplit(data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False)
    jexp = JExperiment(j_split, [make(J) for make in makers],
                       [JAUC(), JNDCG(k=10), JRMSE(), JMAE()])
    pexp = Experiment(p_split, [make(P) for make in makers], [AUC(), NDCG(k=10), RMSE(), MAE()])
    jexp.run()
    pexp.run()
    for jr, pr in zip(jexp.result, pexp.result):
        for name in ("AUC", "NDCG@10", "RMSE", "MAE"):
            assert abs(pr.metric_avg_results[name] - jr.metric_avg_results[name]) < 1e-4, \
                (pr.model_name, name)


def test_sansa_clone_where_jax_raises(sets):
    # the JAX package's clone() reads the constructor's W1 and W2 back,
    # which SANSA keeps only in ``weights`` (ROADMAP.md C); the port's
    # properties let CrossValidation and the searches clone it
    with pytest.raises(AttributeError, match="W1"):
        J.SANSA().clone()
    jd, pd = sets
    fitted = P.SANSA(l2=5.0, weight_matrix_density=0.1, verbose=False).fit(pd)
    fresh = P.SANSA(l2=7.0, verbose=False).clone({"l2": 5.0, "weight_matrix_density": 0.1})
    assert fresh.l2 == 5.0 and fresh.weights == (None, None)
    refit = fresh.fit(pd)
    for a, b in zip(fitted.weights, refit.weights):
        assert (a != b).nnz == 0
