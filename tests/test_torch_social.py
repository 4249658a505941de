"""The port's SBPR, VEBPR and C2PF against the JAX package's, on the CPU.

- SBPR's social positives (``social_items``, one sparse product) equal to
  the JAX package's per-user loop (``_prepare_social_data``), byte for
  byte, on a graph with self loops, duplicate and zero-valued edges.
- One SBPR and one VEBPR minibatch (the whole train set in one minibatch,
  so ids repeat within it) on the JAX package's own draws (drawn in the
  test from the fit's key, as ``_sbpr_epochs`` / ``_vebpr_epochs`` draw
  them): U, V and the bias within rtol 1e-5 / atol 1e-6. The port sums the
  item-factor updates of [i; j; k] in one ``accumulate_rows`` call where
  the JAX package makes three scatters, and ``accumulate_rows`` adds each
  row's summed updates once where XLA adds them one by one: float32
  rounding apart. The three bias scatters read the table the one before
  wrote, in both packages; a version that read the old bias is held to
  differ.
- C2PF, each variant: the initial tables bit for bit; 1 and 3 sweeps of
  each phase's prior from the same tables within rtol 2e-5 / atol 1e-7
  (digamma, the sums over k and the scatters' order of sums differ by
  ulps); the whole fit's train AUC within 1e-3 of the JAX package's; Xi
  and the vectors as the JAX package derives them.
- Whole SBPR and VEBPR fits in the band of the JAX package's CPU fits
  (``tools/quality_bands.py``, seeds 123-127).
- ``convert``: JAX fits' arrays carried into the port score as the JAX
  models do.
- C2PF's ``recommend_batch`` ranks as the JAX package's does (by the
  vector accessors, not by ``score``: ROADMAP.md C), list for list.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
from cornac_tpu.models.c2pf import _c2pf_cavi as j_c2pf_cavi
from cornac_tpu.models.sbpr import _sbpr_epochs as j_sbpr_epochs
from cornac_tpu.models.vebpr import _vebpr_epochs as j_vebpr_epochs
from cornac_tpu.ops.membership import build_membership as j_build_membership
from cornac_tpu.utils import get_rng as j_get_rng
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import bpr_from_arrays, c2pf_from_arrays
from cornac_tpu_torch.models import c2pf as c2pf_mod, sbpr as sbpr_mod, vebpr as vebpr_mod
from cornac_tpu_torch.ops.membership import build_membership

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import golden_models as g  # noqa: E402
from bpr_quality_band import GOLDEN_CONFIGS, golden_split  # noqa: E402
from quality_bands import band  # noqa: E402

cornac_tpu_torch.set_default_device("cpu")

STEP = dict(rtol=1e-5, atol=1e-6)
SWEEPS = dict(rtol=2e-5, atol=1e-7)

_SNAPSHOT = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
             "global_mean")


@pytest.fixture(scope="module")
def splits():
    """(JAX split, port split) of each golden kind, built alike."""
    return {kind: (golden_split(kind, jdata, jeval), golden_split(kind, pdata, peval))
            for kind in ("user_graph", "item_graph", "purchase_view")}


def _meta(model, **extra):
    return {**{name: getattr(model, name) for name in _SNAPSHOT}, **extra}


# ---------------------------------------------------------------------- SBPR


def test_social_items_equal_the_reference_loop():
    rng = np.random.RandomState(3)
    n_users, n_items = 30, 25
    X = sp.random(n_users, n_items, density=0.2, random_state=rng, format="csr")
    X.data[:3] = 0.0  # stored zeros count as rated, in both
    rows = np.concatenate([rng.randint(n_users, size=120), np.arange(5)])
    cols = np.concatenate([rng.randint(n_users + 4, size=120), np.arange(5)])  # self loops
    vals = rng.choice([0.0, 1.0, 2.0], size=len(rows))
    Y = sp.csr_matrix((vals, (rows, cols)), shape=(n_users + 4, n_users + 4))

    class Graph:
        matrix = Y

    class Train:
        csr_matrix = X
        user_graph = Graph()

    jm = J.SBPR()
    jm.num_users = n_users
    want = jm._prepare_social_data(Train())
    got = sbpr_mod.social_items(X, Y[:n_users, :n_users])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def _jax_draws(key, n, num_items):
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 0), 3)
    return (np.asarray(jax.random.randint(k1, (n,), 0, n)),
            np.asarray(jax.random.randint(k2, (n,), 0, num_items)),
            np.asarray(jax.random.uniform(k3, (n,))))


@pytest.mark.parametrize("use_bias", [True, False])
def test_sbpr_one_minibatch_on_jax_draws(splits, use_bias):
    jsplit, psplit = splits["user_graph"]
    jt, pt = jsplit.train_set, psplit.train_set
    kw = dict(k=8, learning_rate=0.05, lambda_u=0.02, lambda_v=0.03, lambda_b=0.04,
              use_bias=use_bias, seed=5)
    jm, pm = J.SBPR(**kw), P.SBPR(**kw)
    J.Recommender.fit(jm, jt)
    P.Recommender.fit(pm, pt)
    jm._init()
    pm._init()
    np.testing.assert_array_equal(pm.u_factors, jm.u_factors)
    np.testing.assert_array_equal(pm.i_factors, jm.i_factors)
    if use_bias:  # a bias that moves away from zero, so the sequential reads matter
        pm.i_biases = jm.i_biases = np.linspace(-0.5, 0.5, jt.num_items).astype(np.float32)

    social = jm._prepare_social_data(jt)
    rid, cid, _ = jt.uir_tuple
    n = len(rid)
    key = jax.random.PRNGKey(11)
    U, V, Bi = j_sbpr_epochs(
        jnp.asarray(jm.u_factors), jnp.asarray(jm.i_factors), jnp.asarray(jm.i_biases), key,
        jnp.asarray(rid, jnp.int32), jnp.asarray(cid, jnp.int32),
        j_build_membership(jt.csr_matrix), *(jnp.asarray(a) for a in social),
        jnp.float32(0.05), jnp.float32(0.02), jnp.float32(0.03), jnp.float32(0.04),
        batch_size=n, num_items=jt.num_items, n_epochs=jnp.int32(1), use_bias=use_bias)

    draws = [tuple(torch.as_tensor(a) for a in _jax_draws(key, n, jt.num_items))]
    pairs = torch.as_tensor(np.stack([rid, cid], 1).astype(np.int64))
    tables = [torch.tensor(np.asarray(a, np.float32))
              for a in (pm.u_factors, pm.i_factors, pm.i_biases)]
    soc = tuple(torch.as_tensor(np.asarray(a, np.int64)) for a in pm._prepare_social_data(pt))
    hyper = (0.05, 0.02, 0.03, 0.04)
    sbpr_mod._sbpr_epoch(*tables, draws, pairs, build_membership(pt.csr_matrix, device="cpu"),
                         soc, n, hyper, n, use_bias)
    for got, want in zip(tables, (U, V, Bi)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    assert np.abs(tables[0].numpy() - pm.u_factors).max() > 1e-3  # the step moved U

    if use_bias:
        # the same step with the three bias updates deferred to its end, so
        # that each reads the bias as it was before the step, lands
        # elsewhere: the sequential reads are part of what is computed
        orig, calls, deferred = sbpr_mod.accumulate_rows, [], []

        def deferring(table, ids, updates):
            calls.append(table.dim())
            if table.dim() == 1:
                deferred.append((ids, updates))
                return table
            return orig(table, ids, updates)

        stale = [torch.tensor(np.asarray(a, np.float32))
                 for a in (pm.u_factors, pm.i_factors, pm.i_biases)]
        sbpr_mod.accumulate_rows = deferring
        try:
            sbpr_mod._sbpr_epoch(*stale, draws, pairs,
                                 build_membership(pt.csr_matrix, device="cpu"), soc, n, hyper,
                                 n, use_bias)
        finally:
            sbpr_mod.accumulate_rows = orig
        for ids, upd in deferred:
            orig(stale[2], ids, upd)
        assert calls == [2, 2, 1, 1, 1]  # U, V over [i; j; k], then the bias at i, j, k
        assert np.abs(stale[2].numpy() - np.asarray(Bi)).max() > 100 * STEP["atol"]


def test_sbpr_needs_the_user_graph(splits):
    jsplit, psplit = splits["item_graph"]
    with pytest.raises(ValueError, match="user_graph"):
        P.SBPR(max_iter=1, seed=1).fit(psplit.train_set)


# --------------------------------------------------------------------- VEBPR


def test_vebpr_one_minibatch_on_jax_draws(splits):
    jsplit, psplit = splits["purchase_view"]
    jt, pt = jsplit.train_set, psplit.train_set
    np.testing.assert_array_equal(pt.view_matrix.toarray(), jt.view_matrix.toarray())
    kw = dict(k=8, learning_rate=0.05, lambda_reg=0.02, alpha=0.3, seed=5)
    jm, pm = J.VEBPR(**kw), P.VEBPR(**kw)
    J.Recommender.fit(jm, jt)
    P.Recommender.fit(pm, pt)
    jm._init()
    pm._init()
    np.testing.assert_array_equal(pm.u_factors, jm.u_factors)

    rid, cid, _ = jt.uir_tuple
    n = len(rid)
    view = jt.view_matrix.tocsr()
    key = jax.random.PRNGKey(13)
    U, V = j_vebpr_epochs(
        jnp.asarray(jm.u_factors), jnp.asarray(jm.i_factors), key,
        jnp.asarray(rid, jnp.int32), jnp.asarray(cid, jnp.int32),
        j_build_membership(jt.csr_matrix), j_build_membership(view),
        jnp.asarray(view.indices, jnp.int32), jnp.asarray(view.indptr, jnp.int32),
        jnp.float32(0.05), jnp.float32(0.02), jnp.float32(0.3),
        batch_size=n, num_items=jt.num_items, n_epochs=jnp.int32(1))

    draws = [tuple(torch.as_tensor(a) for a in _jax_draws(key, n, jt.num_items))]
    pairs = torch.as_tensor(np.stack([rid, cid], 1).astype(np.int64))
    tables = [torch.tensor(np.asarray(a, np.float32)) for a in (pm.u_factors, pm.i_factors)]
    pview = pt.view_matrix.tocsr()
    views = (torch.as_tensor(pview.indices.astype(np.int64)),
             torch.as_tensor(pview.indptr.astype(np.int64)))
    vebpr_mod._vebpr_epoch(*tables, draws, pairs, build_membership(pt.csr_matrix, device="cpu"),
                           build_membership(pview, device="cpu"), views, n, (0.05, 0.02, 0.3), n)
    for got, want in zip(tables, (U, V)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    assert np.abs(tables[0].numpy() - pm.u_factors).max() > 1e-3


def test_purchase_view_dataset_matches_jax():
    purchases, views = g.implicit_data(seed=3), g.implicit_data(seed=4, n=800)
    jt = jdata.PurchaseViewDataset.build(purchases, views, seed=7)
    pt = pdata.PurchaseViewDataset.build(purchases, views, seed=7)
    assert list(pt.uid_map.items()) == list(jt.uid_map.items())
    assert list(pt.iid_map.items()) == list(jt.iid_map.items())
    for a, b in zip(pt.uir_tuple, jt.uir_tuple):
        np.testing.assert_array_equal(a, b)
    for a, b in ((pt.view_matrix, jt.view_matrix), (pt.matrix, jt.matrix)):
        a, b = a.tocsr(), b.tocsr()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    base = pdata.Dataset.build(purchases, seed=7)
    attached = pdata.PurchaseViewDataset.attach_view(base, views)
    jattached = jdata.PurchaseViewDataset.attach_view(jdata.Dataset.build(purchases, seed=7),
                                                      views)
    np.testing.assert_array_equal(attached.view_matrix.toarray(),
                                  jattached.view_matrix.toarray())
    with pytest.raises(ValueError, match="PurchaseViewDataset"):
        P.VEBPR(max_iter=1, seed=1).fit(base)


# ------------------------------------------------------------- whole fits


@pytest.mark.parametrize("name", ["SBPR", "VEBPR"])
def test_whole_sampled_fits_in_the_jax_band(splits, name):
    cls, kwargs, _, kind = GOLDEN_CONFIGS[name]
    train = splits[kind][1].train_set
    model = getattr(P, cls)(seed=123, **kwargs).fit(train)
    lo, hi, _, _ = band(name, "AUC")
    assert lo <= g.train_auc(model, train) <= hi


# ---------------------------------------------------------------------- C2PF


def _c2pf_inputs(split, model):
    train = split.train_set
    model.num_users, model.num_items = train.num_users, train.num_items
    gi, gj, gv = model._context_edges(train)
    util = np.zeros(train.num_items, np.float32)
    np.add.at(util, np.asarray(gj, np.int64), np.asarray(gv, np.float32))
    return train, gi, gj, util


@pytest.mark.parametrize("variant", ["c2pf", "tc2pf", "rc2pf"])
def test_c2pf_initial_tables_and_sweeps(splits, variant):
    jsplit, psplit = splits["item_graph"]
    pm = P.C2PF(k=6, seed=9, variant=variant)
    train, gi, gj, util = _c2pf_inputs(psplit, pm)
    state = pm._initial_state(len(gi))
    rng = j_get_rng(9)
    n, d, k = train.num_users, train.num_items, 6
    for name, rows, scale in (("G_s", n, 0.3), ("G_r", n, 0.3), ("L_s", d, 0.3),
                              ("L_r", d, 0.3), ("L2_s", d, 0.3), ("L2_r", d, 0.3)):
        want = rng.gamma(100, scale=scale / 100, size=(rows, k)).astype(np.float32)
        np.testing.assert_array_equal(state[name], want)
    for name in ("l3_s", "l3_r"):
        want = rng.gamma(100, scale=0.5 / 100, size=len(gi)).astype(np.float32)
        np.testing.assert_array_equal(state[name], want)

    u, i, x = train.uir_tuple
    bt = 5.0 if variant == "c2pf" else 4.0
    for a_t, b_t in ((1e15, 1e15), (2.0, bt)):
        for sweeps in (1, 3):
            want = j_c2pf_cavi(
                {name: jnp.asarray(a) for name, a in state.items()},
                jnp.asarray(u, jnp.int32), jnp.asarray(i, jnp.int32),
                jnp.asarray(x, jnp.float32), jnp.asarray(gi, jnp.int32),
                jnp.asarray(gj, jnp.int32), jnp.ones(len(gi), jnp.float32), jnp.asarray(util),
                jnp.float32(a_t), jnp.float32(b_t), variant, sweeps)
            got = c2pf_mod._c2pf_cavi(
                {name: torch.as_tensor(a) for name, a in state.items()},
                torch.as_tensor(np.asarray(u, np.int64)), torch.as_tensor(np.asarray(i, np.int64)),
                torch.as_tensor(np.asarray(x, np.float32)),
                torch.as_tensor(np.asarray(gi, np.int64)),
                torch.as_tensor(np.asarray(gj, np.int64)), torch.as_tensor(util), a_t, b_t,
                variant, sweeps)
            for name in c2pf_mod._TABLES:
                np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                           err_msg=f"{name}, prior {a_t}, {sweeps} sweep(s)",
                                           **SWEEPS)


@pytest.fixture(scope="module")
def c2pf_fits(splits):
    """JAX and port whole fits of the golden C2PF, each variant."""
    jsplit, psplit = splits["item_graph"]
    fits = {}
    for variant in ("c2pf", "tc2pf", "rc2pf"):
        kw = dict(k=8, max_iter=40, variant=variant, seed=123)
        fits[variant] = (J.C2PF(**kw).fit(jsplit.train_set), P.C2PF(**kw).fit(psplit.train_set))
    return fits


@pytest.mark.parametrize("variant", ["c2pf", "tc2pf", "rc2pf"])
def test_c2pf_whole_fit_matches_jax(splits, c2pf_fits, variant):
    jm, pm = c2pf_fits[variant]
    train = splits["item_graph"][1].train_set
    assert abs(g.train_auc(pm, train) - g.train_auc(jm, splits["item_graph"][0].train_set)) < 1e-3
    lo, hi, _, _ = band(variant.upper(), "AUC")
    assert lo <= g.train_auc(pm, train) <= hi
    for name in ("Theta", "Beta", "Xi"):
        np.testing.assert_allclose(getattr(pm, name), getattr(jm, name), rtol=1e-3, atol=1e-6)
    # Xi from the fitted tables exactly as the JAX package derives it
    km = jm.L3s / np.maximum(jm.L3r, c2pf_mod.EPS)
    gi, gj, _ = pm._context_edges(train)
    pm2 = c2pf_from_arrays({**{n: getattr(jm, a) for n, a in (
        ("G_s", "Gs"), ("G_r", "Gr"), ("L_s", "Ls"), ("L_r", "Lr"), ("L2_s", "L2s"),
        ("L2_r", "L2r"), ("L3_s", "L3s"), ("L3_r", "L3r"))},
        "Theta": jm.Theta, "Beta": jm.Beta, "Xi": jm.Xi},
        _meta(jm, k=8, variant=variant), device="cpu")
    X2m = jm.L2s / np.maximum(jm.L2r, c2pf_mod.EPS)
    xi = c2pf_mod._scatter(train.num_items, torch.as_tensor(np.asarray(gi, np.int64)),
                           torch.as_tensor(km[:, None] * X2m[np.asarray(gj)])).numpy()
    np.testing.assert_array_equal(xi, jm.Xi)
    users = np.arange(train.num_users)
    np.testing.assert_array_equal(pm2.score_batch(users), jm.score_batch(users))
    np.testing.assert_allclose(pm2.score_batch_device(users).numpy(),
                               jm.score_batch(users), rtol=1e-5)
    np.testing.assert_array_equal(pm2.score(3), jm.score(3))
    assert pm2.score(3, 4) == jm.score(3, 4)
    np.testing.assert_array_equal(pm2.get_user_vectors(), jm.get_user_vectors())
    np.testing.assert_array_equal(pm2.get_item_vectors(), jm.get_item_vectors())


@pytest.mark.parametrize("variant", ["c2pf", "tc2pf", "rc2pf"])
def test_c2pf_recommend_batch_ranks_as_jax_not_as_score(splits, c2pf_fits, variant):
    """The JAX package's recommend_batch ranks by the vector accessors,
    which drop Xi (c2pf, tc2pf) or add Beta (rc2pf); the port keeps it."""
    jm, _ = c2pf_fits[variant]
    train = splits["item_graph"][1].train_set
    arrays = {n: getattr(jm, a) for n, a in (
        ("G_s", "Gs"), ("G_r", "Gr"), ("L_s", "Ls"), ("L_r", "Lr"), ("L2_s", "L2s"),
        ("L2_r", "L2r"), ("L3_s", "L3s"), ("L3_r", "L3r"))}
    arrays.update(Theta=jm.Theta, Beta=jm.Beta, Xi=jm.Xi)
    pm = c2pf_from_arrays(arrays, _meta(jm, k=8, variant=variant), device="cpu")
    raw = list(train.uid_map)[:20]
    got = pm.recommend_batch(raw, k=10)
    assert got == jm.recommend_batch(raw, k=10)
    by_score = [pm.recommend(u, k=10) for u in raw]
    assert by_score == [jm.recommend(u, k=10) for u in raw]
    assert sum(a != b for a, b in zip(got, by_score)) >= 10


def test_c2pf_needs_the_item_graph(splits):
    with pytest.raises(ValueError, match="item_graph"):
        P.C2PF(max_iter=1, seed=1).fit(splits["user_graph"][1].train_set)
    with pytest.raises(ValueError, match="variant"):
        P.C2PF(variant="x")


# ------------------------------------------------------------------ convert


@pytest.mark.parametrize("name", ["SBPR", "VEBPR"])
def test_convert_bpr_family(splits, name):
    cls, kwargs, _, kind = GOLDEN_CONFIGS[name]
    jsplit = splits[kind][0]
    jm = getattr(J, cls)(seed=124, **{**kwargs, "max_iter": 5}).fit(jsplit.train_set)
    arrays = {a: getattr(jm, a) for a in ("u_factors", "i_factors", "i_biases")}
    pm = bpr_from_arrays(arrays, _meta(jm, k=8, use_bias=jm.use_bias), device="cpu",
                         cls_name=name)
    assert type(pm) is getattr(P, cls)
    users = np.arange(jm.num_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(pm.score(2), jm.score(2), rtol=1e-6)
    raw = list(jm.uid_map)[:10]
    assert pm.recommend_batch(raw, k=5) == jm.recommend_batch(raw, k=5)
    with pytest.raises(ValueError, match="cls_name"):
        bpr_from_arrays(arrays, _meta(jm, k=8, use_bias=True), device="cpu", cls_name="X")
