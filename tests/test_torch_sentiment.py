"""The port's sentiment and explainable models (EFM, ComparERObj,
ComparERSub, MTER, LRPPM, Companion, TriRank) and ``ops/csr_lookup.py``
against the JAX package's, on the CPU, on ``tests/data/rating.txt`` with
seeded (aspect, opinion, polarity) tuples a rating.

- ``CsrLookup``'s found flags, values and positions, exactly.
- Every host build (``_build_matrices``, ``_build_data``,
  ``_chrono_pairs``, ``_build_pairs``, ``_build_sub_pairs``, Companion's
  element arrays and lookup matrices, LRPPM's aspect CSR), byte for byte.
- Initial parameters bit for bit (the same numpy draws in the same order).
- EFM's and ComparERObj's whole fits at 20 iterations (no draws), rtol 1e-5.
- One and five iterations of MTER, ComparERSub, LRPPM and Companion on the
  JAX key's own draws against the JAX fit of as many iterations, rtol 1e-5
  / atol 1e-6.
- TriRank's scores at 1e-10 after the same number of power iterations.
- Scoring through ``convert.model_from_params`` (float64 on the device
  against the JAX package's float64 on the host), the most-cared aspects
  with tied zero attention, and the refusals (``mesh=``, no sentiment).
"""

import os
from collections import Counter

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
import cornac_tpu_torch
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu.data import Reader
from cornac_tpu.models import comparer as jcomparer
from cornac_tpu.ops.csr_lookup import CsrLookup as JCsrLookup
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.models import comparer as pcomparer
from cornac_tpu_torch.models.companion import companion_iteration
from cornac_tpu_torch.models.lrppm import LrppmData, aspect_membership, lrppm_iteration
from cornac_tpu_torch.models.mter import NAMES, mter_iteration
from cornac_tpu_torch.ops.csr_lookup import CsrLookup

cornac_tpu_torch.set_default_device("cpu")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "rating.txt")
ASPECTS = ["battery", "screen", "price", "camera", "speed", "size", "weight"]
OPINIONS = ["good", "bad", "great", "poor", "fine"]
ITER = dict(rtol=1e-5, atol=1e-6)
FIT = dict(rtol=1e-5, atol=1e-6)
SCORES = dict(rtol=1e-10, atol=1e-12)
_SNAPSHOT = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
             "global_mean")
SMALL = dict(n_user_factors=4, n_item_factors=3, n_aspect_factors=4, n_opinion_factors=3)


def _lexicon(data):
    rng = np.random.RandomState(4)
    lexicon = []
    for row in data:
        # the first five aspects only: "size" and "weight" are in no tuple
        tuples = [(ASPECTS[rng.randint(5)], OPINIONS[rng.randint(len(OPINIONS))],
                   float(rng.choice([-1, 1]))) for _ in range(rng.randint(1, 4))]
        lexicon.append((row[0], row[1], tuples))
    return lexicon


def _splits(fmt):
    data = Reader().read(DATA, fmt=fmt)
    lexicon = _lexicon(data)

    def split(d, e):
        return e.RatioSplit(data=data, fmt=fmt, test_size=0.2, rating_threshold=3.0, seed=123,
                            exclude_unknowns=True, verbose=False,
                            sentiment=d.SentimentModality(data=lexicon))

    return split(jdata, jeval), split(pdata, peval)


@pytest.fixture(scope="module")
def splits():
    return _splits("UIR")


@pytest.fixture(scope="module")
def chrono():
    return _splits("UIRT")


def _t(a):
    return torch.as_tensor(np.array(a)).long()


# ---------------------------------------------------------- CsrLookup --


def test_csr_lookup_matches_jax():
    rng = np.random.RandomState(0)
    m = sp.random(40, 60, density=0.1, random_state=rng, format="csr", dtype=np.float32)
    m.data = rng.randint(1, 6, m.nnz).astype(np.float32)
    m = m.tolil()
    m[3, :] = 0  # an empty row
    m = m.tocsr()
    m.eliminate_zeros()
    rows = rng.randint(0, 40, 500)
    cols = rng.randint(0, 61, 500)  # column 60 lies past the matrix: absent
    stored = m.nonzero()
    rows[:100], cols[:100] = stored[0][:100], stored[1][:100]
    want = JCsrLookup.build(m).query_position(jax.numpy.asarray(rows), jax.numpy.asarray(cols))
    got = CsrLookup.build(m).query_position(_t(rows), _t(cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    found, value = CsrLookup.build(m).query(_t(rows), _t(cols))
    np.testing.assert_array_equal(found.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(value.numpy(), np.asarray(want[1]))
    assert found[:100].all() and not found[rows == 3].any()


# -------------------------------------------------------- host builds --


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def _unfitted(name, js, ps, **kw):
    jm, pm = getattr(J, name)(seed=3, **kw), getattr(P, name)(seed=3, **kw)
    jm.trainable = pm.trainable = False
    return jm.fit(js.train_set), pm.fit(ps.train_set)


def test_efm_matrices_are_the_jax_bytes(splits):
    js, ps = splits
    jm, pm = _unfitted("EFM", js, ps)
    for a, b in zip(jm._build_matrices(js.train_set), pm._build_matrices(ps.train_set)):
        _same_csr(a, b)


@pytest.mark.parametrize("name", ["MTER", "ComparERSub", "Companion"])
def test_tensor_data_are_the_jax_bytes(splits, name):
    js, ps = splits
    jm, pm = _unfitted(name, js, ps)
    want, got = jm._build_data(js.train_set), pm._build_data(ps.train_set)
    _same_csr(want[0], got[0])
    for w, g in zip(want[1:], got[1:]):
        assert list(w.items()) == list(g.items())


def test_chrono_and_skyline_pairs_are_the_jax_bytes(chrono):
    js, ps = chrono
    for kw in (dict(min_user_freq=1), dict(min_user_freq=2, enum_window=3)):
        jm, pm = _unfitted("ComparERObj", js, ps, **kw)
        want = jcomparer._chrono_pairs(jm, js.train_set, jm.min_user_freq, jm.enum_window)
        got = pcomparer._chrono_pairs(pm, ps.train_set, pm.min_user_freq, pm.enum_window)
        assert list(want.items()) == list(got.items()) and len(got) > 0
        assert want.most_common() == got.most_common()
        Y = jm._build_matrices(js.train_set)[2]
        for w, g in zip(jm._build_pairs(js.train_set, Y),
                        pm._build_pairs(ps.train_set, pm._build_matrices(ps.train_set)[2])):
            assert w.dtype == g.dtype and w.tobytes() == g.tobytes()
        jsub, psub = _unfitted("ComparERSub", js, ps, **kw)
        uia_j, uia_p = jsub._build_data(js.train_set)[1], psub._build_data(ps.train_set)[1]
        for w, g in zip(jsub._build_sub_pairs(js.train_set, uia_j),
                        psub._build_sub_pairs(ps.train_set, uia_p)):
            assert w.dtype == g.dtype and w.tobytes() == g.tobytes() and len(g) > 0


def test_skyline_pairs_on_signed_scores_are_the_jax_bytes(chrono):
    """The skyline builds on scores of either sign, zeros and aspects one
    item lacks (the fits' own scores are all above 1): the port's numpy
    builds give the JAX loops' bytes."""
    js, ps = chrono
    rng = np.random.RandomState(11)
    jm, pm = _unfitted("ComparERObj", js, ps, min_user_freq=1)
    n_items, n_asp = pm.num_items, pm.num_aspects
    dense = rng.choice([-1.5, 0.0, 0.0, 0.5, 2.0], size=(n_items, n_asp))
    Y = sp.csr_matrix(dense)
    Y.data[::7] = 0.0  # explicit zeros stay stored
    Y = sp.csr_matrix((Y.data, Y.indices, Y.indptr), shape=Y.shape)
    for w, g in zip(jm._build_pairs(js.train_set, Y), pm._build_pairs(ps.train_set, Y)):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes() and len(g) > 0
    jsub, psub = _unfitted("ComparERSub", js, ps, min_user_freq=1)
    u, i, _ = ps.train_set.uir_tuple
    uia = {}
    for uu, ii in zip(u.tolist(), i.tolist()):
        uia[(uu, ii, psub.num_aspects)] = 3.0
        for a in rng.choice(psub.num_aspects, rng.randint(0, 4), replace=False).tolist():
            uia[(uu, ii, a)] = float(rng.choice([-1.0, 0.0, 0.5, 1.5]))
    for w, g in zip(jsub._build_sub_pairs(js.train_set, uia),
                    psub._build_sub_pairs(ps.train_set, uia)):
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes() and len(g) > 0


def test_companion_streams_and_lookups_are_the_jax_bytes(splits, monkeypatch):
    js, ps = splits
    jm, pm = _unfitted("Companion", js, ps)
    captured = {}

    def capture(state, key, *args, **kw):
        captured["args"] = args
        return state

    monkeypatch.setattr("cornac_tpu.models.companion._companion_fit", capture)
    J.Companion(seed=3, max_iter=1, **SMALL).fit(js.train_set)
    args = captured["args"]
    streams, matrices = pm._host_streams(*pm._build_data(ps.train_set))
    flat = [a for s in streams for a in s]
    for w, g in zip(args[:14], flat):
        assert np.asarray(w).tobytes() == np.asarray(g).tobytes()
    lookups = args[16:20]
    for jl, m in zip([lookups[0], lookups[1].aspect, lookups[2], lookups[3]], matrices):
        m = m.sorted_indices()
        for w, g in zip(jl.arrays, (m.indptr, m.indices, m.data)):
            np.testing.assert_array_equal(np.asarray(w), np.asarray(g, np.asarray(w).dtype))


def test_lrppm_aspect_csr_is_the_jax_bytes(splits, monkeypatch):
    js, ps = splits
    captured = {}

    def capture(params, key, *args, **kw):
        captured["args"], captured["kw"] = args, kw
        return params

    monkeypatch.setattr("cornac_tpu.models.lrppm._lrppm_fit", capture)
    J.LRPPM(seed=3, max_iter=1, n_factors=4).fit(js.train_set)
    args = captured["args"]
    pm = P.LRPPM(seed=3, trainable=False, n_factors=4).fit(ps.train_set)
    uia, _ = pm._build_data(ps.train_set)
    for w, g in zip(args[3:7], pm._triples(uia)):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(g, np.asarray(w).dtype))
    csr = ps.train_set.csr_matrix.sorted_indices()
    member = aspect_membership(csr, uia, pm.num_aspects, torch.device("cpu"))
    np.testing.assert_array_equal(member.arrays[0].numpy(), np.asarray(args[7]))
    np.testing.assert_array_equal(member.arrays[1].numpy()[:-1], np.asarray(args[8]))
    assert member.search_steps == captured["kw"]["aspect_steps"]


# ------------------------------------------------------------- inits --


@pytest.mark.parametrize("name,kw", [
    ("MTER", SMALL), ("ComparERSub", SMALL), ("Companion", SMALL),
    ("LRPPM", dict(n_factors=4)), ("TriRank", {})])
def test_initial_parameters_are_the_jax_packages(splits, name, kw):
    js, ps = splits
    jm, pm = _unfitted(name, js, ps, **kw)
    names = {"LRPPM": ("U", "I", "UA", "IA"), "TriRank": ("p", "a", "u")}.get(name, NAMES)
    for n in names:
        np.testing.assert_array_equal(getattr(pm, n), getattr(jm, n))


# ---------------------------------------------------- EFM, ComparERObj --

EFM_KW = dict(num_explicit_factors=4, num_latent_factors=3, num_most_cared_aspects=3,
              max_iter=20, seed=123)


@pytest.mark.parametrize("name,kw", [
    ("EFM", {}), ("EFM", dict(use_item_aspect_popularity=False)),
    ("ComparERObj", dict(model_type="Finer", min_user_freq=1)),
    ("ComparERObj", dict(model_type="Dominant", min_user_freq=1)),
    ("ComparERObj", dict(model_type="Around", min_user_freq=1, lambda_d=0.5))])
def test_efm_fits_match_jax(chrono, name, kw):
    js, ps = chrono
    jm = getattr(J, name)(**EFM_KW, **kw).fit(js.train_set)
    pm = getattr(P, name)(**EFM_KW, **kw).fit(ps.train_set)
    for n in ("U1", "U2", "V", "H1", "H2"):
        np.testing.assert_allclose(getattr(pm, n), getattr(jm, n), err_msg=n, **FIT)
    users = np.arange(pm.num_users)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), rtol=1e-5,
                               atol=1e-6)
    if name == "ComparERObj":
        np.testing.assert_allclose(pm.monitor_value(val_set=ps.test_set),
                                   jm.monitor_value(val_set=js.test_set), rtol=1e-5)


# ------------------------------------------- the sampled iteration fits --


def _key(rng):
    return jax.random.PRNGKey(rng.randint(2**31))


def _randint(key, n, high):
    return _t(jax.random.randint(key, (n,), 0, high))


def _mter_jax_draws(key, it, data, n_el, n_bpr, n_pair, n_items):
    ikey = jax.random.fold_in(key, it)
    k1, k2, k3, k4, k5 = jax.random.split(ikey, 5)
    draws = {"s1": _randint(k1, n_el, data.X.shape[0]), "s2": _randint(k2, n_el, data.YU.shape[0]),
             "s3": _randint(k3, n_el, data.YI.shape[0]),
             "pos": _randint(k4, n_bpr, data.rat_users.shape[0]),
             "j": _randint(k5, n_bpr, n_items)}
    if n_pair:
        draws["sp"] = _randint(jax.random.fold_in(ikey, 6), n_pair, data.pairs[0].shape[0])
    return draws


MTER_KW = dict(SMALL, n_element_samples=20, n_bpr_samples=30, lr=0.1)


@pytest.mark.parametrize("iters", [1, 5])
@pytest.mark.parametrize("name", ["MTER", "ComparERSub"])
def test_mter_iterations_on_the_jax_draws_match(chrono, name, iters):
    js, ps = chrono
    kw = dict(MTER_KW, seed=5)
    if name == "ComparERSub":
        kw.update(min_user_freq=1, n_pair_samples=25, lambda_d=0.5)
    jm = getattr(J, name)(max_iter=iters, **kw).fit(js.train_set)
    pm = getattr(P, name)(trainable=False, **kw).fit(ps.train_set)
    key = _key(pm.rng)
    rating_matrix, uia, uao, iao = pm._build_data(ps.train_set)
    pairs, n_pair = None, 0
    if name == "ComparERSub":
        pairs = pm._build_sub_pairs(ps.train_set, uia)
        n_pair = pm.n_pair_samples
        assert len(pairs[0]) > 0
    data = pm._device_data(ps.train_set, rating_matrix, uia, uao, iao, pairs,
                           torch.device("cpu"))
    params, sgrads = pm._device_params(torch.device("cpu"))
    for it in range(iters):
        draws = _mter_jax_draws(key, it, data, pm.n_element_samples, pm.n_bpr_samples, n_pair,
                                pm.num_items)
        mter_iteration(params, sgrads, data, draws, 0.1, 0.1, 10.0, 0.5)
    for n in NAMES:
        np.testing.assert_allclose(params[n].numpy(), getattr(jm, n), err_msg=n, **ITER)


@pytest.mark.parametrize("iters", [1, 5])
def test_lrppm_iterations_on_the_jax_draws_match(splits, iters):
    js, ps = splits
    kw = dict(n_factors=4, n_samples=30, n_ranking_samples=40, lr=0.1, seed=5)
    jm = J.LRPPM(max_iter=iters, **kw).fit(js.train_set)
    pm = P.LRPPM(trainable=False, **kw).fit(ps.train_set)
    key = _key(pm.rng)
    uia, _ = pm._build_data(ps.train_set)
    X_u, X_i, X_a, X_l = pm._triples(uia)
    rid, cid, rvals = ps.train_set.uir_tuple
    csr = ps.train_set.csr_matrix.sorted_indices()
    cpu = torch.device("cpu")
    data = LrppmData(_t(rid), _t(cid), torch.as_tensor(np.asarray(rvals, np.float32)), _t(X_u),
                     _t(X_i), _t(X_a), torch.as_tensor(np.asarray(X_l, np.float32)),
                     CsrLookup.build(csr), aspect_membership(csr, uia, pm.num_aspects, cpu),
                     pm.num_aspects)
    params = tuple(torch.as_tensor(np.asarray(t, np.float32)).clone()
                   for t in (pm.U, pm.I, pm.UA, pm.IA))
    for it in range(iters):
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, it), 3)
        draws = {"s": _randint(k1, 30, len(rid)), "s2": _randint(k2, 40, len(X_u)),
                 "a_neg": _randint(k3, 40, pm.num_aspects)}
        lrppm_iteration(params, data, draws, 0.1, 0.01, 1.0)
    for n, t in zip(("U", "I", "UA", "IA"), params):
        np.testing.assert_allclose(t.numpy(), getattr(jm, n), err_msg=n, **ITER)


COMPANION_KW = dict(SMALL, n_element_samples=20, n_bpr_samples=20, n_aspect_ranking_samples=25,
                    n_opinion_ranking_samples=15, lr=0.5, seed=5)


@pytest.mark.parametrize("iters", [1, 5])
def test_companion_iterations_on_the_jax_draws_match(splits, iters):
    js, ps = splits
    jm = J.Companion(max_iter=iters, **COMPANION_KW).fit(js.train_set)
    pm = P.Companion(trainable=False, **COMPANION_KW).fit(ps.train_set)
    key = _key(pm.rng)
    cpu = torch.device("cpu")
    streams, matrices = pm._host_streams(*pm._build_data(ps.train_set))
    data = pm._device_data(ps.train_set, streams, matrices, cpu)
    params, sgrads = pm._device_params(cpu)
    nX, nYP, nYN = (s[0].shape[0] for s in streams)
    n_rat = data.rat_users.shape[0]
    for it in range(iters):
        keys = jax.random.split(jax.random.fold_in(key, it), 12)
        draws = {"s1": _randint(keys[0], 20, nX), "s2": _randint(keys[1], 20, nYP),
                 "s3": _randint(keys[2], 20, nYN), "pos": _randint(keys[3], 20, n_rat),
                 "j": _randint(keys[4], 20, pm.num_items), "sp": _randint(keys[5], 25, nX),
                 "a_j": _randint(keys[6], 25, pm.num_aspects), "si": _randint(keys[7], 25, nX),
                 "i_j": _randint(keys[8], 25, pm.num_items)}
        for c, n_rows in (("P", nYP), ("N", nYN)):
            ko = jax.random.fold_in(keys[9], 0 if c == "P" else 1)
            draws["so_" + c] = _randint(ko, 15, n_rows)
            draws["oj_" + c] = _randint(jax.random.fold_in(ko, 1), 15, pm.num_opinions)
        companion_iteration(params, sgrads, data, draws, pm.n_user_factors, 0.5, 0.1, 10.0, 10.0,
                            10.0, 10.0, 10.0)
    for n in NAMES:
        np.testing.assert_allclose(params[n].numpy(), getattr(jm, n), err_msg=n, **ITER)


@pytest.mark.parametrize("name,kw", [
    ("MTER", MTER_KW), ("LRPPM", dict(n_factors=4, n_samples=30, n_ranking_samples=40)),
    ("Companion", COMPANION_KW), ("ComparERSub", dict(MTER_KW, min_user_freq=1))])
def test_sampled_fits_run_and_refit_bit_for_bit(chrono, name, kw):
    _, ps = chrono
    kw = dict(kw, max_iter=40, seed=7)
    a = getattr(P, name)(**kw).fit(ps.train_set)
    b = getattr(P, name)(**kw).fit(ps.train_set)
    names = ("U", "I", "UA", "IA") if name == "LRPPM" else NAMES
    for n in names:
        assert np.isfinite(getattr(a, n)).all() and (getattr(a, n) >= 0).all()
        np.testing.assert_array_equal(getattr(a, n), getattr(b, n))
    assert not np.array_equal(a.U, getattr(P, name)(**dict(kw, max_iter=0)).fit(ps.train_set).U)


# ------------------------------------------------------------ TriRank --


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse CSR"])
def test_trirank_scores_and_iteration_count_match(splits, monkeypatch, dense):
    js, ps = splits
    if not dense:
        monkeypatch.setattr("cornac_tpu_torch.models.trirank.DENSE_CELLS", 0)
    jm = J.TriRank(seed=11, max_iter=100, verbose=False).fit(js.train_set)
    pm = P.TriRank(seed=11, max_iter=100, verbose=False).fit(ps.train_set)
    for n in ("R", "X", "Y"):
        _same_csr(getattr(pm, n), getattr(jm, n))
    users = np.arange(pm.num_users)
    calls = Counter()
    allclose = np.allclose

    def counting(a, b, *args, **kw):
        calls[a.shape[1]] += 1
        return allclose(a, b, *args, **kw)

    monkeypatch.setattr(np, "allclose", counting)
    want = jm.score_batch(users)
    monkeypatch.setattr(np, "allclose", allclose)
    got = pm.score_batch(users)
    np.testing.assert_allclose(got, want, **SCORES)
    # the loop ended on convergence (not max_iter) after the same count
    assert pm.last_iterations == calls[pm.num_users] < 100
    np.testing.assert_allclose(pm.score(2), jm.score(2), **SCORES)


# ---------------------------------------------------- scoring, convert --

def _meta(jm, names):
    return {n: getattr(jm, n) for n in names + _SNAPSHOT}


@pytest.mark.parametrize("name", ["EFM", "ComparERObj", "MTER", "ComparERSub", "Companion",
                                  "LRPPM", "TriRank"])
def test_scores_through_convert_match_jax(chrono, name):
    js, ps = chrono
    kw = {"EFM": dict(EFM_KW, max_iter=5), "ComparERObj": dict(EFM_KW, max_iter=5,
                                                               min_user_freq=1),
          "MTER": dict(MTER_KW, max_iter=40, seed=1),
          "ComparERSub": dict(MTER_KW, max_iter=40, seed=1, min_user_freq=1),
          "Companion": dict(COMPANION_KW, max_iter=40), "LRPPM": dict(n_factors=4, max_iter=40,
                                                                      seed=1, num_top_aspects=3),
          "TriRank": dict(seed=2, max_iter=50)}[name]
    jm = getattr(J, name)(**kw).fit(js.train_set)
    from cornac_tpu_torch.convert import _SENTIMENT_MODELS

    options = _SENTIMENT_MODELS[name][1]
    names = {"EFM": ("U1", "U2", "V", "H1", "H2"), "ComparERObj": ("U1", "U2", "V", "H1", "H2"),
             "LRPPM": ("U", "I", "UA", "IA"),
             "TriRank": ("R", "X", "Y", "p", "a", "u")}.get(name, NAMES)
    pm = model_from_params(name, {n: getattr(jm, n) for n in names},
                           _meta(jm, options), train_set=ps.train_set)
    users = np.array([0, 3, 5, pm.num_users - 1])
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), **SCORES)
    np.testing.assert_allclose(np.asarray(pm.score(3)), np.asarray(jm.score(3)), **SCORES)
    np.testing.assert_allclose(pm.score(3, 2), jm.score(3, 2), **SCORES)
    items = np.arange(len(users)) + 1
    np.testing.assert_allclose(pm.score_pairs(users, items), jm.score_pairs(users, items),
                               **SCORES)
    ranked_p, scores_p = pm.rank(3, k=5)
    ranked_j, scores_j = jm.rank(3, k=5)
    np.testing.assert_allclose(scores_p, scores_j, **SCORES)
    np.testing.assert_array_equal(ranked_p[:5], ranked_j[:5])


@pytest.mark.parametrize("name,kw", [
    ("MTER", MTER_KW), ("ComparERSub", dict(MTER_KW, min_user_freq=1)),
    ("Companion", COMPANION_KW), ("LRPPM", dict(n_factors=4))])
def test_score_pairs_are_the_score_loop(chrono, name, kw):
    from cornac_tpu_torch.models.recommender import Recommender

    _, ps = chrono
    pm = getattr(P, name)(**dict(kw, max_iter=5, seed=3)).fit(ps.train_set)
    rng = np.random.default_rng(0)
    users = rng.integers(-1, pm.num_users + 2, 200)
    items = rng.integers(-1, pm.num_items + 2, 200)
    want = Recommender.score_pairs(pm, users, items)
    assert (want == pm.default_score()).any() and (want != pm.default_score()).any()
    np.testing.assert_allclose(pm.score_pairs(users, items), want, **SCORES)


def test_most_cared_aspects_tied_at_zero_add_nothing(splits):
    js, ps = splits
    kw = dict(EFM_KW, num_most_cared_aspects=3, max_iter=3)
    jm = J.EFM(**kw).fit(js.train_set)
    # an aspect no one mentions has V row 0 after the first update: four
    # such rows leave one aspect of non-zero attention, so the three most
    # cared for take two of four aspects tied at 0, which argsort and topk
    # may choose differently
    V = jm.V.copy()
    V[:4] = 0.0
    arrays = {"U1": jm.U1, "U2": jm.U2, "V": V, "H1": jm.H1, "H2": jm.H2}
    jt = J.EFM(trainable=False, init_params=dict(arrays), **kw).fit(js.train_set)
    pm = model_from_params("EFM", arrays, _meta(jm, ("num_explicit_factors",
                                                     "num_latent_factors",
                                                     "num_most_cared_aspects", "rating_scale",
                                                     "alpha")), train_set=ps.train_set)
    users = np.arange(pm.num_users)
    X_ = jm.U1 @ V.T
    assert X_.shape[1] == 5 and ((X_ == 0).sum(axis=1) == 4).all()
    np.testing.assert_allclose(pm.score_batch(users), jt.score_batch(users), **SCORES)


@pytest.mark.parametrize("name", ["EFM", "ComparERObj", "MTER", "ComparERSub", "Companion",
                                  "LRPPM", "TriRank", "HypAR"])
def test_mesh_and_missing_sentiment_are_refused(name):
    # mesh= is ported for all but TriRank (tests/test_torch_parallel_sentiment.py):
    # anything but a parallel.make_mesh mesh is refused; TriRank refuses any
    # mesh, as the JAX package's TriRank takes none
    if name == "TriRank":
        with pytest.raises(NotImplementedError, match="cornac_tpu.models.TriRank"):
            getattr(P, name)(mesh=object())
    else:
        with pytest.raises(TypeError, match="DeviceMesh"):
            getattr(P, name)(mesh=object())
    data = Reader().read(DATA, fmt="UIR")
    rs = peval.RatioSplit(data=data, test_size=0.2, seed=1, verbose=False)
    with pytest.raises(ValueError, match="sentiment"):
        getattr(P, name)().fit(rs.train_set)
