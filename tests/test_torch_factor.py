"""The port's factor family against the JAX package's, on the CPU.

- PMF: one RMSProp minibatch on the JAX package's own permutation (drawn in
  the test as ``cornac_tpu/models/pmf.py::_pmf_epochs`` draws it), with
  repeated ids and padded positions in it: factors, caches and the loss
  within rtol 1e-5 / atol 1e-6 of ``_pmf_epochs``, linear and non-linear.
  The caches' duplicate rule (``cache.at[u].set``): the JAX CPU reference
  keeps the last position of a row in batch order, a padded position
  writing the old row; ``set_rows_last_wins`` equals it bit for bit.
- MF's optax path (adam, rmsprop, adagrad; dropout 0): one epoch of
  minibatches on the JAX permutation, from a state the JAX package reached
  after one epoch (carried over with ``convert``), within rtol 1e-5 /
  atol 1e-6 of ``_mf_optax_epochs``, parameters and optimizer state.
- NMF (10 epochs), WMF (3 sweeps on the bucketed layout at two workspace
  budgets, and the whole fit) and EASE: whole fits from the same seed,
  factors within rtol 1e-4 / atol 1e-5, EASE's B within rtol 1e-4 /
  atol 1e-6.
- Seeded initial factors equal to the JAX package's, bit for bit; scores on
  the same factors (``convert.factor_model_from_arrays``) within rtol 1e-6.
- An ``Experiment`` with every model: the deterministic ones' ranking
  metrics within 1e-4 of the JAX table, and RMSE / MAE within 1e-4; the
  sampled ones (PMF, MF-adam with dropout, IBPR, COE), which draw other
  random streams, on quality: AUC within 0.02 and NDCG@10 within 0.04 of
  the JAX fit with the same seed. Over model seeds 1-3 on these data the
  same-seed differences reached 0.011 (AUC, PMF) and 0.021 (NDCG@10,
  IBPR), and the seed-to-seed spreads (sample standard deviations) were up
  to 0.004 and 0.011 in either package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.eval_methods import RatioSplit as JRatioSplit
from cornac_tpu.experiment import Experiment as JExperiment
from cornac_tpu.metrics import AUC as JAUC, MAE as JMAE, NDCG as JNDCG, RMSE as JRMSE
import cornac_tpu.models as J
from cornac_tpu.models.mf import _make_optimizer, _mf_optax_epochs
from cornac_tpu.models.nmf import _nmf_fit
from cornac_tpu.models.pmf import _pmf_epochs
import cornac_tpu.models.wmf as j_wmf
from cornac_tpu_torch import Experiment
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import factor_model_from_arrays, optimizer_state_from_arrays
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.eval_methods import RatioSplit
from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE
from cornac_tpu_torch.models import mf as mf_mod, nmf as nmf_mod, pmf as pmf_mod, wmf as wmf_mod
from cornac_tpu_torch.ops.optim import make_optimizer

cornac_tpu_torch.set_default_device("cpu")

STEP = dict(rtol=1e-5, atol=1e-6)
FIT = dict(rtol=1e-4, atol=1e-5)


def _ratings(seed=0, n_users=31, n_items=23, n=500):
    rng = np.random.RandomState(seed)
    rid = rng.randint(n_users, size=n).astype(np.int32)
    cid = rng.randint(n_items, size=n).astype(np.int32)
    val = rng.randint(1, 6, size=n).astype(np.float32)
    return rng, rid, cid, val


def _uir(seed=5, n_users=90, n_items=70, n=2000):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    ub, ib = rng.normal(0, 0.7, n_users), rng.normal(0, 0.7, n_items)
    return [(f"u{u}", f"i{i}",
             float(np.clip(np.rint(3.5 + ub[u] + ib[i] + rng.normal(0, 0.5)), 1, 5)))
            for u, i in pairs]


def _jax_perm(key, epoch, n, n_total):
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(key, epoch), n), np.int64)
    return torch.from_numpy(np.concatenate([perm, np.zeros(n_total - n, np.int64)]))


# --------------------------------------------------------------------- PMF


def test_duplicate_set_keeps_the_last_position_as_jax():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 12, size=300)
    values = rng.randn(300, 4).astype(np.float32)
    table = rng.randn(15, 4).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, u, v: t.at[u].set(v))(
        jnp.asarray(table), jnp.asarray(ids, jnp.int32), jnp.asarray(values)))
    got = pmf_mod.set_rows_last_wins(torch.tensor(table), torch.from_numpy(ids.astype(np.int64)),
                                     torch.tensor(values))
    np.testing.assert_array_equal(got.numpy(), want)
    last = {row: pos for pos, row in enumerate(ids)}
    for row, pos in last.items():
        np.testing.assert_array_equal(want[row], values[pos])


@pytest.mark.parametrize("non_linear", [False, True])
@pytest.mark.parametrize("bs", [500, 512])
def test_pmf_one_minibatch_on_jax_permutation(non_linear, bs, epoch=3, lr=0.01, reg=0.01,
                                              gamma=0.9):
    # bs = 512 pads 12 positions, which write pair 0's old cache rows last
    rng, rid, cid, val = _ratings()
    n, k = len(val), 4
    if non_linear:
        val = (val - 1.0) / 4.0
    U = rng.normal(0, 0.3, (31, k)).astype(np.float32)
    V = rng.normal(0, 0.3, (23, k)).astype(np.float32)
    cu = np.abs(rng.normal(0, 0.01, (31, k))).astype(np.float32)
    cv = np.abs(rng.normal(0, 0.01, (23, k))).astype(np.float32)
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(bs - n, np.float32)])
    key = jax.random.PRNGKey(23)
    jU, jV, jcu, jcv, j_loss = _pmf_epochs(
        *(jnp.asarray(a.copy()) for a in (U, V, cu, cv)), key, jnp.asarray(mask),
        jnp.asarray(rid), jnp.asarray(cid), jnp.asarray(val), jnp.float32(lr),
        jnp.float32(reg), jnp.float32(gamma), batch_size=bs, non_linear=non_linear,
        n_epochs=1, epoch_offset=epoch)
    tables = [torch.tensor(a) for a in (U, V, cu, cv)]
    loss = pmf_mod._pmf_epoch(
        *tables, _jax_perm(key, epoch, n, bs), torch.from_numpy(mask),
        torch.from_numpy(np.stack([rid, cid], 1).astype(np.int64)), torch.from_numpy(val),
        lr, reg, gamma, bs, non_linear)
    np.testing.assert_allclose(float(loss), float(j_loss), **STEP)
    for ours, theirs in zip(tables, (jU, jV, jcu, jcv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **STEP)
    if bs > n:  # the padded positions (pair 0) come last and write its old cache rows
        for ours, theirs, old, row in ((tables[2], jcu, cu, rid[0]), (tables[3], jcv, cv, cid[0])):
            np.testing.assert_array_equal(ours[row].numpy(), old[row])
            np.testing.assert_array_equal(np.asarray(theirs)[row], old[row])


# ------------------------------------------------------------ MF, optax path


@pytest.mark.parametrize("optimizer,use_bias", [("adam", True), ("adam", False),
                                                ("rmsprop", True), ("adagrad", True)])
def test_mf_optax_epoch_on_jax_permutation(optimizer, use_bias, lr=0.01, reg=0.02, bs=128):
    rng, rid, cid, val = _ratings(seed=1)
    n, k = len(val), 5
    params = {"U": rng.normal(0, 0.1, (31, k)), "V": rng.normal(0, 0.1, (23, k)),
              "Bu": rng.normal(0, 0.1, 31), "Bi": rng.normal(0, 0.1, 23)}
    params = {name: a.astype(np.float32) for name, a in params.items()}
    mu = np.float32(val.mean() if use_bias else 0.0)
    n_total = n + (-n) % bs
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_total - n, np.float32)])
    key = jax.random.PRNGKey(5)
    jparams = {name: jnp.asarray(a) for name, a in params.items()}
    jstate = _make_optimizer(optimizer, lr).init(jparams)
    run = lambda p, s, epoch: _mf_optax_epochs(  # noqa: E731
        p, s, jnp.asarray(mask), jnp.asarray(rid), jnp.asarray(cid), jnp.asarray(val),
        jnp.float32(reg), mu, key, batch_size=bs, use_bias=use_bias, optimizer=optimizer,
        dropout=0.0, lr=lr, n_epochs=1, epoch_offset=epoch)
    jparams, jstate, _ = run(jparams, jstate, 0)  # the state one epoch reached
    start = {name: np.asarray(a) for name, a in jparams.items()}
    state = optimizer_state_from_arrays(_optax_state(jstate[0]), device="cpu")
    jparams, jstate, j_loss = run(jparams, jstate, 1)

    tparams = {name: torch.tensor(a, requires_grad=True) for name, a in start.items()}
    opt = make_optimizer(optimizer, lr)
    state, loss = mf_mod._mf_optax_epoch(
        tparams, opt, state, _jax_perm(key, 1, n, n_total), torch.from_numpy(mask),
        torch.from_numpy(np.stack([rid, cid], 1).astype(np.int64)), torch.from_numpy(val),
        reg, float(mu), bs, use_bias, 0.0, None)
    np.testing.assert_allclose(float(loss), float(j_loss), **STEP)
    for name in tparams:
        np.testing.assert_allclose(tparams[name].detach().numpy(), np.asarray(jparams[name]),
                                   **STEP)
    want = _optax_state(jstate[0])
    for field, value in want.items():
        if isinstance(value, dict):
            for name in value:
                np.testing.assert_allclose(state[field][name].numpy(), value[name], **STEP)
        else:
            assert int(state[field]) == int(value)


def _optax_state(state):
    """An optax state as nested dicts of numpy arrays under its field names."""
    return {field: ({n: np.asarray(v) for n, v in value.items()} if isinstance(value, dict)
                    else np.asarray(value))
            for field, value in state._asdict().items()}
# ------------------------------------------------- NMF, WMF, EASE: whole fits


@pytest.mark.parametrize("use_bias", [False, True])
def test_nmf_fit_matches_jax(use_bias):
    data = _uir()
    ours = P.NMF(k=6, max_iter=10, use_bias=use_bias, seed=3).fit(Dataset.from_uir(data, seed=1))
    theirs = J.NMF(k=6, max_iter=10, use_bias=use_bias, seed=3).fit(
        JDataset.from_uir(data, seed=1))
    for name in ("u_factors", "i_factors", "u_biases", "i_biases"):
        np.testing.assert_allclose(getattr(ours, name), np.asarray(getattr(theirs, name)), **FIT)
    assert ours.global_mean == theirs.global_mean


def test_nmf_epochs_match_jax_on_given_tables():
    rng, rid, cid, val = _ratings(seed=2)
    tables = [rng.uniform(size=s).astype(np.float32) for s in ((31, 4), (23, 4), 31, 23)]
    counts = [np.bincount(a, minlength=m).astype(np.float32) for a, m in ((rid, 31), (cid, 23))]
    consts = (0.005, 0.06, 0.05, 0.02, 0.03)
    jout = _nmf_fit(*(jnp.asarray(t.copy()) for t in tables), jnp.asarray(rid), jnp.asarray(cid),
                    jnp.asarray(val), *(jnp.asarray(c) for c in counts),
                    *(jnp.float32(c) for c in consts), jnp.float32(3.1), jnp.int32(10),
                    use_bias=True)
    tout = nmf_mod._nmf_epochs(*(torch.tensor(t) for t in tables),
                               torch.from_numpy(rid.astype(np.int64)),
                               torch.from_numpy(cid.astype(np.int64)), torch.from_numpy(val),
                               *(torch.from_numpy(c) for c in counts), *consts,
                               float(np.float32(3.1)), 10, True)
    for ours, theirs in zip(tout, jout):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **FIT)


def _csr(seed=4, n_users=60, n_items=45, n=900):
    from scipy.sparse import csr_matrix

    rng = np.random.RandomState(seed)
    pairs = np.unique(np.stack([rng.randint(n_users, size=n), rng.randint(n_items, size=n)]), axis=1)
    val = rng.randint(1, 6, size=pairs.shape[1]).astype(np.float32)
    return rng, csr_matrix((val, (pairs[0], pairs[1])), shape=(n_users, n_items))


# the default workspace budget (one chunk a bucket) and a small one (several
# buckets, several chunks each)
@pytest.mark.parametrize("budget", [None, 8 * 8 * 5 * 4 * 3], ids=["default", "small"])
def test_wmf_three_sweeps_match_jax(budget, k=5):
    rng, csr = _csr()
    csc = csr.T.tocsr()
    U = rng.uniform(-0.3, 0.3, (csr.shape[0], k)).astype(np.float32)
    V = rng.uniform(-0.3, 0.3, (csr.shape[1], k)).astype(np.float32)
    consts = (1.0, 0.01, 0.02, 0.03)
    jU, jV = j_wmf._als_fit_bucketed(
        jnp.asarray(U), jnp.asarray(V), j_wmf._bucketed_csr(csr, k, budget),
        j_wmf._bucketed_csr(csc, k, budget), *map(jnp.float32, consts), k=k, n_sweeps=3)
    groups = wmf_mod._bucketed_csr(csr, k, "cpu", budget)
    if budget is not None:
        assert len(groups) > 2 and max(g[0].shape[0] for g in groups) > 1
    tU, tV = wmf_mod._als_sweeps_bucketed(torch.tensor(U), torch.tensor(V), groups,
                                          wmf_mod._bucketed_csr(csc, k, "cpu", budget),
                                          *consts, 3)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), **FIT)
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), **FIT)


def test_wmf_fit_matches_jax():
    # Star ratings as preferences with b = 0.01 and lambda 0.01 make the
    # systems ill-conditioned: each float32 fit lies about 4e-5 from a
    # float64 fit (the port's solves in float64) after three sweeps, with
    # entries up to 14, so the two float32 fits lie up to 8e-5 apart
    # (ROADMAP.md C). Held: each within 1e-5 x the largest entry of the
    # float64 fit, and of each other within 1e-5 x that plus rtol 1e-4.
    data = _uir()
    kw = dict(k=6, max_iter=3, seed=2, verbose=False)
    train = Dataset.from_uir(data, seed=1)
    ours = P.WMF(**kw).fit(train)
    theirs = J.WMF(**kw).fit(JDataset.from_uir(data, seed=1))
    init = P.WMF(**{**kw, "max_iter": 0}).fit(train)
    groups = [[tuple(t.double() if t.is_floating_point() else t for t in g)
               for g in wmf_mod._bucketed_csr(m, 6, "cpu")]
              for m in (train.csr_matrix, train.csr_matrix.T.tocsr())]
    U64, V64 = wmf_mod._als_sweeps_bucketed(torch.tensor(init.U, dtype=torch.float64),
                                            torch.tensor(init.V, dtype=torch.float64),
                                            *groups, 1.0, 0.01, 0.01, 0.01, 3)
    for ours_f, theirs_f, exact in ((ours.U, theirs.U, U64), (ours.V, theirs.V, V64)):
        exact = exact.numpy()
        scale = np.abs(exact).max()
        assert np.abs(ours_f - exact).max() <= 1e-5 * scale
        assert np.abs(np.asarray(theirs_f) - exact).max() <= 1e-5 * scale
        np.testing.assert_allclose(ours_f, np.asarray(theirs_f), rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("posB", [True, False])
@pytest.mark.parametrize("lamb", [5.0, 500.0])
def test_ease_matches_jax(posB, lamb):
    data = _uir()
    ours = P.EASE(lamb=lamb, posB=posB, verbose=False).fit(Dataset.from_uir(data, seed=1))
    theirs = J.EASE(lamb=lamb, posB=posB, verbose=False).fit(JDataset.from_uir(data, seed=1))
    assert ours.B.dtype == theirs.B.dtype == np.float64
    np.testing.assert_allclose(ours.B, theirs.B, rtol=1e-4, atol=1e-6)
    assert (ours.B.diagonal() == 0).all() and (not posB or (ours.B >= 0).all())
    # a score sums a user's ratings times B: B's error times the ratings
    # (up to 5 each, about 22 a user) bounds it near 1e-4; measured 2e-6
    users = np.arange(0, 90, 7)
    np.testing.assert_allclose(ours.score_batch(users), theirs.score_batch(users),
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------- init and scoring


@pytest.mark.parametrize("name,kw,attrs", [
    ("PMF", dict(k=4, max_iter=0), ("U", "V")),
    ("NMF", dict(k=4, max_iter=0), ("u_factors", "i_factors", "u_biases", "i_biases")),
    ("WMF", dict(k=4, max_iter=0, verbose=False), ("U", "V")),
    ("IBPR", dict(k=4, trainable=False), ("U", "V")),
    ("COE", dict(k=4, trainable=False), ("U", "V")),
    ("MF", dict(k=4, optimizer="adam", trainable=False), ("u_factors", "i_factors")),
])
def test_seeded_init_matches_jax(name, kw, attrs):
    data = _uir()
    ours = getattr(P, name)(seed=11, **kw).fit(Dataset.from_uir(data, seed=1))
    theirs = getattr(J, name)(seed=11, **kw).fit(JDataset.from_uir(data, seed=1))
    for attr in attrs:
        np.testing.assert_array_equal(getattr(ours, attr), np.asarray(getattr(theirs, attr)))


_META = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
         "global_mean")


@pytest.mark.parametrize("name,options", [
    ("PMF", dict(k=4, variant="linear")), ("PMF", dict(k=4, variant="non_linear")),
    ("NMF", dict(k=4, use_bias=True)), ("WMF", dict(k=4)), ("IBPR", dict(k=4)),
    ("OnlineIBPR", dict(k=4)), ("COE", dict(k=4)), ("EASE", dict(lamb=50.0, posB=True)),
])
def test_scoring_on_the_same_factors(name, options):
    data = _uir()
    jtrain = JDataset.from_uir(data, seed=1)
    kw = dict(options, max_iter=3) if name != "EASE" else dict(options, verbose=False)
    if name in ("PMF", "NMF", "WMF", "IBPR", "OnlineIBPR", "COE"):
        kw["seed"] = 4
    if name == "WMF":
        kw["verbose"] = False
    theirs = getattr(J, name)(**kw).fit(jtrain)
    attrs = {"PMF": ("U", "V"), "NMF": ("u_factors", "i_factors", "u_biases", "i_biases"),
             "EASE": ("B",)}.get(name, ("U", "V"))
    arrays = {a: np.asarray(getattr(theirs, a)) for a in attrs}
    if name == "EASE":
        arrays.update(data=theirs.U.data, indices=theirs.U.indices, indptr=theirs.U.indptr,
                      shape=theirs.U.shape)
    meta = {**options, **{m: getattr(theirs, m) for m in _META}}
    ours = factor_model_from_arrays(name, arrays, meta, device="cpu")
    users = np.arange(0, theirs.num_users, 5)
    np.testing.assert_allclose(ours.score_batch(users), theirs.score_batch(users),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.score_batch_device(users).numpy(),
                               np.asarray(theirs.score_batch_device(users)), rtol=1e-6,
                               atol=1e-6)
    u, i = jtrain.uir_tuple[0][:50], jtrain.uir_tuple[1][:50]
    np.testing.assert_allclose(ours.score_pairs(u, i), theirs.score_pairs(u, i), rtol=1e-6)
    assert ours.recommend_batch(list(jtrain.uid_map)[:5], k=7) == theirs.recommend_batch(
        list(jtrain.uid_map)[:5], k=7)


# ---------------------------------------------------------------- Experiment


def _structured(seed=11, n_users=300, n_items=400, n_ratings=12000):
    """Star ratings whose exposure follows preference (as ``bench.py``'s
    data, smaller), so that every model has signal to rank by."""
    rng = np.random.RandomState(seed)
    pop = rng.zipf(1.5, size=n_items).astype(float)
    pop /= pop.sum()
    uf, vf = rng.normal(0, 1, (n_users, 4)), rng.normal(0, 1, (n_items, 4))
    seen, data = set(), []
    while len(data) < n_ratings:
        u = rng.randint(n_users, size=4 * n_ratings)
        i = rng.choice(n_items, size=4 * n_ratings, p=pop)
        a = np.einsum("ij,ij->i", uf[u], vf[i])
        keep = rng.rand(len(u)) < 1 / (1 + np.exp(-a))
        for uu, ii, aa in zip(u[keep], i[keep], a[keep]):
            if len(data) == n_ratings:
                break
            if (uu, ii) in seen:
                continue
            seen.add((uu, ii))
            data.append((f"u{uu}", f"i{ii}",
                         float(np.clip(np.round(3 + aa + rng.normal(0, 0.7)), 1, 5))))
    return data


DETERMINISTIC = ("NMF", "WMF", "EASEᴿ")


def _experiment_models(M, seed=1):
    return [M.PMF(k=8, max_iter=30, learning_rate=0.01, seed=seed),
            M.NMF(k=8, max_iter=20, seed=seed), M.WMF(k=8, max_iter=5, seed=seed, verbose=False),
            M.EASE(lamb=100, verbose=False), M.IBPR(k=8, max_iter=5, batch_size=256, seed=seed),
            M.COE(k=8, max_iter=5, seed=seed),
            M.MF(k=8, max_iter=10, optimizer="adam", dropout=0.1, seed=seed)]


def test_experiment_table_matches_jax():
    data = _structured()
    tables = []
    for RS, E, M, metrics in (
            (JRatioSplit, JExperiment, J, [JAUC(), JNDCG(k=10), JRMSE(), JMAE()]),
            (RatioSplit, Experiment, P, [AUC(), NDCG(k=10), RMSE(), MAE()])):
        split = RS(data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False)
        exp = E(split, _experiment_models(M), metrics)
        exp.run()
        tables.append({r.model_name: r.metric_avg_results for r in exp.result})
    theirs, ours = tables
    assert list(ours) == list(theirs) and len(ours) == 7
    for name in theirs:
        for metric in ("AUC", "NDCG@10", "RMSE", "MAE"):
            a, b = ours[name][metric], theirs[name][metric]
            assert np.isfinite(a)
            if name in DETERMINISTIC:
                assert abs(a - b) <= 1e-4, (name, metric, a, b)
            elif metric == "AUC":
                assert abs(a - b) <= 0.02, (name, metric, a, b)
            elif metric == "NDCG@10":
                assert abs(a - b) <= 0.04, (name, metric, a, b)
