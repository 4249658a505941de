"""The port's next-basket family against the JAX package's, on the CPU.

- Byte for byte: ``BasketDataset`` (maps, baskets, the per-user and
  chronological views, the statistics, the seeded iterators) from UBI, UBIT
  and UBITJson tuples; ``NextBasketEvaluation``'s user-atomic splits (the
  ``test_size=0`` quirk included); ``tools/seq_bench_data.gen_baskets``
  against ``benchmarks/head_to_head_basket.py::gen_baskets``.
- Within 1e-6: the next-basket ``ranking_eval`` on a fixed scorer with ties
  (every breakdown, per user); GPTop's scores (exact, ``use_quantity`` too);
  the whole ``Experiment`` table at ``tests/data/basket.txt``.
- rtol 1e-5 / atol 1e-6: TIFUKNN's and UPCF's scores, with TIFUKNN's
  neighbour lists identical (tied distances to the lower user index);
  Beacon's scores for each cell type and DNNTSP's, after ``convert``.
- rtol 1e-4 / atol 1e-6: one Beacon epoch (RMSProp) on the JAX package's own
  permutation and dropout masks, and one DNNTSP epoch for each loss and
  optimiser on its own permutation and negatives, each against the JAX
  package's own fit; ``adamw`` against optax at rtol 1e-6.
- Bits: the initial parameters, seeded refits, the node-update scatter
  whatever the order of its adds; refusals of a ``mesh=`` that is no mesh.

Whole fits draw other streams than JAX's and are held on quality on the
card (``chip_smoke.py`` process 12g, bands from ``tools/quality_bands.py``).
"""

import copy
import importlib.util
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.experiment as jexp
import cornac_tpu.metrics as jmetrics
import cornac_tpu.models as jmodels
from cornac_tpu.eval_methods import next_basket_evaluation as j_nbe
from cornac_tpu.models import dnntsp as j_dnntsp

import cornac_tpu_torch
import cornac_tpu_torch.data as tdata
import cornac_tpu_torch.eval_methods as teval
import cornac_tpu_torch.experiment as texp
import cornac_tpu_torch.metrics as tmetrics
import cornac_tpu_torch.models as tmodels
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.eval_methods import next_basket_evaluation as t_nbe
from cornac_tpu_torch.models import dnntsp as t_dnntsp
from cornac_tpu_torch.ops.optim import adamw, step

from test_torch_nn import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from seq_bench_data import gen_baskets  # noqa: E402

cornac_tpu_torch.set_default_device("cpu")

TOL5 = dict(rtol=1e-5, atol=1e-6)
TOL4 = dict(rtol=1e-4, atol=1e-6)
ROWS = gen_baskets(n_users=40, n_items=24, seed=7)


def _ubit(rows):
    """UBIT / UBITJson tuples of UBI rows: a basket's time is its number."""
    return [(u, b, i, int(b[1:])) for u, b, i in rows]


def _ubitjson(rows):
    return [(u, b, i, t, {"quantity": (t * 7 + k) % 5}) for k, (u, b, i, t)
            in enumerate(_ubit(rows))]


def _evals(test_size=0.25, val_size=0.0, exclude_unknowns=True, fmt="UBI", rows=ROWS,
           **kwargs):
    data = {"UBI": lambda: rows, "UBIT": lambda: _ubit(rows),
            "UBITJson": lambda: _ubitjson(rows)}[fmt]()
    return tuple(pkg.NextBasketEvaluation(data=data, test_size=test_size, val_size=val_size,
                                          fmt=fmt, seed=123, exclude_unknowns=exclude_unknowns,
                                          **kwargs)
                 for pkg in (jeval, teval))


@pytest.fixture(scope="module")
def evals():
    return _evals()


def _assert_same_dataset(t, j):
    for a, b in zip(t.uir_tuple, j.uir_tuple):
        np.testing.assert_array_equal(a, b)
    assert list(t.uid_map.items()) == list(j.uid_map.items())
    assert list(t.iid_map.items()) == list(j.iid_map.items())
    assert list(t.bid_map.items()) == list(j.bid_map.items())
    np.testing.assert_array_equal(t.basket_indices, j.basket_indices)
    assert (t.timestamps is None) == (j.timestamps is None)
    if t.timestamps is not None:
        np.testing.assert_array_equal(t.timestamps, j.timestamps)
    assert t.extra_data == j.extra_data
    assert dict(t.baskets) == dict(j.baskets)
    assert dict(t.user_basket_data) == dict(j.user_basket_data)
    assert t.basket_ids == j.basket_ids
    assert (t.num_users, t.num_items, t.num_baskets) == (j.num_users, j.num_items, j.num_baskets)
    assert (t.max_basket_size, t.min_basket_size, t.avg_basket_size) == (
        j.max_basket_size, j.min_basket_size, j.avg_basket_size)


# --------------------------------------------------------- data and split --
def test_gen_baskets_is_the_benchmark_copy():
    spec = importlib.util.spec_from_file_location(
        "head_to_head_basket", os.path.join(ROOT, "benchmarks", "head_to_head_basket.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert gen_baskets() == bench.gen_baskets()
    assert gen_baskets(40, 24, 3) == bench.gen_baskets(40, 24, 3)


@pytest.mark.parametrize("fmt", ["UBI", "UBIT", "UBITJson"])
def test_basket_dataset_is_byte_identical(fmt):
    data = {"UBI": ROWS, "UBIT": _ubit(ROWS), "UBITJson": _ubitjson(ROWS)}[fmt]
    j = jdata.BasketDataset.build(data, fmt=fmt, seed=5)
    t = tdata.BasketDataset.build(data, fmt=fmt, seed=5)
    _assert_same_dataset(t, j)
    if fmt != "UBI":
        assert dict(t.chrono_user_basket_data) == dict(j.chrono_user_basket_data)
    for size, shuffle in ((1, False), (7, True)):
        for a, b in zip(t.ubi_iter(size, shuffle), j.ubi_iter(size, shuffle)):
            assert list(a[0]) == list(b[0]) and a[1] == b[1]
            assert [[list(x) for x in u] for u in a[2]] == [[list(x) for x in u] for u in b[2]]
        for a, b in zip(t.basket_iter(size, shuffle), j.basket_iter(size, shuffle)):
            np.testing.assert_array_equal(a, b)
    for build in ("from_ubi", "from_ubit", "from_ubitjson"):
        if build[5:].upper() == fmt:
            _assert_same_dataset(getattr(tdata.BasketDataset, build)(data, seed=5),
                                 getattr(jdata.BasketDataset, build)(data, seed=5))


@pytest.mark.parametrize("test_size, val_size, exclude_unknowns",
                         [(0.25, 0.0, True), (0.2, 0.1, False), (0, 0.0, True)])
def test_split_is_byte_identical(test_size, val_size, exclude_unknowns):
    j, t = _evals(test_size, val_size, exclude_unknowns, fmt="UBIT")
    for name in ("train_set", "test_set", "val_set"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _assert_same_dataset(a, b)
    assert t.total_baskets == j.total_baskets


# ------------------------------------------------------------ ranking_eval --
class FixedScorer:
    """A next-basket scorer whose scores are a seeded matrix rounded to
    tenths (ties), by user."""

    def __init__(self, n_users, n_items):
        self.table = np.round(np.random.RandomState(3).rand(n_users, n_items), 1)

    def score_baskets_batch(self, users, histories):
        return self.table[np.asarray(users)]


def test_ranking_eval_on_a_fixed_scorer(evals):
    j, t = evals
    scorer = FixedScorer(j.total_users, j.total_items)
    metrics = [(pkg.NDCG(k=5), pkg.Recall(k=5), pkg.HitRatio(k=5), pkg.AUC(), pkg.MAP())
               for pkg in (jmetrics, tmetrics)]
    for rep, expl in ((True, True), (False, True), (False, False)):
        want = j_nbe.ranking_eval(scorer, list(metrics[0]), j.train_set, j.test_set, rep, expl,
                                  batch_size=4)
        got = t_nbe.ranking_eval(scorer, list(metrics[1]), t.train_set, t.test_set, rep, expl,
                                 batch_size=4)
        for kind in want[0]:
            np.testing.assert_allclose(got[0][kind], want[0][kind], rtol=0, atol=1e-6)
            for g, w in zip(got[1][kind], want[1][kind]):
                assert list(g) == list(w)
                np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=0,
                                           atol=1e-6)


# ------------------------------------------------------------ GPTop & co --
@pytest.mark.parametrize("kw", [{}, {"use_personalized_popularity": False},
                                {"use_global_popularity": False}, {"use_quantity": True}])
def test_gptop_scores_are_exact(kw):
    j, t = _evals(fmt="UBITJson")
    jm, tm = jmodels.GPTop(**kw).fit(j.train_set), tmodels.GPTop(**kw).fit(t.train_set)
    assert tm.item_freq == jm.item_freq
    users, hist = _test_histories(j)
    np.testing.assert_array_equal(tm.score_baskets_batch(users, hist),
                                  jm.score_baskets_batch(users, hist))
    if kw.get("use_quantity"):
        ts = t.test_set
        u = int(ts.uir_tuple[0][0])
        bids = ts.user_basket_data[u][:-1]
        h = [ts.uir_tuple[1][ts.baskets[b]] for b in bids]
        extra = dict(history_bids=bids, baskets=ts.baskets, extra_data=ts.extra_data)
        np.testing.assert_array_equal(tm.score(u, h, **extra), jm.score(u, h, **extra))


def _test_histories(ev):
    users, hist = [], []
    for [u], _, [baskets] in ev.test_set.ubi_iter(1):
        users.append(int(u))
        hist.append([list(b) for b in baskets[:-1]])
    return users, hist


def _jax_neighbors(model, histories):
    q = jnp.asarray(np.stack([model._compute_user_vector(h) for h in histories]))
    X = jnp.asarray(model.user_vectors)
    d2 = jnp.sum(q**2, axis=1, keepdims=True) - 2 * q @ X.T + jnp.sum(X**2, axis=1)[None, :]
    return np.asarray(jax.lax.top_k(-d2, model.n_neighbors)[1])


@pytest.mark.parametrize("ties, n_groups", [(False, 7), (False, 2), (True, 7)])
def test_tifuknn_scores_and_neighbours_match(ties, n_groups):
    rows = ROWS
    if ties:
        # every user's baskets twice more, under new user and basket ids:
        # three users with one vector, tied at every distance
        rows = rows + [(f"{u}x{c}", f"b{1000 * c + int(b[1:])}", i) for c in (1, 2)
                       for u, b, i in ROWS]
    j, t = _evals(rows=rows)
    jm = jmodels.TIFUKNN(n_neighbors=7, n_groups=n_groups).fit(j.train_set)
    tm = tmodels.TIFUKNN(n_neighbors=7, n_groups=n_groups, device="cpu").fit(t.train_set)
    np.testing.assert_array_equal(tm.user_vectors, jm.user_vectors)
    users, hist = _test_histories(j)
    queries = np.stack([tm._compute_user_vector(h) for h in hist])
    got = tm.neighbors(queries).numpy()
    np.testing.assert_array_equal(got, _jax_neighbors(jm, hist))
    if ties:
        X = tm.user_vectors
        d2 = ((queries[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        tied = np.isclose(d2[np.arange(len(got))[:, None], got[:, :-1]],
                          d2[np.arange(len(got))[:, None], got[:, 1:]], rtol=0, atol=0)
        assert tied.any()  # the lists hold ties, ordered by user index
    np.testing.assert_allclose(tm.score_baskets_batch(users, hist),
                               jm.score_baskets_batch(users, hist), **TOL5)


@pytest.mark.parametrize("recency, locality, asymmetry", [(1, 1, 0.25), (2, 2, 0.5), (0, 1, 0.1)])
def test_upcf_scores_match(recency, locality, asymmetry):
    j, t = _evals()
    kw = dict(recency=recency, locality=locality, asymmetry=asymmetry)
    jm, tm = jmodels.UPCF(**kw).fit(j.train_set), tmodels.UPCF(device="cpu", **kw).fit(t.train_set)
    assert (tm.user_wise_popularity != jm.user_wise_popularity).nnz == 0
    assert (tm.user_item_matrix != jm.user_item_matrix).nnz == 0
    users, hist = _test_histories(j)
    np.testing.assert_allclose(tm.score_baskets_batch(users, hist),
                               jm.score_baskets_batch(users, hist), **TOL5)


# ------------------------------------------------------------------ Beacon --
BEACON = dict(emb_dim=4, rnn_unit=5, nb_hop=2, batch_size=8, seed=11, lr=0.01)


def _meta(jm, extra=()):
    meta = {name: getattr(jm, name) for name in ("num_users", "num_items", "uid_map",
                                                 "iid_map", "min_rating", "max_rating",
                                                 "global_mean") + tuple(extra)}
    return meta


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "RNN"])
def test_beacon_init_and_scores_match(evals, cell):
    j, t = evals
    jm = jmodels.Beacon(rnn_cell_type=cell, n_epochs=0, **BEACON).fit(j.train_set)
    tm = tmodels.Beacon(rnn_cell_type=cell, n_epochs=0, device="cpu", **BEACON).fit(t.train_set)
    for name, value in flatten(jm.params).items():
        np.testing.assert_array_equal(tm.params.get_parameter(name).detach().numpy(), value, name)
    assert (tm.correlation_matrix != jm.correlation_matrix).nnz == 0
    np.testing.assert_array_equal(tm.item_probs, jm.item_probs)
    # the converted JAX parameters score as the JAX model does
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    meta = _meta(jm, ("emb_dim", "rnn_unit", "alpha", "rnn_cell_type", "nb_hop",
                      "max_seq_length", "correlation_matrix"))
    conv = model_from_params("Beacon", params, meta, device="cpu")
    users, hist = _test_histories(j)
    hist = hist + [[], [[0, 1], [2]]]  # an empty history, and a short one
    users = users + [0, 0]
    want = jm.score_baskets_batch(users, hist)
    np.testing.assert_allclose(conv.score_baskets_batch(users, hist), want, **TOL5)
    np.testing.assert_allclose(tm.score_baskets_batch(users, hist), want, **TOL5)


@pytest.mark.parametrize("nb_hop", [0, 1, 3])
def test_beacon_correlation_with_a_validation_split(nb_hop):
    j, t = _evals(test_size=0.2, val_size=0.2)
    jm = jmodels.Beacon(nb_hop=nb_hop)
    tm = tmodels.Beacon(nb_hop=nb_hop, device="cpu")
    n = len(j.global_iid_map)
    want = jm._build_correlation_matrix(j.train_set, j.val_set, n)
    got = tm._build_correlation_matrix(t.train_set, t.val_set, n)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got != want).nnz == 0
    np.testing.assert_array_equal(tm._compute_item_probs(t.train_set, t.val_set, n),
                                  jm._compute_item_probs(j.train_set, j.val_set, n))


class _KeyCapture:
    """Records the integer each ``jax.random.PRNGKey`` call is given."""

    def __init__(self, monkeypatch):
        self.seeds = []
        real = jax.random.PRNGKey

        def capture(seed):
            self.seeds.append(int(seed))
            return real(seed)

        monkeypatch.setattr(jax.random, "PRNGKey", capture)


def _assert_params(module, tree, tol, skip=()):
    for name, value in flatten(tree).items():
        if name.rsplit(".", 1)[0] not in skip:
            np.testing.assert_allclose(module.get_parameter(name).detach().numpy(), value,
                                       **tol, err_msg=name)


def test_beacon_epoch_on_the_jax_draws_matches_the_jax_fit(evals, monkeypatch):
    """One epoch of RMSProp steps, on the JAX fit's own permutation and
    dropout masks (its key, folded as its ``run_epoch`` folds it)."""
    j, t = evals
    keys = _KeyCapture(monkeypatch)
    jm = jmodels.Beacon(n_epochs=1, dropout_rate=0.3, **BEACON).fit(j.train_set)
    tm = tmodels.Beacon(n_epochs=0, dropout_rate=0.3, device="cpu", **BEACON).fit(t.train_set)
    ids, lengths, y = tm._training_data(t.train_set, "cpu")
    N, bsz = ids.shape[0], BEACON["batch_size"]
    n_total = N + (-N) % bsz
    key = jax.random.fold_in(jax.random.PRNGKey(keys.seeds[-1]), 0)
    perm = np.asarray(jax.random.permutation(key, n_total) % N)
    params = dict(tm.params.named_parameters())
    opt = tmodels.beacon.rmsprop(BEACON["lr"])
    state = opt.init(params)
    for b in range(n_total // bsz):
        idx = torch.as_tensor(perm[b * bsz:(b + 1) * bsz], dtype=torch.int64)
        drop = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, b), 0.7,
                                               (bsz, tm.max_seq_length, BEACON["emb_dim"])))
        loss = tm.loss_on(ids[idx], lengths[idx], y[idx],
                          torch.as_tensor(drop, dtype=torch.float32))
        state = step(params, opt, state, loss)
    _assert_params(tm.params, jm.params, TOL4)


# ------------------------------------------------------------------ DNNTSP --
DNNTSP = dict(emb_dim=8, batch_size=8, seed=13, lr=0.01)


def test_dnntsp_init_and_scores_match(evals):
    j, t = evals
    jm = jmodels.DNNTSP(n_epochs=0, **DNNTSP).fit(j.train_set)
    tm = tmodels.DNNTSP(n_epochs=0, device="cpu", **DNNTSP).fit(t.train_set)
    for name, value in flatten(jm.params).items():
        np.testing.assert_array_equal(tm.params.get_parameter(name).detach().numpy(), value, name)
    assert (tm._train_N, tm._train_T) == (jm._train_N, jm._train_T)
    users, hist = _test_histories(j)
    hist = hist + [[], [[0, 1], [2, 0]]]
    users = users + [0, 0]
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    meta = dict(_meta(jm, ("emb_dim", "loss_type")), train_N=jm._train_N, train_T=jm._train_T)
    conv = model_from_params("DNNTSP", params, meta, device="cpu")
    want = jm.score_baskets_batch(users, hist)
    assert np.isfinite(want).all()
    # the batch normalisation divides by the batch's spread, which lifts the
    # float32 rounding of either package to a few 1e-5 of a score: the two
    # are held at rtol 1e-4 / atol 1e-5 here, and each to a float64 forward
    # of the same parameters below
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(conv.score_baskets_batch(users, hist), want, **tol)
    np.testing.assert_allclose(tm.score_baskets_batch(users, hist), want, **tol)
    packed = jm._pack(hist[:-2], jm._train_N, jm._train_T)
    j32 = np.asarray(j_dnntsp._forward(jm.params, *packed, jm.total_items))
    blocks = [torch.as_tensor(np.asarray(a)) for a in packed]
    blocks = [blocks[0].long(), blocks[1], blocks[2].double(), blocks[3].long()]
    with torch.no_grad():
        t64 = t_dnntsp.dnntsp_scores(copy.deepcopy(tm.params).double(), *blocks).numpy()
        blocks[2] = blocks[2].float()
        t32 = t_dnntsp.dnntsp_scores(tm.params, *blocks).numpy()
    for got in (j32, t32):
        np.testing.assert_allclose(got, t64, rtol=2e-5, atol=2e-5)
    # the packed graph blocks are the JAX package's
    for a, b in zip(tm._pack(hist, 6, 4), jm._pack(hist, 6, 4)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("N, T", [(40, 6), (7, 3), (3, 9)])
def test_dnntsp_graph_blocks_are_the_jax_package_s(evals, N, T):
    """The packed blocks of random histories (repeated items in a basket,
    empty baskets, more items than N, more baskets than T) are the JAX
    package's, bit for bit."""
    j, t = evals
    jm = jmodels.DNNTSP(n_epochs=0, **DNNTSP).fit(j.train_set)
    tm = tmodels.DNNTSP(n_epochs=0, device="cpu", **DNNTSP).fit(t.train_set)
    rng = np.random.RandomState(N * T)
    hist = [[list(rng.randint(24, size=rng.randint(0, 6))) for _ in range(rng.randint(1, 8))]
            for _ in range(30)]
    for a, b in zip(tm._pack(hist, N, T), jm._pack(hist, N, T)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("loss_type, optimizer, weight_decay", [
    ("bpr", "adam", 0), ("mse", "adam", 0), ("weight_mse", "adam", 0),
    ("multi_label_soft_margin", "adam", 0), ("bpr", "adam", 0.01), ("bpr", "sgd", 0),
    ("mse", "rmsprop", 0)])
def test_dnntsp_epoch_on_the_jax_draws_matches_the_jax_fit(evals, monkeypatch, loss_type,
                                                           optimizer, weight_decay):
    """One epoch on the JAX fit's own permutation and negatives; ``adam``
    with a weight decay is ``adamw``."""
    j, t = evals
    kw = dict(DNNTSP, loss_type=loss_type, optimizer=optimizer, weight_decay=weight_decay)
    keys = _KeyCapture(monkeypatch)
    jm = jmodels.DNNTSP(n_epochs=1, **kw).fit(j.train_set)
    tm = tmodels.DNNTSP(n_epochs=0, device="cpu", **kw).fit(t.train_set)
    blocks, y, cls_w = tm._training_data(t.train_set, "cpu")
    n = tm.total_items
    B_all, bsz = y.shape[0], DNNTSP["batch_size"]
    n_total = B_all + (-B_all) % bsz
    key = jax.random.fold_in(jax.random.PRNGKey(keys.seeds[-1]), 0)
    perm = np.asarray(jax.random.permutation(key, n_total) % B_all)
    params = dict(tm.params.named_parameters())
    opt = tm._make_optimizer()
    state = opt.init(params)
    for b in range(n_total // bsz):
        idx = torch.as_tensor(perm[b * bsz:(b + 1) * bsz], dtype=torch.int64)
        neg = torch.as_tensor(np.asarray(jax.random.randint(
            jax.random.fold_in(key, b), (bsz, n), 0, n)), dtype=torch.int64)
        loss = tm.loss_on([a[idx] for a in blocks], y[idx], neg, cls_w)
        state = step(params, opt, state, loss)
    # the graph convolutions' biases come right before a batch
    # normalisation, and bpr's differences cancel the output bias, so their
    # gradients are zero in exact arithmetic: what Adam and RMSProp (which
    # divide by the gradient's size) make of its float32 rounding is noise
    # in either package, at most about 3.16 lr a step (lr (1 - b1) /
    # sqrt(1 - b2); lr / sqrt(1 - decay)); SGD moves them by less than 1e-6
    noisy = optimizer != "sgd"
    zero_grad = ("gcn_b",) + (("fc_b",) if loss_type == "bpr" else ())
    _assert_params(tm.params, jm.params, TOL4, skip=zero_grad if noisy else ())
    steps = n_total // bsz
    for name in ("gcn_b.0", "gcn_b.1") + (("fc_b",) if loss_type == "bpr" else ()):
        for value in (tm.params.get_parameter(name).detach().numpy(), flatten(jm.params)[name]):
            assert np.abs(value).max() <= (3.2 * steps * DNNTSP["lr"] if noisy else 1e-6)


def test_node_updates_add_in_any_order():
    """The gated update's scatter: the same bits whichever order its adds
    run in, since the only repeated target is a padded node's id 0 with a
    zero update (item 0 is also a real node of row 0 here)."""
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn(2, 9, 3, generator=gen)
    ids = torch.tensor([[0, 4, 7, 0, 0], [2, 5, 0, 0, 0]])
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 0, 0, 0]], dtype=torch.float32)
    update = torch.randn(2, 5, 3, generator=gen) * mask[..., None]
    want = t_dnntsp.add_node_updates(embed, ids, update)
    for order in (torch.arange(5).flip(0), torch.tensor([3, 0, 4, 2, 1])):
        got = t_dnntsp.add_node_updates(embed, ids[:, order], update[:, order])
        assert torch.equal(got, want)
    assert torch.equal(want[0, 0], embed[0, 0] + update[0, 0])


def test_adamw_matches_optax():
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    opt = optax.adamw(0.01, weight_decay=0.05)
    jp, js = dict(params), opt.init(params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    t_opt = adamw(0.01, weight_decay=0.05)
    ts = t_opt.init(tp)
    for g in grads:
        updates, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, updates)
        tu, ts = t_opt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp)
        for k in tp:
            tp[k] = tp[k] + tu[k]
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        t_opt.update({k: torch.tensor(v) for k, v in grads[0].items()}, ts)


# -------------------------------------------------- the whole Experiment --
def test_experiment_table_at_basket_txt_matches_jax(tmp_path, monkeypatch):
    """GPTop (three ways), TIFUKNN and UPCF, and Beacon and DNNTSP at their
    initial parameters (no epoch: their trained streams differ), under
    ``NextBasketEvaluation`` with both breakdowns."""
    monkeypatch.chdir(tmp_path)
    data = jdata.Reader().read(os.path.join(ROOT, "tests", "data", "basket.txt"), fmt="UBIT")
    assert tdata.Reader().read(os.path.join(ROOT, "tests", "data", "basket.txt"),
                               fmt="UBIT") == data
    tables = []
    for pkg, exp, dev in ((jeval, jexp, {}), (teval, texp, {"device": "cpu"})):
        models = pkg is jeval and jmodels or tmodels
        metrics = pkg is jeval and jmetrics or tmetrics
        ev = pkg.NextBasketEvaluation(data=data, test_size=0.25, fmt="UBIT", seed=123,
                                      repetition_eval=True, exploration_eval=True)
        run = exp.Experiment(ev, [
            models.GPTop(name="GTop", use_personalized_popularity=False),
            models.GPTop(name="PTop", use_global_popularity=False), models.GPTop(),
            models.TIFUKNN(n_neighbors=3, **dev), models.UPCF(recency=2, **dev),
            models.Beacon(n_epochs=0, seed=123, **dev),
            models.DNNTSP(emb_dim=8, n_epochs=0, seed=123, **dev)],
            [metrics.Recall(k=5), metrics.NDCG(k=5), metrics.HitRatio(k=5)])
        run.run()
        tables.append(run.result)
    want, got = tables
    for g, w in zip(got, want):
        assert g.model_name == w.model_name
        keys = [k for k in w.metric_avg_results if not k.endswith("(s)")]
        assert [k for k in g.metric_avg_results if not k.endswith("(s)")] == keys
        assert "Recall@5-rep" in keys and "Recall@5-expl" in keys
        np.testing.assert_allclose([g.metric_avg_results[k] for k in keys],
                                   [w.metric_avg_results[k] for k in keys], rtol=0, atol=1e-6)


# ------------------------------------------------------- bits, refusals --
@pytest.mark.parametrize("name", ["Beacon", "DNNTSP"])
def test_seeded_refits_are_identical(evals, name):
    _, t = evals
    kw = BEACON if name == "Beacon" else DNNTSP
    fits = [getattr(tmodels, name)(n_epochs=2, device="cpu", **kw).fit(t.train_set)
            for _ in range(2)]
    for (key, a), b in zip(fits[0].params.named_parameters(), fits[1].params.parameters()):
        assert torch.equal(a, b), key


@pytest.mark.parametrize("make", [lambda: tmodels.Beacon(mesh=object()),
                                  lambda: tmodels.DNNTSP(mesh=object()),
                                  lambda: teval.NextBasketEvaluation(data=ROWS, mesh=object())])
def test_mesh_is_refused(make):
    # mesh= is ported (tests/test_torch_parallel_sequences.py): anything but
    # a parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        make()


def test_refusals_match_jax():
    with pytest.raises(ValueError):
        tmodels.Beacon(rnn_cell_type="nope")
    with pytest.raises(ValueError):
        tmodels.DNNTSP(loss_type="nope")
    with pytest.raises(ValueError):
        tmodels.DNNTSP(emb_dim=10)
    with pytest.raises(ValueError, match="NextBasketRecommender"):
        _evals()[1].evaluate(tmodels.SPop(), [tmetrics.Recall(k=5)], user_based=False)
