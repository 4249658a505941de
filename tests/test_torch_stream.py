"""The port's RMSProp stream epoch, SoRec and MCF against the JAX
package's, on the CPU.

- ``ops.rmsprop.rmsprop_stream_epoch`` against the JAX function on the same
  order, with rows repeated within a minibatch and separate learning rates
  for the two tables, linear and non-linear: the four tables and the loss
  within rtol 1e-5 / atol 1e-6 (the last duplicate of a row sets its cache
  in both; ``accumulate_rows`` adds a row's summed updates once where XLA
  adds them one by one: float32 rounding apart).
- ``run_stream_epoch`` takes its order from the caller's numpy generator,
  as the JAX package's does: the same permutation, and the generator left
  in the same state.
- PMF's epoch is the shared stream epoch at one learning rate, bit for bit.
- SoRec's link weights byte for byte equal to the JAX package's per-edge
  loop over ``get_node_degree``.
- Whole SoRec and MCF fits, which draw their orders from the same numpy
  stream as the JAX package's, within atol 1e-5 of the JAX fits' U, V and
  Z at the examples' settings (float32 rounding, which RMSProp's steps of
  about lr each carry from one epoch to the next).
- ``convert.model_from_params``: a JAX fit's tables carried into the port
  give its ``score``, ``score_batch``, ``score_pairs`` and ``recommend``.
- a ``mesh=`` that is no ``parallel.make_mesh`` mesh refused.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
import cornac_tpu.data as jdata
import cornac_tpu.eval_methods as jeval
import cornac_tpu.models as J
from cornac_tpu.data import Reader
from cornac_tpu.ops.rmsprop import rmsprop_stream_epoch as j_stream_epoch
from cornac_tpu.ops.rmsprop import run_stream_epoch as j_run_stream_epoch
import cornac_tpu_torch.data as pdata
import cornac_tpu_torch.eval_methods as peval
from cornac_tpu_torch import models as P
from cornac_tpu_torch.convert import model_from_params
from cornac_tpu_torch.models import pmf as pmf_mod
from cornac_tpu_torch.models.sorec import link_weights
from cornac_tpu_torch.ops import rmsprop as rms

cornac_tpu_torch.set_default_device("cpu")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "rating.txt")
STEP = dict(rtol=1e-5, atol=1e-6)
FIT = dict(rtol=0, atol=1e-5)
_SNAPSHOT = ("num_users", "num_items", "uid_map", "iid_map", "min_rating", "max_rating",
             "global_mean")


def _graphs(data):
    """A seeded trust graph over the users and a seeded item graph with
    values 1-3 (so MCF rescales them), each with repeated edges."""
    users = sorted({u for u, _, _ in data})
    items = sorted({i for _, i, _ in data})
    rng = np.random.RandomState(5)
    trust = [(users[a], users[b], 1.0) for a, b in rng.randint(len(users), size=(200, 2))
             if a != b]
    graph = [(items[a], items[b], float(rng.randint(1, 4)))
             for a, b in rng.randint(len(items), size=(300, 2)) if a != b]
    return trust, graph


@pytest.fixture(scope="module")
def splits():
    data = Reader().read(DATA, fmt="UIR")
    trust, graph = _graphs(data)

    def split(d, e):
        return e.RatioSplit(data=data, test_size=0.2, rating_threshold=3.0, seed=123,
                            exclude_unknowns=True, user_graph=d.GraphModality(data=trust),
                            item_graph=d.GraphModality(data=graph), verbose=False)

    return split(jdata, jeval), split(pdata, peval)


# ------------------------------------------------------------ the epoch --


@pytest.mark.parametrize("non_linear", [False, True])
@pytest.mark.parametrize("bs", [64, 100])
def test_stream_epoch_with_duplicate_rows_matches_jax(non_linear, bs):
    rng = np.random.RandomState(7)
    n, k, n_a, n_b = 300, 5, 13, 9  # 300 observations over 13 x 9 rows: every row repeats
    rows, cols = rng.randint(n_a, size=n), rng.randint(n_b, size=n)
    vals = rng.rand(n).astype(np.float32)
    A = rng.normal(0, 0.3, (n_a, k)).astype(np.float32)
    B = rng.normal(0, 0.3, (n_b, k)).astype(np.float32)
    ca = np.abs(rng.normal(0, 0.01, (n_a, k))).astype(np.float32)
    cb = np.abs(rng.normal(0, 0.01, (n_b, k))).astype(np.float32)
    n_pad = (-n) % bs
    perm = np.concatenate([rng.permutation(n), np.zeros(n_pad, np.int64)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    lr_a, lr_b, reg, gamma = 0.02, 0.005, 0.01, 0.9
    want = j_stream_epoch(*(jnp.asarray(a.copy()) for a in (A, B, ca, cb)),
                          jnp.asarray(perm, jnp.int32), jnp.asarray(mask), jnp.asarray(rows),
                          jnp.asarray(cols), jnp.asarray(vals), jnp.float32(lr_a),
                          jnp.float32(lr_b), jnp.float32(reg), jnp.float32(gamma),
                          batch_size=bs, non_linear=non_linear)
    tables = [torch.tensor(a) for a in (A, B, ca, cb)]
    pairs = torch.from_numpy(np.stack([rows, cols], 1).astype(np.int64))
    loss = rms.rmsprop_stream_epoch(*tables, torch.from_numpy(perm), torch.from_numpy(mask),
                                    pairs, torch.from_numpy(vals), lr_a, lr_b, reg, gamma, bs,
                                    non_linear)
    np.testing.assert_allclose(float(loss), float(want[4]), **STEP)
    for ours, theirs in zip(tables, want[:4]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **STEP)


def test_run_stream_epoch_draws_the_jax_packages_order():
    rng = np.random.RandomState(3)
    n, k = 50, 3
    rows, cols = rng.randint(6, size=n), rng.randint(4, size=n)
    vals = rng.rand(n).astype(np.float32)
    A, B = rng.normal(0, 0.3, (6, k)).astype(np.float32), rng.normal(0, 0.3, (4, k)).astype(
        np.float32)
    j_rng, t_rng = np.random.RandomState(9), np.random.RandomState(9)
    want = j_run_stream_epoch(jnp.asarray(A), jnp.asarray(B), jnp.zeros_like(A),
                              jnp.zeros_like(B), jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(vals), j_rng, 0.01, 0.01, 0.001, 0.9, batch_size=16)
    perm, mask, bsz = rms.stream_order(n, 16, np.random.RandomState(9), "cpu")
    assert bsz == 16 and perm.shape[0] == 64 and float(mask.sum()) == n
    np.testing.assert_array_equal(perm[:n].numpy(), np.random.RandomState(9).permutation(n))
    tables = [torch.tensor(A), torch.tensor(B), torch.zeros(6, k), torch.zeros(4, k)]
    pairs = torch.from_numpy(np.stack([rows, cols], 1).astype(np.int64))
    rms.run_stream_epoch(*tables, pairs, torch.from_numpy(vals), t_rng, 0.01, 0.01, 0.001, 0.9,
                         batch_size=16)
    assert j_rng.randint(2**31) == t_rng.randint(2**31)
    for ours, theirs in zip(tables, want[:4]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **STEP)


def test_pmf_epoch_is_the_shared_stream_epoch():
    rng = np.random.RandomState(4)
    n, k = 200, 4
    pairs = torch.from_numpy(np.stack([rng.randint(20, size=n), rng.randint(15, size=n)], 1))
    vals = torch.from_numpy(rng.rand(n).astype(np.float32))
    tables = [torch.from_numpy(rng.normal(0, 0.3, (m, k)).astype(np.float32)) for m in (20, 15)]
    perm = torch.from_numpy(rng.permutation(n))
    mask = torch.ones(n)
    a = [t.clone() for t in tables] + [torch.zeros(20, k), torch.zeros(15, k)]
    b = [t.clone() for t in a]
    la = pmf_mod._pmf_epoch(*a, perm, mask, pairs, vals, 0.01, 0.02, 0.9, 64, True)
    lb = rms.rmsprop_stream_epoch(*b, perm, mask, pairs, vals, 0.01, 0.01, 0.02, 0.9, 64, True)
    assert pmf_mod.set_rows_last_wins is rms.set_rows_last_wins
    assert torch.equal(la, lb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------- SoRec --


def test_link_weights_are_the_reference_loop_byte_for_byte(splits):
    train = splits[0].train_set
    users = set(train.uir_tuple[0])
    rows, cols, vals = train.user_graph.get_train_triplet(users, users)
    degree = train.user_graph.get_node_degree(users, users)
    want = np.asarray([math.sqrt(degree[int(j)][0] / (degree[int(j)][0] + degree[int(u)][1])) * v
                       for u, j, v in zip(rows, cols, vals)], dtype="float32")
    got = link_weights(rows, cols, vals)
    assert got.dtype == np.float32 and len(got) == len(rows) > 50
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


SOREC = dict(k=5, max_iter=30, learning_rate=0.001, lambda_c=10, lambda_reg=0.001,
             batch_size=32)
MCF_KW = dict(k=5, max_iter=30, learning_rate=0.001, batch_size=32)


@pytest.mark.parametrize("name, kw", [("SoRec", dict(SOREC, weight_link=True)),
                                      ("SoRec", dict(SOREC, weight_link=False)),
                                      ("MCF", MCF_KW)])
def test_whole_fits_match_the_jax_fits(splits, name, kw):
    js, ps = splits
    jm = getattr(J, name)(seed=11, **kw).fit(js.train_set)
    pm = getattr(P, name)(seed=11, **kw).fit(ps.train_set)
    again = getattr(P, name)(seed=11, **kw).fit(ps.train_set)
    for table in ("U", "V", "Z"):
        ours, theirs = getattr(pm, table), getattr(jm, table)
        assert ours.dtype == theirs.dtype == np.float64 and ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, **FIT, err_msg=table)
        np.testing.assert_array_equal(getattr(again, table), ours)  # a refit is bit for bit
    assert np.abs(pm.U).max() > 1e-3  # the fit moved away from its N(0, 0.001) start


@pytest.mark.parametrize("name, kw", [("SoRec", SOREC), ("MCF", MCF_KW)])
def test_scores_through_convert_match_jax(splits, name, kw):
    js, ps = splits
    jm = getattr(J, name)(seed=2, **{**kw, "max_iter": 5}).fit(js.train_set)
    meta = {**{n: getattr(jm, n) for n in _SNAPSHOT}, "k": jm.k}
    pm = model_from_params(name, {n: getattr(jm, n) for n in "UVZ"}, meta, device="cpu")
    users = np.arange(jm.num_users)
    items = np.arange(jm.num_items)
    np.testing.assert_allclose(pm.score_batch(users), jm.score_batch(users), rtol=1e-12)
    for u in (0, 3, jm.num_users - 1):
        np.testing.assert_allclose(pm.score(u), jm.score(u), rtol=1e-12)
        np.testing.assert_allclose(pm.score(u, 2), jm.score(u, 2), rtol=1e-12)
    uu, ii = np.repeat(users[:5], 4), np.tile(items[:4], 5)
    uu[0], ii[1] = jm.num_users + 3, jm.num_items + 1  # unknown: the default score
    np.testing.assert_allclose(pm.score_pairs(uu, ii), jm.score_pairs(uu, ii), rtol=1e-12)
    np.testing.assert_allclose(pm.score_batch_device(users).numpy(),
                               jm.score_batch(users).astype(np.float32), rtol=1e-5, atol=1e-7)
    raw = list(jm.uid_map)[:6]
    for k in (3, -1):
        assert pm.recommend_batch(raw, k=k) == jm.recommend_batch(raw, k=k)
    assert pm.recommend(raw[0], k=5) == jm.recommend(raw[0], k=5)


@pytest.mark.parametrize("cls", [P.SoRec, P.MCF])
def test_mesh_is_refused(cls):
    # mesh= is ported (tests/test_torch_parallel_side.py): anything but a
    # parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        cls(mesh=object())
