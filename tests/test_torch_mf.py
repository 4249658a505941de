"""The port's MF/SVD and baselines against the JAX package's, on the CPU.

- One MF epoch on the JAX package's own permutation (drawn in the test as
  ``cornac_tpu/models/mf.py::_mf_sgd_epochs`` draws it): factors, biases
  and the loss within rtol 1e-5 / atol 1e-6 of ``_mf_sgd_epochs``
  (float32 sums in another order), with and without the biases.
- ``BaselineOnly``: both packages draw the epochs' permutations with numpy
  from the seed, so a whole fit is held to the JAX fit, rtol 1e-5 / atol
  1e-6.
- ``GlobalAvg`` and ``MostPop``: scores equal, exactly.
- Seeded initial factors equal to the JAX package's, bit for bit; a
  verbose fit equal to a one-chunk fit, bit for bit.
- An ``Experiment`` with MF and BaselineOnly on RMSE, MAE and NDCG@10: the
  BaselineOnly row within 1e-5 of the JAX table; the MF row, whose epochs
  visit the ratings in another random order, RMSE and MAE within 0.005 and
  NDCG@10 within 0.015 (over six seeds on this data the MF row's
  seed-to-seed spread was about 2e-4 in RMSE and MAE and 1.4e-3 in NDCG@10
  in either package, and same-seed differences reached 7e-4 and 3.6e-3).
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
from cornac_tpu.metrics import MAE as JMAE, NDCG as JNDCG, RMSE as JRMSE
from cornac_tpu.models import (BaselineOnly as JBaselineOnly, GlobalAvg as JGlobalAvg,
                               MF as JMF, MostPop as JMostPop, SVD as JSVD)
from cornac_tpu.models.mf import _mf_sgd_epochs
from cornac_tpu_torch import Experiment
from cornac_tpu_torch.convert import baseline_from_arrays, mf_from_arrays
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.eval_methods import RatioSplit
from cornac_tpu_torch.metrics import MAE, NDCG, RMSE
from cornac_tpu_torch.models import MF, SVD, BaselineOnly, GlobalAvg, MostPop
from cornac_tpu_torch.models import mf as mf_mod

cornac_tpu_torch.set_default_device("cpu")

TIMES = ("Train (s)", "Test (s)", "Time (s)")


def _uir(seed=5, n_users=90, n_items=70, n=2000):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    ub, ib = rng.normal(0, 0.7, n_users), rng.normal(0, 0.7, n_items)
    return [(f"u{u}", f"i{i}", float(np.clip(np.rint(3.5 + ub[u] + ib[i] + rng.normal(0, 0.5)), 1, 5)))
            for u, i in pairs]


@pytest.mark.parametrize("use_bias", [True, False])
def test_one_epoch_on_jax_permutation(use_bias, epoch=2, lr=0.05, reg=0.02, bs=128):
    rng = np.random.RandomState(0)
    n_users, n_items, k, n = 31, 23, 5, 500
    rid = rng.randint(n_users, size=n).astype(np.int32)
    cid = rng.randint(n_items, size=n).astype(np.int32)
    val = rng.randint(1, 6, size=n).astype(np.float32)
    U = rng.normal(0, 0.1, (n_users, k)).astype(np.float32)
    V = rng.normal(0, 0.1, (n_items, k)).astype(np.float32)
    Bu = rng.normal(0, 0.1, n_users).astype(np.float32)
    Bi = rng.normal(0, 0.1, n_items).astype(np.float32)
    mu = np.float32(val.mean()) if use_bias else np.float32(0.0)
    n_pad = (-n) % bs
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    key = jax.random.PRNGKey(17)
    jU, jV, jBu, jBi, j_loss = _mf_sgd_epochs(
        *(jnp.asarray(a.copy()) for a in (U, V, Bu, Bi)), key, jnp.asarray(mask),
        jnp.asarray(rid), jnp.asarray(cid), jnp.asarray(val), jnp.float32(lr), jnp.float32(reg),
        mu, batch_size=bs, use_bias=use_bias, n_epochs=1, epoch_offset=epoch,
    )
    # the permutation of _mf_sgd_epochs (cornac_tpu/models/mf.py:90-95)
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(key, epoch), n), np.int64)
    perm = torch.from_numpy(np.concatenate([perm, np.zeros(n_pad, np.int64)]))
    tU, tV, u_gate, v_gate = mf_mod._extended_tables(U, V, Bu, Bi, use_bias, "cpu")
    loss = mf_mod._mf_epoch(
        tU, tV, perm, torch.from_numpy(mask),
        torch.from_numpy(np.stack([rid, cid], axis=1).astype(np.int64)), torch.from_numpy(val),
        lr, reg, float(mu) if use_bias else None, bs, u_gate, v_gate)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(j_loss), **tol)
    np.testing.assert_allclose(tU[:, :k].numpy(), np.asarray(jU), **tol)
    np.testing.assert_allclose(tV[:, :k].numpy(), np.asarray(jV), **tol)
    if use_bias:
        np.testing.assert_allclose(tU[:, k].numpy(), np.asarray(jBu), **tol)
        np.testing.assert_allclose(tV[:, k + 1].numpy(), np.asarray(jBi), **tol)
        assert torch.equal(tU[:, k + 1], torch.ones(n_users))
        assert torch.equal(tV[:, k], torch.ones(n_items))


@pytest.mark.parametrize("cls,j_cls,kw", [(MF, JMF, {}), (MF, JMF, {"use_bias": False}),
                                           (SVD, JSVD, {})])
def test_seeded_init_matches_jax(cls, j_cls, kw):
    data = _uir()
    ours = cls(k=4, seed=11, trainable=False, **kw).fit(Dataset.from_uir(data, seed=1))
    theirs = j_cls(k=4, seed=11, trainable=False, **kw).fit(JDataset.from_uir(data, seed=1))
    for name in ("u_factors", "i_factors", "u_biases", "i_biases", "global_mean"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    assert np.asarray(ours.global_mean).dtype == np.float32


def test_verbose_fit_equals_one_chunk(capsys):
    train = Dataset.from_uir(_uir(), seed=1)
    fits = [MF(k=4, max_iter=3, seed=2, verbose=verbose).fit(train) for verbose in (False, True)]
    for name in ("u_factors", "i_factors", "u_biases", "i_biases"):
        np.testing.assert_array_equal(getattr(fits[0], name), getattr(fits[1], name))
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(",")[0] for line in lines] == ["Epoch 1/3", "Epoch 2/3", "Epoch 3/3"]


@pytest.mark.parametrize("cls,j_cls", [(MF, JMF), (BaselineOnly, JBaselineOnly)])
def test_early_stop_matches_jax(cls, j_cls, capsys):
    # every rating 3 and zero initial factors: the loss is exactly 0 in
    # every epoch, whatever the order of the sums, so both stop after two
    data = [(u, i, 3.0) for u, i, _ in _uir()]
    outs = []
    for make, ds in ((cls, Dataset), (j_cls, JDataset)):
        train = ds.from_uir(data, seed=1)
        init = {"U": np.zeros((train.num_users, 4), np.float32),
                "V": np.zeros((train.num_items, 4), np.float32)} if cls is MF else None
        kw = {"k": 4} if cls is MF else {}
        make(max_iter=50, early_stop=True, verbose=True, seed=2, init_params=init, **kw).fit(train)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "Epoch 2/50" in outs[0] and "Epoch 3/50" not in outs[0]


def test_unported_options_raise():
    train = Dataset.from_uir(_uir(), seed=1)
    # the optax path is ported (tests/test_torch_factor.py); an optimizer
    # optax's table lacks raises, as in the JAX package
    for kw in ({"optimizer": "adam"}, {"dropout": 0.1}):
        assert np.isfinite(MF(max_iter=1, **kw).fit(train).u_factors).all()
    with pytest.raises(ValueError, match="optimizer"):
        MF(max_iter=1, optimizer="lbfgs").fit(train)
    MF(optimizer="adam", trainable=False).fit(train)  # serving given factors needs no trainer
    for cls in (MF, BaselineOnly):
        with pytest.raises(NotImplementedError, match="A8"):
            cls(mesh=object())
    with pytest.raises(ValueError):
        MF(backend="tensorflow")


@pytest.mark.parametrize("kw", [{}, {"verbose": True}])
def test_baseline_only_fit_matches_jax(kw, capsys):
    data = _uir()
    cfg = dict(max_iter=8, learning_rate=0.02, batch_size=64, seed=7)
    cfg.update(kw)
    ours = BaselineOnly(**cfg).fit(Dataset.from_uir(data, seed=1))
    our_lines = capsys.readouterr().out.splitlines()
    theirs = JBaselineOnly(**cfg).fit(JDataset.from_uir(data, seed=1))
    their_lines = capsys.readouterr().out.splitlines()
    assert len(our_lines) == len(their_lines) == (cfg["max_iter"] if kw else 0)
    for name in ("u_biases", "i_biases"):
        np.testing.assert_allclose(getattr(ours, name), getattr(theirs, name), rtol=1e-5, atol=1e-6)
    users, items = np.arange(95) % 92, np.arange(95) % 72  # a few unknown indices
    np.testing.assert_allclose(ours.score_pairs(users, items), theirs.score_pairs(users, items),
                               rtol=1e-6)
    np.testing.assert_allclose(ours.score_batch(np.arange(20)), theirs.score_batch(np.arange(20)),
                               rtol=1e-6)
    np.testing.assert_allclose(ours.score_batch_device(np.arange(20)).numpy(),
                               np.asarray(theirs.score_batch_device(np.arange(20))), rtol=1e-6)


@pytest.mark.parametrize("cls,j_cls", [(GlobalAvg, JGlobalAvg), (MostPop, JMostPop)])
def test_non_personalized_baselines_are_exact(cls, j_cls):
    data = _uir()
    ours, theirs = cls().fit(Dataset.from_uir(data, seed=1)), j_cls().fit(JDataset.from_uir(data, seed=1))
    users, items = np.arange(30), np.arange(30) * 2
    np.testing.assert_array_equal(ours.score(3), theirs.score(3))
    np.testing.assert_array_equal(ours.score_batch(users), theirs.score_batch(users))
    np.testing.assert_array_equal(ours.score_pairs(users, items), theirs.score_pairs(users, items))
    np.testing.assert_array_equal(ours.score_batch_device(users).numpy(),
                                  np.asarray(theirs.score_batch_device(users)))
    unknown = np.array([0, 500])  # an unknown user takes the default score
    np.testing.assert_array_equal(ours.score_batch_device(unknown).numpy(),
                                  np.asarray(theirs.score_batch_device(unknown)))


def test_mf_scoring_matches_jax_on_the_same_factors():
    data = _uir()
    theirs = JMF(k=4, max_iter=3, seed=2).fit(JDataset.from_uir(data, seed=1))
    meta = {name: getattr(theirs, name) for name in (
        "k", "use_bias", "num_users", "num_items", "uid_map", "iid_map", "min_rating",
        "max_rating", "global_mean")}
    ours = mf_from_arrays({name: getattr(theirs, name) for name in (
        "u_factors", "i_factors", "u_biases", "i_biases")}, meta, device="cpu")
    users = np.array([0, 5, 17, 300])  # 300 is unknown
    items = np.array([1, 2, 69, 400])
    np.testing.assert_allclose(ours.score_batch_device(users).numpy(),
                               np.asarray(theirs.score_batch_device(users)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.score_batch(users[:3]), theirs.score_batch(users[:3]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours.score_pairs(users, items), theirs.score_pairs(users, items))
    np.testing.assert_array_equal(ours.rate_batch(users, items), theirs.rate_batch(users, items))
    np.testing.assert_array_equal(ours.score(5), theirs.score(5))
    np.testing.assert_array_equal(ours.get_item_vectors(), theirs.get_item_vectors())
    assert ours.recommend_batch(["u1", "u2"], k=5) == theirs.recommend_batch(["u1", "u2"], k=5)

    j_bo = JBaselineOnly(max_iter=3, seed=2).fit(JDataset.from_uir(data, seed=1))
    bo = baseline_from_arrays({"u_biases": j_bo.u_biases, "i_biases": j_bo.i_biases},
                              {name: getattr(j_bo, name) for name in meta if name not in ("k", "use_bias")},
                              device="cpu")
    np.testing.assert_array_equal(bo.score_pairs(users, items), j_bo.score_pairs(users, items))


def _experiment(pkg, data, seed):
    kw = dict(data=data, test_size=0.2, rating_threshold=4.0, exclude_unknowns=True, seed=123)
    if pkg == "jax":
        split, exp_cls = JRatioSplit(**kw), JExperiment
        models = [JMF(k=8, max_iter=15, seed=seed), JBaselineOnly(max_iter=15, seed=seed)]
        metrics = [JRMSE(), JMAE(), JNDCG(k=10)]
    else:
        split, exp_cls = RatioSplit(**kw), Experiment
        models = [MF(k=8, max_iter=15, seed=seed), BaselineOnly(max_iter=15, seed=seed)]
        metrics = [RMSE(), MAE(), NDCG(k=10)]
    exp = exp_cls(split, models, metrics)
    exp.run()
    return {r.model_name: {k: v for k, v in r.metric_avg_results.items() if k not in TIMES}
            for r in exp.result}


def test_experiment_table_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the log file goes to the working directory
    data = _uir(seed=8, n_users=200, n_items=120, n=6000)
    ours, theirs = _experiment("torch", data, 3), _experiment("jax", data, 3)
    assert list(ours) == list(theirs) == ["MF", "BaselineOnly"]
    for name in ("RMSE", "MAE", "NDCG@10"):
        assert abs(ours["BaselineOnly"][name] - theirs["BaselineOnly"][name]) <= 1e-5
    for name, tol in (("RMSE", 0.005), ("MAE", 0.005), ("NDCG@10", 0.015)):
        assert abs(ours["MF"][name] - theirs["MF"][name]) <= tol, (name, ours["MF"], theirs["MF"])
