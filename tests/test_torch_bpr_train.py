"""The port's BPR trainer against the JAX package's, on the CPU.

- One epoch on the JAX package's own draws: the test draws them with
  ``jax.random`` from the key as ``cornac_tpu/models/bpr.py::_bpr_epochs``
  does (one bulk draw, or one per minibatch above ``_BULK_SAMPLING_MAX``)
  and feeds them to the port's epoch. Factors within rtol 1e-5 / atol 1e-6
  of ``_bpr_epochs(n_epochs=1, W16=None)`` (float32 sums in another
  order), ``correct`` and ``skipped`` equal, with and without the bias,
  for ``bpr`` and ``hinge``, uniform and popularity negatives.
- Seeded initial factors equal to the JAX package's, bit for bit; a
  verbose fit (one epoch per chunk) equal to a one-chunk fit, bit for bit.
- A 30-epoch fit at the ``bench.py`` shape: AUC within 1e-3 and NDCG@10
  within 0.01 of the JAX package's fit with the same seed. The two draw
  different random streams; over six seeds the packages' seed-to-seed
  spread was about 1.1e-4 (AUC) and 1.5e-3 (NDCG@10), and same-seed
  differences reached 1.3e-4 and 2.1e-3.
"""

import importlib.util
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.eval_methods import RatioSplit as JRatioSplit
from cornac_tpu.eval_methods.base_method import ranking_eval as j_ranking_eval
from cornac_tpu.metrics import AUC as JAUC, NDCG as JNDCG
from cornac_tpu.models import BPR as JBPR, MMMF as JMMMF, WBPR as JWBPR
import cornac_tpu.models.bpr as j_bpr_mod
from cornac_tpu.ops.membership import build_membership as j_build_membership
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.eval_methods import RatioSplit
from cornac_tpu_torch.eval_methods.base_method import ranking_eval
from cornac_tpu_torch.metrics import AUC, NDCG
from cornac_tpu_torch.models import BPR, MMMF, WBPR
import cornac_tpu_torch.models.bpr as bpr_mod
from cornac_tpu_torch.ops.membership import build_membership

cornac_tpu_torch.set_default_device("cpu")

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test", ROOT / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_draws(key, epoch, n, n_total, batch_size, num_items, population, bulk):
    """The draws of ``_bpr_epochs`` (cornac_tpu/models/bpr.py:162-178,
    :186-193) for global epoch ``epoch``, as torch int64 tensors."""
    k_pos, k_neg = jax.random.split(jax.random.fold_in(key, epoch))

    def sample(kp, kn, shape):
        pos = jax.random.randint(kp, shape, 0, n)
        if population is None:
            neg = jax.random.randint(kn, shape, 0, num_items)
        else:
            neg = population[jax.random.randint(kn, shape, 0, population.shape[0])]
        return torch.from_numpy(np.asarray(pos, np.int64)), torch.from_numpy(np.asarray(neg, np.int64))

    if bulk:
        return [sample(k_pos, k_neg, (n_total,))]
    return [sample(jax.random.fold_in(k_pos, b), jax.random.fold_in(k_neg, b), (batch_size,))
            for b in range(n_total // batch_size)]


def _problem(seed=0, n_users=29, n_items=41, n=400, k=6):
    rng = np.random.RandomState(seed)
    rid = rng.randint(0, n_users, n).astype(np.int32)
    cid = rng.randint(0, n_items, n).astype(np.int32)
    csr = sp.csr_matrix((np.ones(n, np.float32), (rid, cid)), shape=(n_users, n_items))
    csr.sum_duplicates()
    U = rng.normal(0, 0.1, (n_users, k)).astype(np.float32)
    V = rng.normal(0, 0.1, (n_items, k)).astype(np.float32)
    Bi = rng.normal(0, 0.1, n_items).astype(np.float32)
    return rid, cid, csr, U, V, Bi


@pytest.mark.parametrize("sampling", ["bulk", "per_minibatch"])
@pytest.mark.parametrize("variant", ["bpr", "hinge"])
@pytest.mark.parametrize("use_bias", [True, False])
def test_one_epoch_on_jax_draws(monkeypatch, sampling, variant, use_bias):
    bulk = sampling == "bulk"
    if not bulk:
        monkeypatch.setattr(j_bpr_mod, "_BULK_SAMPLING_MAX", 1)
        monkeypatch.setattr(bpr_mod, "_BULK_SAMPLING_MAX", 1)
    # a batch size of each mode's own: the JAX program reads the switch
    # while tracing, and its cache must not serve the other mode's trace
    batch_size = 64 if bulk else 56
    _epoch_case(batch_size, variant, use_bias, None, bulk)


def test_one_epoch_on_jax_draws_popularity_negatives():
    rid, cid, *_ = _problem()
    _epoch_case(64, "bpr", True, cid, True)


def _epoch_case(batch_size, variant, use_bias, population, bulk, epoch=3, lr=0.05, reg=0.01):
    rid, cid, csr, U, V, Bi = _problem()
    n_users, n_items = csr.shape
    n, k = len(rid), U.shape[1]
    n_total = n + (-n) % batch_size
    key = jax.random.PRNGKey(42)
    pop = None if population is None else jnp.asarray(population, jnp.int32)
    jU, jV, jBi, j_correct, j_skipped = j_bpr_mod._bpr_epochs(
        jnp.asarray(U.copy()), jnp.asarray(V.copy()), jnp.asarray(Bi.copy()), key,
        jnp.asarray(np.stack([rid, cid], axis=1), jnp.int32), j_build_membership(csr), pop,
        jnp.float32(lr), jnp.float32(reg), batch_size=batch_size, use_bias=use_bias,
        num_items=n_items, n_epochs=1, epoch_offset=epoch, variant=variant, W16=None,
    )
    draws = _jax_draws(key, epoch, n, n_total, batch_size, n_items, pop, bulk)
    tU, tV, gate = bpr_mod._extended_tables(U, V, Bi, use_bias, "cpu")
    pairs = torch.from_numpy(np.stack([rid, cid], axis=1).astype(np.int64))
    correct, skipped = bpr_mod._bpr_epoch(tU, tV, draws, pairs, build_membership(csr), n, lr,
                                          reg, batch_size, gate, variant)
    assert int(correct) == int(j_correct) and int(skipped) == int(j_skipped)
    assert int(skipped) > n_total - n  # observed negatives were drawn and skipped
    np.testing.assert_allclose(tU[:, :k].numpy(), np.asarray(jU), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tV[:, :k].numpy(), np.asarray(jV), rtol=1e-5, atol=1e-6)
    if use_bias:
        np.testing.assert_allclose(tV[:, k].numpy(), np.asarray(jBi), rtol=1e-5, atol=1e-6)
        assert torch.equal(tU[:, k], torch.ones(n_users))  # the frozen column
    else:
        np.testing.assert_array_equal(np.asarray(jBi), Bi)


def test_draws_switch_to_per_minibatch(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    sizes = [p.shape[0] for p, _ in bpr_mod._bpr_draws(gen, 300, 320, 64, 10, None)]
    assert sizes == [320]
    monkeypatch.setattr(bpr_mod, "_BULK_SAMPLING_MAX", 100)
    sizes = [p.shape[0] for p, _ in bpr_mod._bpr_draws(gen, 300, 320, 64, 10, None)]
    assert sizes == [64] * 5
    pop = torch.tensor([7, 7, 7])
    negs = torch.cat([j for _, j in bpr_mod._bpr_draws(gen, 300, 320, 64, 10, pop)])
    assert set(negs.tolist()) == {7}


def _uir(seed=4, n_users=70, n_items=50, n=1200):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]


@pytest.mark.parametrize("cls,j_cls", [(BPR, JBPR), (WBPR, JWBPR), (MMMF, JMMMF)])
def test_seeded_init_matches_jax(cls, j_cls):
    data = _uir()
    ours = cls(k=7, seed=3, trainable=False).fit(Dataset.from_uir(data, seed=1))
    theirs = j_cls(k=7, seed=3, trainable=False).fit(JDataset.from_uir(data, seed=1))
    for name in ("u_factors", "i_factors", "i_biases"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name))
    assert ours._variant == theirs._variant and ours.use_bias == theirs.use_bias


@pytest.mark.parametrize("cls", [BPR, WBPR, MMMF])
def test_verbose_fit_equals_one_chunk(cls, capsys):
    train = Dataset.from_uir(_uir(), seed=1)
    fits = [cls(k=5, max_iter=4, learning_rate=0.05, batch_size=128, seed=9,
                verbose=verbose).fit(train) for verbose in (False, True)]
    for name in ("u_factors", "i_factors", "i_biases"):
        np.testing.assert_array_equal(getattr(fits[0], name), getattr(fits[1], name))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and lines[-1] == "Optimization finished!"
    for e, line in enumerate(lines[:4], 1):
        assert re.fullmatch(rf"Epoch {e}/4, correct: \d+\.\d\d%, skipped: \d+\.\d\d%", line)


def test_fit_trains_and_keeps_unknown_entities():
    train = Dataset.from_uir(_uir(), seed=1)
    model = BPR(k=5, max_iter=3, learning_rate=0.05, batch_size=100, seed=2)
    init = BPR(k=5, seed=2, trainable=False).fit(train)
    model.fit(train)
    assert model.u_factors.shape == init.u_factors.shape
    assert model.u_factors.dtype == np.float32 and model.i_biases.dtype == np.float32
    assert not np.array_equal(model.i_factors, init.i_factors)
    assert np.isfinite(model.score_batch(np.arange(5))).all()


@pytest.mark.parametrize("use_bias", [True, False])
def test_fit_leaves_init_params_untouched(use_bias):
    # the trainers update their tables in place: on the CPU a table that
    # shared memory with the caller's array would change it
    train = Dataset.from_uir(_uir(), seed=1)
    rng = np.random.RandomState(0)
    init = {"U": rng.rand(train.num_users, 4).astype(np.float32),
            "V": rng.rand(train.num_items, 4).astype(np.float32),
            "Bi": rng.rand(train.num_items).astype(np.float32)}
    before = {name: a.copy() for name, a in init.items()}
    model = BPR(k=4, max_iter=2, learning_rate=0.1, use_bias=use_bias, init_params=init,
                seed=1).fit(train)
    for name, a in init.items():
        np.testing.assert_array_equal(a, before[name])
    assert not np.array_equal(model.u_factors, before["U"])


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A8"):
        BPR(mesh=object())
    with pytest.raises(NotImplementedError, match="A8"):
        MMMF(mesh=object())


def test_chip_smoke_generator_is_bench_generator():
    assert (inspect.getsource(_load("chip_smoke").make_ml100k_like)
            == inspect.getsource(_load("bench").make_ml100k_like))


@pytest.fixture(scope="module")
def bench_splits():
    data = _load("bench").make_ml100k_like()
    kw = dict(test_size=0.2, rating_threshold=4.0, seed=123, verbose=False)
    return RatioSplit(data=data, **kw), JRatioSplit(data=data, **kw)


@pytest.fixture(scope="module")
def jax_bench_quality(bench_splits):
    split = bench_splits[1]
    model = JBPR(k=10, max_iter=30, learning_rate=0.001, lambda_reg=0.01, seed=123,
                 batch_size=4096).fit(split.train_set)
    avg, _ = j_ranking_eval(model, [JAUC(), JNDCG(k=10)], split.train_set, split.test_set,
                            rating_threshold=4.0, exclude_unknowns=True)
    return avg


@pytest.mark.parametrize("sampling", ["bulk", "per_minibatch"])
def test_bench_shape_quality_matches_jax(monkeypatch, bench_splits, jax_bench_quality, sampling):
    if sampling == "per_minibatch":
        monkeypatch.setattr(bpr_mod, "_BULK_SAMPLING_MAX", 1)
    split = bench_splits[0]
    model = BPR(k=10, max_iter=30, learning_rate=0.001, lambda_reg=0.01, seed=123,
                batch_size=4096).fit(split.train_set)
    (auc, ndcg), _ = ranking_eval(model, [AUC(), NDCG(k=10)], split.train_set, split.test_set,
                                  rating_threshold=4.0, exclude_unknowns=True)
    j_auc, j_ndcg = jax_bench_quality
    assert auc > 0.9 and j_auc > 0.9
    assert abs(auc - j_auc) <= 1e-3, (auc, j_auc)
    assert abs(ndcg - j_ndcg) <= 0.01, (ndcg, j_ndcg)
