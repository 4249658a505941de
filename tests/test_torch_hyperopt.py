"""The port's hyperparameter search and runtime configuration against the
JAX package's, on the CPU.

- ``GridSearch`` and ``RandomSearch`` over ItemKNN (star ratings, no
  weighting: its scores are the JAX package's, ROADMAP.md C): the same
  trial points in the same order, per-trial validation scores within
  1e-6 (float32 metric programs), the same ``best_params``, and the
  wrapper scoring as its best model does; both inside an ``Experiment``.
- The search domains: ``Discrete.grid_points``/``draw`` and
  ``Continuous.draw`` give the JAX package's values from one seeded stream;
  ``GridSearch`` refuses a ``Continuous`` domain with the same message.
- ``RuntimeConfig``: every field, the ones that take effect (platform,
  matmul precision, the device-metrics threshold) and each one that raises
  (the multi-device fields and ``make_mesh``, naming ROADMAP.md A8; the
  compilation cache, which has no counterpart).
"""

import numpy as np
import pytest
import torch

import cornac_tpu_torch
from cornac_tpu.eval_methods import RatioSplit as JRatioSplit
from cornac_tpu.experiment import Experiment as JExperiment
from cornac_tpu.hyperopt import (
    Continuous as JContinuous,
    Discrete as JDiscrete,
    GridSearch as JGridSearch,
    RandomSearch as JRandomSearch,
)
from cornac_tpu.metrics import NDCG as JNDCG, RMSE as JRMSE
from cornac_tpu.models import ItemKNN as JItemKNN
from cornac_tpu_torch import Experiment, RuntimeConfig
from cornac_tpu_torch.eval_methods import RatioSplit
from cornac_tpu_torch.hyperopt import Continuous, Discrete, GridSearch, RandomSearch
from cornac_tpu_torch.metrics import NDCG, RMSE
from cornac_tpu_torch.metrics import ranking
from cornac_tpu_torch.models import ItemKNN

cornac_tpu_torch.set_default_device("cpu")


def _stars(seed=4, n_users=70, n_items=50, n=1600):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs]


def _splits():
    kw = dict(test_size=0.2, val_size=0.2, rating_threshold=3.0, seed=123, verbose=False)
    data = _stars()
    return RatioSplit(data, **kw), JRatioSplit(data, **kw)


@pytest.mark.parametrize("metric", ["NDCG@10", "RMSE"])
def test_grid_search_matches_jax(metric):
    ours, theirs = _splits()
    pm, jm = ((NDCG(k=10), JNDCG(k=10)) if metric == "NDCG@10" else (RMSE(), JRMSE()))
    space = lambda D: [D("k", [10, 2, 5]), D("amplify", [1.0, 2.0])]  # noqa: E731
    psearch = GridSearch(ItemKNN(verbose=False, seed=1), space(Discrete), pm, ours)
    jsearch = JGridSearch(JItemKNN(verbose=False, seed=1), space(JDiscrete), jm, theirs)
    assert psearch.trial_points() == jsearch.trial_points()
    psearch.fit(ours.train_set, ours.val_set)
    jsearch.fit(theirs.train_set, theirs.val_set)
    assert [p for p, _ in psearch.trial_results] == [p for p, _ in jsearch.trial_results]
    np.testing.assert_allclose([s for _, s in psearch.trial_results],
                               [s for _, s in jsearch.trial_results], rtol=1e-6, atol=1e-7)
    assert psearch.best_params == jsearch.best_params
    users = np.arange(5)
    np.testing.assert_array_equal(psearch.score_batch(users),
                                  psearch.best_model.score_batch(users))


def test_random_search_matches_jax():
    ours, theirs = _splits()
    pspace = [Discrete("k", [2, 5, 10, 20]), Continuous("amplify", 0.5, 3.0)]
    jspace = [JDiscrete("k", [2, 5, 10, 20]), JContinuous("amplify", 0.5, 3.0)]
    psearch = RandomSearch(ItemKNN(verbose=False, seed=9), pspace, NDCG(k=10), ours, n_trails=4)
    jsearch = JRandomSearch(JItemKNN(verbose=False, seed=9), jspace, JNDCG(k=10), theirs,
                            n_trails=4)
    assert psearch.trial_points() == jsearch.trial_points()
    psearch.fit(ours.train_set, ours.val_set)
    jsearch.fit(theirs.train_set, theirs.val_set)
    assert [p for p, _ in psearch.trial_results] == [p for p, _ in jsearch.trial_results]
    np.testing.assert_allclose([s for _, s in psearch.trial_results],
                               [s for _, s in jsearch.trial_results], rtol=1e-6, atol=1e-7)
    assert psearch.best_params == jsearch.best_params


def test_search_in_an_experiment(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the experiments' logs
    ours, theirs = _splits()
    pexp = Experiment(ours, [GridSearch(ItemKNN(verbose=False), [Discrete("k", [3, 8])],
                                        NDCG(k=10), ours)], [NDCG(k=10)])
    jexp = JExperiment(theirs, [JGridSearch(JItemKNN(verbose=False), [JDiscrete("k", [3, 8])],
                                            JNDCG(k=10), theirs)], [JNDCG(k=10)])
    pexp.run()
    jexp.run()
    assert pexp.result[0].model_name == jexp.result[0].model_name == "GridSearch_ItemKNN"
    assert pexp.models[0].best_params == jexp.models[0].best_params
    assert pexp.result[0].metric_avg_results["NDCG@10"] == pytest.approx(
        jexp.result[0].metric_avg_results["NDCG@10"], rel=1e-6)


def test_search_domains_and_refusals():
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    d, jd = Discrete("a", [3, 1, 2]), JDiscrete("a", [3, 1, 2])
    c, jc = Continuous("b", -1.0, 4.0), JContinuous("b", -1.0, 4.0)
    assert d.grid_points() == jd.grid_points() == [1, 2, 3]
    assert [(d.draw(rng), c.draw(rng)) for _ in range(6)] == \
        [(jd.draw(jrng), jc.draw(jrng)) for _ in range(6)]
    ours, theirs = _splits()
    with pytest.raises(ValueError) as p_err:
        GridSearch(ItemKNN(), [c], NDCG(k=10), ours)
    with pytest.raises(ValueError) as j_err:
        JGridSearch(JItemKNN(), [jc], JNDCG(k=10), theirs)
    assert str(p_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="validation set"):
        GridSearch(ItemKNN(), [d], NDCG(k=10), ours).fit(ours.train_set, None)


# ------------------------------------------------------------ RuntimeConfig


@pytest.fixture
def restore_runtime():
    precision = torch.get_float32_matmul_precision()
    cells = ranking._DEVICE_MIN_CELLS
    yield
    torch.set_float32_matmul_precision(precision)
    ranking.set_device_metrics_min_cells(cells)
    cornac_tpu_torch.set_default_device("cpu")


@pytest.mark.parametrize("given, torch_precision", [
    ("highest", "highest"), ("float32", "highest"), ("bfloat16", "medium")])
def test_runtime_config_matmul_precision(restore_runtime, given, torch_precision):
    RuntimeConfig(matmul_precision=given).apply()
    assert torch.get_float32_matmul_precision() == torch_precision


def test_runtime_config_applies_its_fields(restore_runtime):
    cfg = RuntimeConfig(platform="cpu", device_metrics_min_cells=1234)
    assert cfg.apply() is cfg
    assert cornac_tpu_torch.default_device() == torch.device("cpu")
    assert ranking._DEVICE_MIN_CELLS == 1234
    RuntimeConfig(platform="gpu")  # accepted; applying it needs a card
    if not torch.cuda.is_available():
        RuntimeConfig(platform="cuda").apply()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cornac_tpu_torch.default_device()


@pytest.mark.parametrize("field, value", [
    ("data_parallel", 4), ("host_device_count", 8), ("coordinator_address", "host:1234"),
    ("num_processes", 2), ("process_id", 0)])
def test_runtime_config_multi_device_fields_raise(restore_runtime, field, value):
    with pytest.raises(NotImplementedError, match="A8"):
        RuntimeConfig(**{field: value}).apply()
    with pytest.raises(NotImplementedError, match="A8"):
        RuntimeConfig().make_mesh()


def test_runtime_config_refusals(restore_runtime, tmp_path):
    with pytest.raises(NotImplementedError, match="no counterpart"):
        RuntimeConfig(compilation_cache_dir=str(tmp_path)).apply()
    with pytest.raises(ValueError, match="highest/float32/bfloat16"):
        RuntimeConfig(matmul_precision="tf32").apply()
    with pytest.raises(ValueError, match="platform"):
        RuntimeConfig(platform="tpu").apply()
    # a refused config changes nothing
    before = torch.get_float32_matmul_precision()
    with pytest.raises(NotImplementedError):
        RuntimeConfig(matmul_precision="bfloat16", data_parallel=2).apply()
    assert torch.get_float32_matmul_precision() == before
