"""The port's evaluation protocols against the JAX package's, on the CPU.

- ``StratifiedSplit`` (by user and by item, shuffled and chronological),
  ``TimestampSplit`` (ratio and cutoff modes), ``CrossValidation``'s folds
  and ``PropensityStratifiedEvaluation``'s split and strata: for a seed,
  the triples and ID maps of every set are byte-identical, and each
  splitter refuses what the JAX one refuses.
- ``fit_discrete_powerlaw``: equal output (alpha, xmin), bit for bit.
- The IPS metrics of PSE on MostPop (integer scores, so both packages rank
  the same) within float64 tolerance (rtol 1e-12), and the whole
  propensity-stratified table the same text.
- ``CVResult``, ``PSTResult`` and ``CVExperimentResult`` built from the
  same results render the same text; a cross-validated ``Experiment``
  gives the JAX package's per-fold metrics on MostPop within rtol 1e-6
  (both packages' fused metric programs sum in float32, in other orders).
"""

from collections import OrderedDict

import numpy as np
import pytest

import cornac_tpu_torch
from cornac_tpu.eval_methods import (
    CrossValidation as JCrossValidation,
    PropensityStratifiedEvaluation as JPSE,
    StratifiedSplit as JStratifiedSplit,
    TimestampSplit as JTimestampSplit,
)
from cornac_tpu.eval_methods.propensity_stratified_evaluation import (
    fit_discrete_powerlaw as j_fit_discrete_powerlaw,
)
from cornac_tpu.experiment import Experiment as JExperiment
from cornac_tpu.experiment.result import (
    CVExperimentResult as JCVExperimentResult,
    CVResult as JCVResult,
    PSTResult as JPSTResult,
    Result as JResult,
)
from cornac_tpu.metrics import AUC as JAUC, MAE as JMAE, NDCG as JNDCG, Recall as JRecall
from cornac_tpu.models import MostPop as JMostPop
from cornac_tpu_torch import Experiment
from cornac_tpu_torch.eval_methods import (
    CrossValidation,
    PropensityStratifiedEvaluation,
    StratifiedSplit,
    TimestampSplit,
)
from cornac_tpu_torch.eval_methods.propensity_stratified_evaluation import (
    fit_discrete_powerlaw,
)
from cornac_tpu_torch.experiment.result import (
    CVExperimentResult,
    CVResult,
    PSTResult,
    Result,
)
from cornac_tpu_torch.metrics import AUC, MAE, NDCG, Recall
from cornac_tpu_torch.models import MostPop

cornac_tpu_torch.set_default_device("cpu")


def _uirt(seed=3, n_users=60, n_items=50, n=1500):
    """Seeded (user, item, rating, timestamp) quadruples: popularity skew
    and tied timestamps."""
    rng = np.random.RandomState(seed)
    pop = np.arange(1, n_items + 1) ** -0.7
    pairs = sorted({(rng.randint(n_users), int(rng.choice(n_items, p=pop / pop.sum())))
                    for _ in range(n)})
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6)), int(rng.randint(1000, 1400)))
            for u, i in pairs]


def _same_sets(ours, theirs):
    for split in ("train_set", "test_set", "val_set"):
        a, b = getattr(ours, split), getattr(theirs, split)
        assert (a is None) == (b is None), split
        if a is None:
            continue
        for x, y in zip(a.uir_tuple, b.uir_tuple):
            assert x.dtype == y.dtype, split
            np.testing.assert_array_equal(x, y, err_msg=split)
        assert list(a.uid_map.items()) == list(b.uid_map.items())
        assert list(a.iid_map.items()) == list(b.iid_map.items())
    assert (ours.total_users, ours.total_items) == (theirs.total_users, theirs.total_items)


# ------------------------------------------------------------- the splitters


@pytest.mark.parametrize("group_by", ["user", "item"])
@pytest.mark.parametrize("chrono", [False, True])
@pytest.mark.parametrize("val_size", [0.0, 0.1])
def test_stratified_split_is_byte_identical(group_by, chrono, val_size):
    data = _uirt()
    kw = dict(group_by=group_by, chrono=chrono, test_size=0.2, val_size=val_size, seed=11,
              exclude_unknowns=True)
    _same_sets(StratifiedSplit(data, **kw), JStratifiedSplit(data, **kw))


def test_stratified_split_refuses_as_jax():
    data = _uirt()
    for kw in (dict(group_by="session"), dict(chrono=True, fmt="UIR")):
        with pytest.raises(ValueError) as ours:
            StratifiedSplit([row[:3] for row in data] if kw.get("fmt") else data, **kw)
        with pytest.raises(ValueError) as theirs:
            JStratifiedSplit([row[:3] for row in data] if kw.get("fmt") else data, **kw)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("kw", [
    dict(test_size=0.2),
    dict(test_size=0.2, val_size=0.1),
    dict(test_size=300, val_size=100),
    dict(val_timestamp=1250, test_timestamp=1330),
])
def test_timestamp_split_is_byte_identical(kw):
    data = _uirt()
    ours, theirs = TimestampSplit(data, seed=2, **kw), JTimestampSplit(data, seed=2, **kw)
    _same_sets(ours, theirs)
    assert (ours.val_timestamp, ours.test_timestamp) == (theirs.val_timestamp,
                                                         theirs.test_timestamp)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(test_size=0.2, val_timestamp=1100),
    dict(val_timestamp=1300, test_timestamp=1200),
    dict(val_timestamp=1300),
    dict(val_timestamp=900, test_timestamp=1000),
    dict(val_timestamp=1100, test_timestamp=1500),
])
def test_timestamp_split_refuses_as_jax(kw):
    data = _uirt()
    with pytest.raises(ValueError) as ours:
        TimestampSplit(data, **kw)
    with pytest.raises(ValueError) as theirs:
        JTimestampSplit(data, **kw)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("n_folds", [3, 5])
def test_cross_validation_folds_are_byte_identical(n_folds):
    data = [row[:3] for row in _uirt(n=1503)]  # 1,503 ratings: a remainder for n_folds = 5
    ours, theirs = CrossValidation(data, n_folds=n_folds, seed=123), \
        JCrossValidation(data, n_folds=n_folds, seed=123)
    np.testing.assert_array_equal(ours._partition, theirs._partition)
    for fold in range(n_folds):
        ours._build_fold(fold)
        theirs._build_fold(fold)
        _same_sets(ours, theirs)


def test_cross_validation_partition_checks():
    data = [row[:3] for row in _uirt()]
    for partition in (np.zeros(5, int), np.zeros(len(data), int)):
        with pytest.raises(ValueError) as ours:
            CrossValidation(data, n_folds=3, partition=partition)
        with pytest.raises(ValueError) as theirs:
            JCrossValidation(data, n_folds=3, partition=partition)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------ propensities


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_discrete_powerlaw_equal(seed):
    rng = np.random.RandomState(seed)
    counts = rng.zipf(1.8, size=500 if seed else 50).astype(np.float64)
    assert fit_discrete_powerlaw(counts) == j_fit_discrete_powerlaw(counts)
    grid = [1.0, 2.0, 5.0]
    assert fit_discrete_powerlaw(counts, grid) == j_fit_discrete_powerlaw(counts, grid)


def _pse_pair(n_strata=3, val_size=0.1):
    data = [row[:3] for row in _uirt(seed=9, n=2500)]
    kw = dict(test_size=0.2, val_size=val_size, n_strata=n_strata, rating_threshold=3.0, seed=5)
    return PropensityStratifiedEvaluation(data, **kw), JPSE(data, **kw)


@pytest.mark.parametrize("n_strata", [2, 3])
def test_pse_split_and_strata_are_byte_identical(n_strata):
    ours, theirs = _pse_pair(n_strata)
    _same_sets(ours, theirs)
    assert dict(ours.props) == dict(theirs.props)
    assert list(ours.stratified_sets) == list(theirs.stratified_sets)
    for name, q in ours.stratified_sets.items():
        for x, y in zip(q.uir_tuple, theirs.stratified_sets[name].uir_tuple):
            np.testing.assert_array_equal(x, y)


def test_pse_ips_metrics_agree():
    ours, theirs = _pse_pair()
    metrics = [AUC(), NDCG(k=10), Recall(k=5)]
    j_metrics = [JAUC(), JNDCG(k=10), JRecall(k=5)]
    pm, jm = MostPop().fit(ours.train_set), JMostPop().fit(theirs.train_set)
    got = ours._ips_ranking_eval(pm, metrics, ours.test_set, ours.val_set)
    want = theirs._ips_ranking_eval(jm, j_metrics, theirs.test_set, theirs.val_set)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    for g, w in zip(got[1], want[1]):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=1e-12)


def test_pse_experiment_table_is_the_same_text(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the experiments' logs
    ours, theirs = _pse_pair()
    pexp = Experiment(ours, [MostPop()], [MAE(), AUC(), NDCG(k=10), Recall(k=5)])
    jexp = JExperiment(theirs, [JMostPop()], [JMAE(), JAUC(), JNDCG(k=10), JRecall(k=5)])
    pexp.run()
    jexp.run()
    assert pexp.val_result is None and jexp.val_result is None
    assert str(pexp.result) == str(jexp.result)
    assert [r.metric_avg_results["SIZE"] for r in pexp.result[0]] == \
        [r.metric_avg_results["SIZE"] for r in jexp.result[0]]


def test_cross_validated_experiment_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the experiments' logs
    data = [row[:3] for row in _uirt()]
    pexp = Experiment(CrossValidation(data, n_folds=3, seed=7, rating_threshold=3.0),
                      [MostPop()], [MAE(), AUC(), Recall(k=5)], save_dir=str(tmp_path))
    jexp = JExperiment(JCrossValidation(data, n_folds=3, seed=7, rating_threshold=3.0),
                       [JMostPop()], [JMAE(), JAUC(), JRecall(k=5)])
    pexp.run()
    jexp.run()
    assert isinstance(pexp.result, CVExperimentResult) and pexp.val_result is None
    assert not (tmp_path / "MostPop").exists()  # fold-based runs save no model
    for p_fold, j_fold in zip(pexp.result[0], jexp.result[0]):
        for name in ("MAE", "AUC", "Recall@5"):
            assert p_fold.metric_avg_results[name] == pytest.approx(
                j_fold.metric_avg_results[name], rel=1e-6)
    for name in ("MAE", "AUC", "Recall@5"):
        assert pexp.result[0].metric_mean[name] == pytest.approx(
            jexp.result[0].metric_mean[name], rel=1e-6)


# ----------------------------------------------------------------- results


def _results(cls, names, rows):
    return [cls("M", OrderedDict(zip(names, row)), None) for row in rows]


def test_result_containers_render_the_same_text():
    rng = np.random.RandomState(0)
    names = ["MAE", "AUC", "NDCG@10"]
    rows = rng.rand(4, 3).tolist()
    ours, theirs = CVResult("M"), JCVResult("M")
    ours.extend(_results(Result, names, rows))
    theirs.extend(_results(JResult, names, rows))
    ours.organize()
    theirs.organize()
    assert str(ours) == str(theirs)
    assert ours.metric_mean == theirs.metric_mean and ours.metric_std == theirs.metric_std

    both = CVExperimentResult([ours, ours]), JCVExperimentResult([theirs, theirs])
    assert str(both[0]) == str(both[1])

    names = ["SIZE", "AUC", "Recall@5"]
    rows = [[400, 0.8, 0.3], [400, 0.7, 0.2], [150, 0.9, 0.4], [250, 0.6, 0.1]]
    pst, jpst = PSTResult("M"), JPSTResult("M")
    pst.extend(_results(Result, names, rows))
    jpst.extend(_results(JResult, names, rows))
    pst.organize()
    jpst.organize()
    assert str(pst) == str(jpst)
    assert pst[-1].metric_avg_results == jpst[-1].metric_avg_results
