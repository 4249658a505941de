"""The port's split construction and ``Experiment`` against the JAX
package's, on the same inputs.

- ``RatioSplit``: for a seed, the train/val/test triples, their dtypes and
  the ID maps are byte-identical (the permutation comes from the same
  seeded ``RandomState``), including the ``test_size=0`` ``[-0:]`` quirk
  and fractional absolute sizes.
- ``Experiment.run()`` with the neighbourhood models on star ratings:
  every metric of the table within atol 1e-6, the ``Train (s)``/``Test
  (s)`` columns aside, with k=1. There the similarities are exact and each
  score is one vote, so both packages compute the same float32 numbers.
  With k > 1 the packages sum the k votes in different float32 orders
  (XLA's order even changes with k): two scores equal in exact arithmetic
  then tie in one package and sit one ulp apart in the other, and AUC,
  which counts a tie as half, moves by up to ~1e-3 (ROADMAP.md C).
  ``test_experiment_with_k_votes`` bounds that case.
"""

import glob
import os
import warnings

import numpy as np
import pytest

import cornac_tpu_torch
from cornac_tpu.data import Reader as JReader
from cornac_tpu.eval_methods import BaseMethod as JBaseMethod, RatioSplit as JRatioSplit
from cornac_tpu.experiment import Experiment as JExperiment
from cornac_tpu.metrics import AUC as JAUC, NDCG as JNDCG, RMSE as JRMSE, Recall as JRecall
from cornac_tpu.models import ItemKNN as JItemKNN, UserKNN as JUserKNN
from cornac_tpu_torch import Experiment
from cornac_tpu_torch.data import Reader
from cornac_tpu_torch.eval_methods import BaseMethod, RatioSplit
from cornac_tpu_torch.metrics import AUC, NDCG, RMSE, Recall
from cornac_tpu_torch.models import ItemKNN, Recommender, UserKNN

cornac_tpu_torch.set_default_device("cpu")

RATING_TXT = os.path.join(os.path.dirname(__file__), "data", "rating.txt")
TIMES = ("Train (s)", "Test (s)", "Time (s)")


def _assert_same_splits(ours, theirs):
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
        assert (a.num_users, a.num_items, a.num_ratings) == (b.num_users, b.num_items, b.num_ratings)
        assert (a.min_rating, a.max_rating, a.global_mean) == (b.min_rating, b.max_rating, b.global_mean)
    assert (ours.train_size, ours.val_size, ours.test_size) == (
        theirs.train_size, theirs.val_size, theirs.test_size)
    assert (ours.total_users, ours.total_items) == (theirs.total_users, theirs.total_items)


@pytest.mark.parametrize("kw", [
    dict(test_size=0.25, val_size=0.1, rating_threshold=3.0, seed=42),
    dict(test_size=0, val_size=0.2, rating_threshold=1.0, seed=7),  # [-0:] quirk
    dict(test_size=2.7, val_size=0, rating_threshold=1.0, seed=7),  # fractional size
    dict(test_size=0.3, val_size=5, rating_threshold=3.0, seed=3, exclude_unknowns=False),
], ids=["fractions", "zero_test", "fractional_absolute", "keep_unknowns"])
def test_ratio_split_is_byte_identical(kw):
    ours = RatioSplit(data=Reader().read(RATING_TXT, fmt="UIR"), **kw)
    theirs = JRatioSplit(data=JReader().read(RATING_TXT, fmt="UIR"), **kw)
    _assert_same_splits(ours, theirs)


def test_ratio_split_rejects_bad_sizes():
    data = Reader().read(RATING_TXT, fmt="UIR")
    for kw in (dict(test_size=-0.1), dict(test_size=len(data)), dict(test_size=0.6, val_size=0.5)):
        with pytest.raises(ValueError):
            RatioSplit(data=data, **kw)
        with pytest.raises(ValueError):
            JRatioSplit(data=data, **kw)


def test_from_splits_matches_jax():
    data = Reader().read(RATING_TXT, fmt="UIR")
    kw = dict(rating_threshold=2.0, exclude_unknowns=True, seed=5)
    ours = BaseMethod.from_splits(data[:90], data[90:130], data[130:], **kw)
    theirs = JBaseMethod.from_splits(data[:90], data[90:130], data[130:], **kw)
    ours.train_size = ours.val_size = ours.test_size = theirs.train_size = None
    theirs.val_size = theirs.test_size = None
    _assert_same_splits(ours, theirs)
    with pytest.raises(ValueError):
        BaseMethod.from_splits([], data)


def test_dataset_views_match_jax():
    from cornac_tpu.data import Dataset as JDataset
    from cornac_tpu_torch.data import Dataset

    data = Reader().read(RATING_TXT, fmt="UIR")
    ours, theirs = Dataset.from_uir(data, seed=1), JDataset.from_uir(data, seed=1)
    for view in ("matrix", "csr_matrix", "csc_matrix", "dok_matrix"):
        a, b = getattr(ours, view), getattr(theirs, view)
        assert a.format == b.format and (a != b).nnz == 0, view
    assert getattr(ours, view) is a  # cached
    ours.add_modalities()
    assert all(getattr(ours, slot) is None for slot in Dataset._MODALITY_ATTRS)


def test_unported_options_raise():
    data = Reader().read(RATING_TXT, fmt="UIR")
    with pytest.raises(NotImplementedError, match="A8"):
        RatioSplit(data=data, mesh=object())
    # the modality slots and checkpointed Experiments are ported now: a
    # slot refuses anything but its modality class
    with pytest.raises(ValueError, match="item_text modality must be a TextModality"):
        RatioSplit(data=data, item_text=object())
    split = RatioSplit(data=data, seed=1)
    assert split.user_feature is None and split.train_set.review_text is None
    with pytest.raises(ValueError, match="user_graph"):
        split.add_modalities(user_graph=object())
    assert Experiment(split, [], [], checkpoint_dir="ckpt").models == []


def _data(seed=11, n_users=80, n_items=60, n=1500):
    rng = np.random.RandomState(seed)
    pairs = {(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)}
    return [(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in sorted(pairs)]


def _run(pkg, data, val_size, k=1, save_dir=None):
    if pkg == "jax":
        split_cls, models, metrics, exp_cls = (
            JRatioSplit, [JItemKNN(k=k, verbose=False), JUserKNN(k=k, verbose=False)],
            [JRMSE(), JRecall(k=10), JNDCG(k=10), JAUC()], JExperiment)
    else:
        split_cls, models, metrics, exp_cls = (
            RatioSplit, [ItemKNN(k=k, verbose=False), UserKNN(k=k, verbose=False)],
            [RMSE(), Recall(k=10), NDCG(k=10), AUC()], Experiment)
    split = split_cls(data=data, test_size=0.2, val_size=val_size, rating_threshold=4.0,
                      exclude_unknowns=True, seed=123)
    exp = exp_cls(split, models, metrics, save_dir=save_dir)
    exp.run()
    return exp


def _values(results):
    return [(r.model_name, {k: v for k, v in r.metric_avg_results.items() if k not in TIMES})
            for r in results]


@pytest.mark.parametrize("val_size", [0.0, 0.1])
def test_experiment_table_matches_jax(val_size, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the log file goes to the working directory
    data = _data()
    ours, theirs = _run("torch", data, val_size), _run("jax", data, val_size)
    for got, want in ((ours.result, theirs.result), (ours.val_result, theirs.val_result)):
        if want is None:
            assert got is None
            continue
        for (name, g), (j_name, w) in zip(_values(got), _values(want)):
            assert name == j_name and list(g) == list(w)
            np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=0, atol=1e-6)
        # the rendered tables agree too, once the time columns are dropped
        for res in list(got) + list(want):
            for key in TIMES:
                res.metric_avg_results.pop(key, None)
        assert str(got) == str(want)
    assert len(glob.glob(str(tmp_path / "CornacExp-*.log"))) == 2


def test_experiment_with_k_votes(tmp_path, monkeypatch):
    # k=5: the same splits and RMSE within 1e-6 (no ranking involved); the
    # ranking metrics within the tie flips described above
    monkeypatch.chdir(tmp_path)
    data = _data()
    ours, theirs = _run("torch", data, 0.1, k=5), _run("jax", data, 0.1, k=5)
    _assert_same_splits(ours.eval_method, theirs.eval_method)
    for results in ((ours.result, theirs.result), (ours.val_result, theirs.val_result)):
        for (_, g), (_, w) in zip(*map(_values, results)):
            for name in g:
                tol = 1e-6 if name == "RMSE" else 5e-3
                assert abs(g[name] - w[name]) <= tol, (name, g[name], w[name])


def test_experiment_saves_models_and_log(tmp_path):
    data = _data(n=600)
    exp = _run("torch", data, 0.0, k=5, save_dir=str(tmp_path))
    logs = glob.glob(str(tmp_path / "CornacExp-*.log"))
    assert len(logs) == 1 and "TEST:" in open(logs[0]).read()
    for model in exp.models:
        loaded = Recommender.load(str(tmp_path / model.name))
        users = np.arange(5)
        np.testing.assert_array_equal(loaded.score_batch(users), model.score_batch(users))


def test_experiment_filters_and_verbose(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        split = RatioSplit(data=_data(n=400), test_size=0.2, seed=1, verbose=True)
    exp = Experiment(split, [ItemKNN(k=3, verbose=False), "not a model"],
                     [Recall(k=5), 42], verbose=True)
    assert len(exp.models) == 1 and len(exp.metrics) == 1
    exp.run()
    out = capsys.readouterr().out
    assert "Training data:" in out and "[ItemKNN] Training started!" in out and "TEST:" in out
    with pytest.raises(ValueError):
        Experiment(split, 3, [])
