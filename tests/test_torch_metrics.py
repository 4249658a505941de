"""The port's metrics against the JAX package's on the same score matrices:
the fused device program (plain PyTorch on the CPU here, XLA in JAX), the
device rank/tie counts, and the host metric paths. Scores are rounded so
that ties are common, and positive slots are padded, the two cases where
the count-based formulas can go wrong."""

import numpy as np
import pytest

import cornac_tpu_torch
from cornac_tpu.metrics import ranking as jr
from cornac_tpu.metrics import rating as jrat
from cornac_tpu_torch.metrics import ranking as pr
from cornac_tpu_torch.metrics import rating as prat

cornac_tpu_torch.set_default_device("cpu")

METRICS = [
    ("NDCG", {"k": 10}), ("NDCG", {"k": -1}), ("NCRR", {"k": 5}), ("MRR", {}),
    ("HitRatio", {"k": 3}), ("Precision", {"k": 10}), ("Recall", {"k": 500}),
    ("FMeasure", {"k": 10}), ("AUC", {}), ("MAP", {}),
]


def _batch(seed=0, B=37, N=260):
    rng = np.random.RandomState(seed)
    scores = np.round(rng.randn(B, N), 1).astype(np.float32)  # many ties
    pos = rng.rand(B, N) < 0.04
    pos[np.arange(B), rng.randint(N, size=B)] = True  # every row has a positive
    pos[0, :] = False
    pos[0, :20] = True  # one heavy row: the others' slots are padded
    train = (rng.rand(B, N) < 0.1) & ~pos
    cand = pos | ~(pos | train)
    return scores, pos, cand


def _metrics(module):
    return [getattr(module, name)(**kw) for name, kw in METRICS]


def test_fused_program_matches_jax():
    scores, pos, cand = _batch()
    specs_p = pr.metric_device_specs(_metrics(pr))
    specs_j = jr.metric_device_specs(_metrics(jr))
    assert specs_p == specs_j and specs_p is not None
    got = pr.batch_eval_device(scores, pos, cand, specs_p)
    want = jr.batch_eval_device(scores, pos, cand, specs_j)
    assert got.shape == want.shape == (scores.shape[0], len(METRICS))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_device_rank_and_ties_match_jax():
    scores, pos, cand = _batch(seed=1)
    for got, want in zip(pr._device_rank_and_ties(scores, pos, cand),
                         jr._device_rank_and_ties(scores, pos, cand)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("device_path", [False, True])
def test_host_context_matches_jax(device_path, monkeypatch):
    scores, pos, cand = _batch(seed=2)
    masked = np.where(cand, scores.astype(np.float64), -np.inf)
    # a zero threshold sends the port's rank/tie counts to the device path
    monkeypatch.setattr(pr, "_DEVICE_MIN_CELLS", 0 if device_path else 10**12)
    ctx_p = pr.RankingContext(masked, pos, cand)
    ctx_j = jr.RankingContext(masked, pos, cand)
    for mp, mj in zip(_metrics(pr), _metrics(jr)):
        np.testing.assert_allclose(mp.batch_compute(ctx_p), mj.batch_compute(ctx_j), atol=1e-12)


def test_device_context_without_ties(monkeypatch):
    """A context built for metrics that read no tie counts ranks on the
    device in one call without them: the same values, and a read of the
    tie counts raises."""
    scores, pos, cand = _batch(seed=4)
    masked = np.where(cand, scores.astype(np.float64), -np.inf)
    monkeypatch.setattr(pr, "_DEVICE_MIN_CELLS", 0)
    ctx_p = pr.RankingContext(masked, pos, cand, ties=False)
    ctx_j = jr.RankingContext(masked, pos, cand)
    checked = 0
    for mp, mj in zip(_metrics(pr), _metrics(jr)):
        if mp.uses_ties:
            with pytest.raises(RuntimeError, match="ties=False"):
                mp.batch_compute(ctx_p)
            continue
        np.testing.assert_allclose(mp.batch_compute(ctx_p), mj.batch_compute(ctx_j), atol=1e-12)
        checked += 1
    assert checked >= 3 and ctx_p._tie_counts is None


def test_per_user_compute_matches_jax():
    rng = np.random.RandomState(3)
    items = np.arange(50)
    pd_scores = np.round(rng.randn(50), 1)
    gt_pos = rng.choice(50, 6, replace=False)
    pd_rank = items[np.argsort(-pd_scores, kind="stable")]
    kw = dict(gt_pos=gt_pos, pd_rank=pd_rank, pd_scores=pd_scores, item_indices=items)
    for mp, mj in zip(_metrics(pr), _metrics(jr)):
        assert mp.compute(**kw) == pytest.approx(mj.compute(**kw), abs=1e-12)


def test_rating_metrics_match_jax():
    rng = np.random.RandomState(4)
    gt, pd, w = rng.rand(200) * 5, rng.rand(200) * 5, rng.rand(200)
    for name in ("MAE", "MSE", "RMSE"):
        for weights in (None, w):
            assert getattr(prat, name)().compute(gt, pd, weights) == pytest.approx(
                getattr(jrat, name)().compute(gt, pd, weights), abs=1e-12
            )
