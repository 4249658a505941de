"""Evaluation engine: ``rating_eval``, ``ranking_eval`` and the two
``BaseMethod`` entry points the server calls.

Port of ``cornac_tpu/eval_methods/base_method.py`` with the same masking
semantics (global-ID prefix ordering, exclude_unknowns truncation,
rating_threshold binarization, per-user averaging). Ranking evaluation
scores batches of users: a model with a device batch scorer hands a (B, N)
tensor on the card to the fused metric program
(``metrics.ranking.batch_eval_device``), others go through the host
``RankingContext``. Split construction, modalities and the multi-device
``mesh`` branch come with the eval-methods slice.
"""

from collections import OrderedDict

import numpy as np

from ..experiment.result import Result
from ..metrics import RankingContext, RankingMetric, RatingMetric
from ..metrics.ranking import (
    _EVAL_CELL_BUDGET,
    _FUSED_MAX_ITEMS,
    batch_eval_device,
    metric_device_specs,
)


def _csr_row_masks(mat, users, n_items, threshold):
    """(B, n_items) boolean mask of items whose rating >= threshold, built
    from CSR structure without per-entry Python loops. Users outside the
    matrix's row range contribute empty rows."""
    B = len(users)
    mask = np.zeros((B, n_items), dtype=bool)
    users = np.asarray(users)
    in_range = users < mat.shape[0]
    if not in_range.any():
        return mask
    rows = np.flatnonzero(in_range)
    u = users[rows]
    starts, ends = mat.indptr[u], mat.indptr[u + 1]
    degrees = ends - starts
    if degrees.sum() == 0:
        return mask
    col_idx = np.concatenate([mat.indices[s:e] for s, e in zip(starts, ends)])
    vals = np.concatenate([mat.data[s:e] for s, e in zip(starts, ends)])
    row_idx = np.repeat(rows, degrees)
    keep = (vals >= threshold) & (col_idx < n_items)
    mask[row_idx[keep], col_idx[keep]] = True
    return mask


def rating_eval(model, metrics, test_set, user_based=False, verbose=False):
    """Evaluate rating metrics over the test triplets, with predictions for
    all test pairs from one vectorized ``model.rate_batch`` call."""
    if not metrics:
        return [], []

    (u_indices, i_indices, r_values) = test_set.uir_tuple
    r_preds = np.asarray(model.rate_batch(u_indices, i_indices), dtype="float")

    groups = None
    if user_based:
        # one stable sort shared by every metric: slices of `order` are
        # each user's test positions
        order = np.argsort(u_indices, kind="stable")
        sorted_u = u_indices[order]
        cuts = np.flatnonzero(np.diff(sorted_u)) + 1
        groups = [
            (int(sorted_u[s]), order[s:e])
            for s, e in zip(
                np.concatenate(([0], cuts)),
                np.concatenate((cuts, [len(sorted_u)])),
            )
        ]

    avg_results, user_results = [], []
    for mt in metrics:
        if groups is None:
            user_results.append({})
            avg_results.append(mt.compute(gt_ratings=r_values, pd_ratings=r_preds))
            continue
        by_user = {
            uid: mt.compute(gt_ratings=r_values[idx], pd_ratings=r_preds[idx]).item()
            for uid, idx in groups
        }
        user_results.append(by_user)
        avg_results.append(sum(by_user.values()) / len(by_user))

    return avg_results, user_results


def ranking_eval(
    model,
    metrics,
    train_set,
    test_set,
    val_set=None,
    rating_threshold=1.0,
    exclude_unknowns=True,
    verbose=False,
    user_batch_size=1024,
):
    """Evaluate ranking metrics with batched device scoring.

    Positives are test items with rating >= threshold; negatives are all
    items minus train/val/test positives; candidates are their union; with
    ``exclude_unknowns`` the item space is truncated to train items.
    """
    if len(metrics) == 0:
        return [], []

    avg_results = []
    user_results = [{} for _ in enumerate(metrics)]

    test_mat = test_set.csr_matrix
    train_mat = train_set.csr_matrix
    val_mat = None if val_set is None else val_set.csr_matrix

    n_items = train_set.num_items if exclude_unknowns else test_set.num_items

    test_users = np.unique(test_set.uir_tuple[0])

    fused_specs = (
        metric_device_specs(metrics) if n_items <= _FUSED_MAX_ITEMS else None
    )
    # keep B*N bounded: masks and the score block are dense in B x N
    user_batch_size = max(1, min(user_batch_size, _EVAL_CELL_BUDGET // n_items))

    for start in range(0, len(test_users), user_batch_size):
        batch_users = test_users[start : start + user_batch_size]

        pos_mask = _csr_row_masks(test_mat, batch_users, n_items, rating_threshold)
        has_pos = pos_mask.any(axis=1)
        # skip users with an empty positive set
        if not has_pos.any():
            continue
        batch_users = batch_users[has_pos]
        pos_mask = pos_mask[has_pos]

        train_pos = _csr_row_masks(train_mat, batch_users, n_items, rating_threshold)
        val_pos = (
            _csr_row_masks(val_mat, batch_users, n_items, rating_threshold)
            if val_mat is not None
            else np.zeros_like(pos_mask)
        )
        # negatives: everything except any positive (train/val/test)
        neg_mask = ~(pos_mask | train_pos | val_pos)
        cand_mask = pos_mask | neg_mask

        values_mat = None
        if fused_specs is not None:
            # getattr: eval accepts duck-typed models that may not expose
            # the device-scorer hook
            score_dev_fn = getattr(model, "score_batch_device", None)
            scores_dev = None if score_dev_fn is None else score_dev_fn(batch_users)
            if scores_dev is not None and scores_dev.shape[1] >= n_items:
                values_mat = batch_eval_device(
                    scores_dev[:, :n_items], pos_mask, cand_mask, fused_specs
                )
        if values_mat is not None:
            for i, _ in enumerate(metrics):
                user_results[i].update(
                    {int(u): float(v) for u, v in zip(batch_users, values_mat[:, i])}
                )
        else:
            scores = np.asarray(model.score_batch(batch_users), dtype=np.float64)
            scores = scores[:, :n_items]
            scores = np.where(cand_mask, scores, -np.inf)

            ctx = RankingContext(scores, pos_mask, cand_mask)
            for i, mt in enumerate(metrics):
                values = mt.batch_compute(ctx)
                user_results[i].update(
                    {int(u): float(v) for u, v in zip(batch_users, values)}
                )

    for i, mt in enumerate(metrics):
        if len(user_results[i]) == 0:
            avg_results.append(float("nan"))
        else:
            avg_results.append(sum(user_results[i].values()) / len(user_results[i]))

    return avg_results, user_results


class BaseMethod:
    """Evaluation protocol. This slice ports its two static entry points,
    ``organize_metrics`` and ``eval``, which the server calls on a model and
    its train set; building splits comes with the eval-methods slice."""

    @staticmethod
    def organize_metrics(metrics):
        """Split metrics into (rating, ranking) lists; expand list-valued k."""
        if isinstance(metrics, dict):
            rating_metrics = metrics.get("rating", [])
            ranking_metrics = metrics.get("ranking", [])
        elif isinstance(metrics, list):
            rating_metrics = []
            ranking_metrics = []
            for mt in metrics:
                if isinstance(mt, RatingMetric):
                    rating_metrics.append(mt)
                elif isinstance(mt, RankingMetric) and hasattr(mt.k, "__len__"):
                    ranking_metrics.extend(
                        [mt.__class__(k=_k) for _k in sorted(set(mt.k))]
                    )
                else:
                    ranking_metrics.append(mt)
        else:
            raise ValueError("metrics must be a list (or a dict of metric lists)")

        rating_metrics = sorted(rating_metrics, key=lambda mt: mt.name)
        ranking_metrics = sorted(ranking_metrics, key=lambda mt: mt.name)
        return rating_metrics, ranking_metrics

    @staticmethod
    def eval(
        model,
        train_set,
        test_set,
        val_set,
        rating_threshold,
        exclude_unknowns,
        user_based,
        rating_metrics,
        ranking_metrics,
        verbose,
    ):
        """Run rating + ranking evaluation and collect a :class:`Result`."""
        rat_avg, rat_user = rating_eval(
            model=model,
            metrics=rating_metrics,
            test_set=test_set,
            user_based=user_based,
            verbose=verbose,
        )
        rank_avg, rank_user = ranking_eval(
            model=model,
            metrics=ranking_metrics,
            train_set=train_set,
            test_set=test_set,
            val_set=val_set,
            rating_threshold=rating_threshold,
            exclude_unknowns=exclude_unknowns,
            verbose=verbose,
        )
        names = [mt.name for mt in rating_metrics + ranking_metrics]
        return Result(
            model.name,
            OrderedDict(zip(names, rat_avg + rank_avg)),
            OrderedDict(zip(names, rat_user + rank_user)),
        )
