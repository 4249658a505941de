"""Next-basket evaluation.

Port of ``cornac_tpu/eval_methods/next_basket_evaluation.py``: the
user-atomic ratio split over ``BasketDataset``s (the ``test_size=0``
quirk included), the leave-last-basket protocol, and the conventional,
repetition and exploration breakdowns. Test users are scored in chunks of
256 through ``NextBasketRecommender.score_baskets_batch``. Each chunk is
scored once and every breakdown reads that one score matrix, where the JAX
package scores the chunk again for each breakdown: the scorers are
deterministic, so the numbers are the same. The chunk's scores go to the
default device once, and the metrics that the fused program computes
(``metrics.ranking.batch_eval_device``: rank of each positive, ties to the
lower column) are computed there, comparing in float64 as the JAX
package's host ranking does; any other metric goes through
``RankingContext``.
"""

import time
from collections import OrderedDict

import numpy as np
import torch

from ..data import BasketDataset
from ..device import default_device
from ..experiment.result import Result
from ..metrics import RankingContext
from ..metrics.ranking import _FUSED_MAX_ITEMS, batch_eval_device, metric_device_specs
from ..models.recommender import NextBasketRecommender
from ..utils.common import safe_indexing
from .ratio_split import RatioSplit

# result-table breakdowns: every test basket / only repeated items /
# only first-seen items, keyed by the suffix they carry in the output
_BREAKDOWNS = ("conventional", "repetition", "exploration")
_SUFFIX = {"conventional": "", "repetition": "-rep", "exploration": "-expl"}


def _positives(kind, history, gt):
    """The ground-truth items a breakdown ranks: all of them, those seen in
    the history, or those not seen there."""
    if kind == "conventional":
        return gt
    seen = {item for basket in history for item in basket}
    if kind == "repetition":
        return [i for i in gt if i in seen]
    return [i for i in gt if i not in seen]


def ranking_eval(
    model,
    metrics,
    train_set,
    test_set,
    repetition_eval=False,
    exploration_eval=False,
    exclude_unknowns=True,
    verbose=False,
    batch_size=256,
):
    """Evaluate over test users' last baskets, given their earlier baskets.

    Returns ({breakdown: [average per metric]}, {breakdown: [{user: value}
    per metric]}); a breakdown that was not asked for keeps empty lists."""
    if len(metrics) == 0:
        return [], []

    kinds = ["conventional"]
    if repetition_eval:
        kinds.append("repetition")
    if exploration_eval:
        kinds.append("exploration")
    avg_results = {kind: [] for kind in _BREAKDOWNS}
    user_results = {kind: [{} for _ in metrics] for kind in _BREAKDOWNS}
    ties = any(mt.uses_ties for mt in metrics)

    n_items = train_set.num_items if exclude_unknowns else test_set.num_items
    specs = metric_device_specs(metrics) if n_items <= _FUSED_MAX_ITEMS else None

    # (user, history baskets, ground-truth basket) of every test user with
    # at least two baskets and a non-empty last one
    tasks = []
    for [user_idx], [_], [baskets] in test_set.ubi_iter(batch_size=1, shuffle=False):
        if len(baskets) < 2:
            continue
        history, gt = baskets[:-1], baskets[-1]
        if len(gt) == 0:
            continue
        tasks.append((int(user_idx), [list(b) for b in history], list(gt)))

    for start in range(0, len(tasks), batch_size):
        chunk = tasks[start : start + batch_size]
        scores = np.asarray(
            model.score_baskets_batch(np.asarray([t[0] for t in chunk]), [t[1] for t in chunk]),
            dtype=np.float64,
        )
        if scores.shape[1] < n_items:
            fill = scores.min(axis=1, keepdims=True)
            expanded = np.broadcast_to(fill, (scores.shape[0], n_items)).copy()
            expanded[:, : scores.shape[1]] = scores
            scores = expanded
        else:
            scores = scores[:, :n_items]

        scores_dev = None if specs is None else torch.as_tensor(scores, device=default_device())
        for kind in kinds:
            pos_mask = np.zeros((len(chunk), n_items), dtype=bool)
            for b, (_, history, gt) in enumerate(chunk):
                pos_mask[b, [i for i in _positives(kind, history, gt) if i < n_items]] = True
            keep = pos_mask.any(axis=1)
            if not keep.any():
                continue
            kept = np.flatnonzero(keep)
            cand_mask = np.ones((len(kept), n_items), dtype=bool)
            if specs is not None:
                rows = torch.as_tensor(kept, device=scores_dev.device)
                values = batch_eval_device(scores_dev[rows], pos_mask[kept], cand_mask, specs,
                                           dtype=torch.float64).T
            else:
                ctx = RankingContext(scores[kept], pos_mask[kept], cand_mask, ties=ties)
                values = [mt.batch_compute(ctx) for mt in metrics]
            for i in range(len(metrics)):
                for local, v in zip(kept, values[i]):
                    user_results[kind][i][chunk[local][0]] = float(v)

    for kind in kinds:
        for per_user in user_results[kind]:
            avg_results[kind].append(float(np.mean(list(per_user.values()))) if per_user else 0)
    return avg_results, user_results


class NextBasketEvaluation(RatioSplit):
    """Split *users* into train / val / test; evaluate each test user's last
    basket given their earlier baskets."""

    def __init__(
        self,
        data=None,
        test_size=0.2,
        val_size=0.0,
        fmt="UBI",
        seed=None,
        repetition_eval=False,
        exploration_eval=False,
        exclude_unknowns=True,
        verbose=False,
        **kwargs,
    ):
        assert fmt.startswith("U")
        data_size = len(set(u for (u, *_rest) in data))  # split by users

        super().__init__(
            data=data,
            data_size=data_size,
            test_size=test_size,
            val_size=val_size,
            fmt=fmt,
            seed=seed,
            exclude_unknowns=exclude_unknowns,
            verbose=verbose,
            **kwargs,
        )
        self.repetition_eval = repetition_eval
        self.exploration_eval = exploration_eval

    def _split(self):
        # the split unit is the USER: shuffle the unique owners, carve the
        # shuffled list into train/val/test, then pull each owner's rows
        owners = np.asarray([row[0] for row in self.data])
        shuffled = np.unique(owners)
        self.rng.shuffle(shuffled)

        def rows_of(members):
            return np.flatnonzero(np.isin(owners, members))

        cut = len(shuffled) - self.test_size
        if self.test_size == 0:
            # the JAX package's quirk (its test-user slice is [-0:]): a zero
            # test share puts EVERY user in test and leaves val empty
            test_members, val_members = shuffled, shuffled[:0]
        else:
            test_members = shuffled[cut:]
            val_members = shuffled[self.train_size : cut]
        val_rows = rows_of(val_members)
        self.build(
            train_data=safe_indexing(self.data, rows_of(shuffled[: self.train_size])),
            test_data=safe_indexing(self.data, rows_of(test_members)),
            val_data=safe_indexing(self.data, val_rows) if val_rows.size else None,
        )

    def _build_datasets(self, train_data, test_data, val_data=None):
        def as_baskets(rows, exclude_unknowns):
            return BasketDataset.build(
                data=rows, fmt=self.fmt, seed=self.seed,
                global_uid_map=self.global_uid_map,
                global_iid_map=self.global_iid_map,
                exclude_unknowns=exclude_unknowns,
            )

        # unknowns are only excluded from held-out sets (train defines them)
        self.train_set = as_baskets(train_data, False)
        self.test_set = as_baskets(test_data, self.exclude_unknowns)
        if val_data is not None and len(val_data) > 0:
            self.val_set = as_baskets(val_data, self.exclude_unknowns)

        built = [s for s in (self.train_set, self.test_set, self.val_set) if s]
        self.total_baskets = sum(s.num_baskets for s in built)
        if self.verbose:
            print(f"Total users = {self.total_users}")
            print(f"Total baskets = {self.total_baskets}")

    def _build_modalities(self):
        pass

    def _eval(self, model, test_set, ranking_metrics):
        avg_results, user_results = ranking_eval(
            model=model,
            metrics=ranking_metrics,
            train_set=self.train_set,
            test_set=test_set,
            repetition_eval=self.repetition_eval,
            exploration_eval=self.exploration_eval,
            exclude_unknowns=self.exclude_unknowns,
            verbose=self.verbose,
        )
        metric_avg_results = OrderedDict()
        metric_user_results = OrderedDict()
        for kind in _BREAKDOWNS:
            if kind != "conventional" and not getattr(self, f"{kind}_eval", False):
                continue
            for i, mt in enumerate(ranking_metrics):
                column = mt.name + _SUFFIX[kind]
                metric_avg_results[column] = avg_results[kind][i]
                metric_user_results[column] = user_results[kind][i]
        return Result(model.name, metric_avg_results, metric_user_results)

    def evaluate(self, model, metrics, user_based, show_validation=True):
        if not isinstance(model, NextBasketRecommender):
            raise ValueError(
                "model must be a NextBasketRecommender but '%s' is provided" % type(model)
            )
        if self.train_set is None:
            raise ValueError("no train_set available — build/split the data first")
        if self.test_set is None:
            raise ValueError("no test_set available — build/split the data first")

        self._reset()

        start = time.time()
        model.fit(self.train_set, self.val_set)
        train_time = time.time() - start

        _, ranking_metrics = self.organize_metrics(metrics)

        start = time.time()
        model.transform(self.test_set)
        test_result = self._eval(model, self.test_set, ranking_metrics)
        test_time = time.time() - start
        test_result.metric_avg_results["Train (s)"] = train_time
        test_result.metric_avg_results["Test (s)"] = test_time

        val_result = None
        if show_validation and self.val_set is not None:
            start = time.time()
            model.transform(self.val_set)
            val_result = self._eval(model, self.val_set, ranking_metrics)
            val_result.metric_avg_results["Time (s)"] = time.time() - start

        return test_result, val_result
