"""Propensity-based stratified evaluation (Jadidinejad et al., TOIS 2021).

Port of ``cornac_tpu/eval_methods/propensity_stratified_evaluation.py``
(host numpy around the port's eval harness): item propensities from a
discrete power-law fit to item frequencies, test-set stratification into
quantiles, and the Closed / IPS / per-stratum / Unbiased rows.

The JAX package's two deviations from the reference stay, on purpose:
- the power-law fit is an in-house Clauset-Shalizi-Newman discrete MLE with
  KS-based xmin selection (the reference calls the external ``powerlaw``
  package); same estimator family, same outputs (alpha, xmin);
- the IPS pass weights each user's positives by inverse propensity inside
  the metric aggregation: an IPS-weighted share of the positives retrieved
  within each metric's cutoff (the reference's weighted dense mask
  degenerates inside metrics that expect index arrays).
"""

import time
from collections import OrderedDict, defaultdict

import numpy as np

from ..data import Dataset
from ..experiment.result import PSTResult, Result
from ..metrics import RankingContext
from ..utils.common import safe_indexing
from .base_method import BaseMethod, _csr_row_masks, rating_eval
from .ratio_split import RatioSplit


def fit_discrete_powerlaw(data, xmin_candidates=None):
    """Discrete power-law MLE (Clauset-Shalizi-Newman 2009, eq. 3.7 approx):
    alpha = 1 + n / sum(ln(x / (xmin - 0.5))), with xmin chosen to minimize
    the KS distance between the empirical and fitted CDFs."""
    data = np.asarray(data, dtype=np.float64)
    data = data[data > 0]
    if xmin_candidates is None:
        xmin_candidates = np.unique(data)
        if len(xmin_candidates) > 100:  # cap the search grid
            xmin_candidates = np.quantile(xmin_candidates, np.linspace(0, 0.95, 100))
            xmin_candidates = np.unique(np.round(xmin_candidates))

    best = (np.inf, 2.0, float(np.min(data)))  # (ks, alpha, xmin)
    for xmin in xmin_candidates:
        tail = data[data >= xmin]
        if len(tail) < 2:
            continue
        alpha = 1.0 + len(tail) / np.sum(np.log(tail / (xmin - 0.5)))
        if not np.isfinite(alpha) or alpha <= 1.0:
            continue
        # empirical vs model CDF on the tail
        xs = np.sort(tail)
        emp_cdf = np.arange(1, len(xs) + 1) / len(xs)
        model_ccdf = (xs / xmin) ** (1.0 - alpha)
        ks = np.max(np.abs(emp_cdf - (1.0 - model_ccdf)))
        if ks < best[0]:
            best = (ks, float(alpha), float(xmin))
    return best[1], best[2]


class PropensityStratifiedEvaluation(BaseMethod):
    """Stratify the test set by estimated item propensity and report
    closed-loop, IPS-weighted, per-stratum, and unbiased aggregate results."""

    def __init__(
        self, data, test_size=0.2, val_size=0.0, n_strata=2,
        rating_threshold=1.0, seed=None, exclude_unknowns=True,
        verbose=False, **kwargs,
    ):
        super().__init__(
            data=data, rating_threshold=rating_threshold, seed=seed,
            exclude_unknowns=exclude_unknowns, verbose=verbose, **kwargs,
        )

        self.n_strata = n_strata
        self.props = self._estimate_propensities()

        sizes = RatioSplit.validate_size(val_size, test_size, len(data))
        self.train_size, self.val_size, self.test_size = sizes
        self._split()

    def _estimate_propensities(self):
        """Item propensity ~ freq^alpha above the power-law cutoff."""
        raw_iids, counts = np.unique(
            [tup[1] for tup in self.data], return_counts=True
        )
        alpha, fmin = fit_discrete_powerlaw(counts.astype(np.float64))

        if self.verbose:
            print(f"Power-law fit: alpha={alpha:.6f}, xmin={int(fmin)}")

        prop = np.where(counts > fmin, counts.astype(np.float64) ** alpha,
                        counts.astype(np.float64))
        # defaultdict(int): items never seen get propensity 0, matching
        # the reference's counter semantics
        out = defaultdict(int)
        out.update(zip(raw_iids.tolist(), prop.tolist()))
        return out

    def _split(self):
        perm = self.rng.permutation(len(self.data))
        tr, te = perm[: self.train_size], perm[-self.test_size :]
        va = perm[self.train_size : -self.test_size]

        train_data, test_data = (safe_indexing(self.data, ix) for ix in (tr, te))
        val_data = safe_indexing(self.data, va) if len(va) > 0 else None

        self._build_datasets(
            train_data=train_data, test_data=test_data, val_data=val_data
        )
        self._build_stratified_dataset(test_data=test_data)

    def _build_stratified_dataset(self, test_data):
        # equal-width propensity bins over the (slightly widened) range;
        # bin ids reproduce the reference's digitize-over-arange labels
        test_props = np.asarray(
            [self.props[tup[1]] for tup in test_data], dtype=np.float64
        )
        lo, hi = test_props.min() * 0.99, test_props.max() * 1.01
        edges = np.arange(lo, hi, (hi - lo) / self.n_strata)
        bin_of = np.digitize(test_props, bins=edges)

        self.stratified_sets = {}
        for b in np.unique(bin_of):
            members = np.flatnonzero(bin_of == b)
            qtest_set = Dataset.build(
                data=[test_data[j] for j in members],
                fmt=self.fmt,
                global_uid_map=self.global_uid_map,
                global_iid_map=self.global_iid_map,
                seed=self.seed,
                exclude_unknowns=self.exclude_unknowns,
            )
            if self.verbose:
                print(
                    "---\nTest data (Q{}): {} ratings".format(
                        b, qtest_set.num_ratings
                    )
                )
            self.stratified_sets[f"Q{b}"] = qtest_set

    def _ips_ranking_eval(self, model, metrics, test_set, val_set):
        """IPS-weighted ranking metrics: each positive contributes with
        weight 1/propensity, normalized per user."""
        if len(metrics) == 0:
            return [], []

        n_items = (
            self.train_set.num_items if self.exclude_unknowns else test_set.num_items
        )
        # propensity per dense item index (1.0 when unknown)
        prop_per_item = np.ones(n_items, dtype="float")
        for raw_iid, idx in self.global_iid_map.items():
            if idx < n_items:
                prop_per_item[idx] = max(self.props.get(raw_iid, 1.0), 1e-12)
        ips_weight = 1.0 / prop_per_item

        avg_results = []
        user_results = [{} for _ in enumerate(metrics)]

        test_mat = test_set.csr_matrix
        train_mat = self.train_set.csr_matrix
        val_mat = None if val_set is None else val_set.csr_matrix
        test_users = np.unique(test_set.uir_tuple[0])

        batch = 1024
        for start in range(0, len(test_users), batch):
            users = test_users[start : start + batch]
            pos_mask = _csr_row_masks(test_mat, users, n_items, self.rating_threshold)
            keep = pos_mask.any(axis=1)
            if not keep.any():
                continue
            users, pos_mask = users[keep], pos_mask[keep]
            train_pos = _csr_row_masks(train_mat, users, n_items, self.rating_threshold)
            val_pos = (
                _csr_row_masks(val_mat, users, n_items, self.rating_threshold)
                if val_mat is not None
                else np.zeros_like(pos_mask)
            )
            neg_mask = ~(pos_mask | train_pos | val_pos)
            cand_mask = pos_mask | neg_mask

            scores = np.asarray(model.score_batch(users), dtype=np.float64)[:, :n_items]
            scores = np.where(cand_mask, scores, -np.inf)

            ctx = RankingContext(scores, pos_mask, cand_mask,
                                 ties=any(mt.uses_ties for mt in metrics))
            w = np.where(pos_mask, ips_weight[None, :], 0.0)
            total_w = w.sum(axis=1)
            for i, mt in enumerate(metrics):
                k = getattr(mt, "k", -1)
                k_eff = ctx.truncation(k)[:, None]
                # IPS-weighted share of positives retrieved inside the cutoff
                hit_w = np.where(ctx.pos_ranks < k_eff, w, 0.0).sum(axis=1)
                vals = hit_w / np.maximum(total_w, 1e-12)
                user_results[i].update(
                    {int(u): float(v) for u, v in zip(users, vals)}
                )

        for i, mt in enumerate(metrics):
            avg_results.append(
                sum(user_results[i].values()) / max(len(user_results[i]), 1)
            )
        return avg_results, user_results

    def _eval(self, model, test_set, val_set, user_based, props=None):
        from .base_method import ranking_eval

        rat_avg, rat_user = rating_eval(
            model, self.rating_metrics, test_set, user_based=user_based
        )
        if props is None:
            rank_avg, rank_user = ranking_eval(
                model, self.ranking_metrics, self.train_set, test_set,
                val_set=val_set, rating_threshold=self.rating_threshold,
                exclude_unknowns=self.exclude_unknowns, verbose=self.verbose,
            )
        else:
            rank_avg, rank_user = self._ips_ranking_eval(
                model, self.ranking_metrics, test_set, val_set
            )
        names = [mt.name for mt in self.rating_metrics + self.ranking_metrics]
        return Result(
            model.name,
            OrderedDict(zip(names, rat_avg + rank_avg)),
            OrderedDict(zip(names, rat_user + rank_user)),
        )

    def evaluate(self, model, metrics, user_based, show_validation=True):
        result = PSTResult(model.name)

        for attr in ("train_set", "test_set"):
            if getattr(self, attr) is None:
                raise ValueError(f"no {attr} available — build/split the data first")

        self._reset()
        self.rating_metrics, self.ranking_metrics = self.organize_metrics(metrics)

        if self.verbose:
            print("\n[{}] Training started!".format(model.name))

        start = time.time()
        model.fit(self.train_set, self.val_set)
        train_time = time.time() - start  # noqa: F841 (reported via rows)

        if self.verbose:
            print("\n[{}] evaluating...".format(model.name))

        # one row per protocol view: closed-loop on the sampled test set,
        # IPS-weighted on the same set, then one row per propensity stratum
        views = [(self.test_set, None), (self.test_set, self.props)]
        views += [(q, None) for q in self.stratified_sets.values()]
        for split, props in views:
            row = self._eval(model, split, self.val_set, user_based, props=props)
            row.metric_avg_results["SIZE"] = split.num_ratings
            result.append(row)

        result.organize()

        val_result = None
        if show_validation and self.val_set is not None:
            val_result = self._eval(model, self.val_set, None, user_based)

        return result, val_result
