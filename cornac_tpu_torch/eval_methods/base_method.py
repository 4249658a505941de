"""Evaluation engine + BaseMethod.

Port of ``cornac_tpu/eval_methods/base_method.py`` with the same masking
semantics (global-ID prefix ordering, exclude_unknowns truncation,
rating_threshold binarization, per-user averaging). Ranking evaluation
scores batches of users: a model with a device batch scorer hands a (B, N)
tensor on the card to the fused metric program
(``metrics.ranking.batch_eval_device``), others go through the host
``RankingContext``. ``BaseMethod`` builds train/test/val datasets over
shared global ID maps, builds the modalities (features, text, images,
graphs, sentiment, reviews) against them and runs timed fit + eval. Each
modality slot takes the JAX package's class, checked on assignment.
``BaseMethod(mesh=...)`` (a ``parallel.make_mesh`` mesh) shards the fused
metric program over the mesh, users over "data" and items over "model";
every rank evaluates, and every rank gets the unsharded metrics.
"""

import time
from collections import OrderedDict

import numpy as np

from ..data import (
    Dataset,
    FeatureModality,
    GraphModality,
    ImageModality,
    ReviewModality,
    SentimentModality,
    TextModality,
)
from ..experiment.result import Result
from ..metrics import RankingContext, RankingMetric, RatingMetric
from ..metrics.ranking import (
    _EVAL_CELL_BUDGET,
    _FUSED_MAX_ITEMS,
    batch_eval_device,
    metric_device_specs,
)
from ..parallel.mesh import check_mesh
from ..utils import get_rng


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
    mesh=None,
):
    """Evaluate ranking metrics with batched device scoring.

    Positives are test items with rating >= threshold; negatives are all
    items minus train/val/test positives; candidates are their union; with
    ``exclude_unknowns`` the item space is truncated to train items.
    ``mesh``: shard the fused metric program (``batch_eval_device``).
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
                    scores_dev[:, :n_items], pos_mask, cand_mask, fused_specs, mesh=mesh
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

            ctx = RankingContext(scores, pos_mask, cand_mask,
                                 ties=any(mt.uses_ties for mt in metrics))
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
    """Base evaluation protocol: builds train/test/val datasets over shared
    global ID maps, attaches modalities, and runs timed fit + eval."""

    # the class each modality slot takes; the properties are attached
    # after the class body
    _MODALITY_SLOTS = {
        "user_feature": FeatureModality,
        "item_feature": FeatureModality,
        "user_text": TextModality,
        "item_text": TextModality,
        "user_image": ImageModality,
        "item_image": ImageModality,
        "user_graph": GraphModality,
        "item_graph": GraphModality,
        "sentiment": SentimentModality,
        "review_text": ReviewModality,
    }

    def __init__(
        self,
        data=None,
        fmt="UIR",
        rating_threshold=1.0,
        seed=None,
        exclude_unknowns=True,
        verbose=False,
        **kwargs,
    ):
        self.mesh = kwargs.get("mesh", None)
        if self.mesh is not None:
            check_mesh(self.mesh)
        self.data = data
        self.fmt = fmt
        self.train_set = None
        self.test_set = None
        self.val_set = None
        self.rating_threshold = rating_threshold
        self.exclude_unknowns = exclude_unknowns
        self.verbose = verbose
        self.seed = seed
        self.rng = get_rng(seed)
        self.global_uid_map = kwargs.get("global_uid_map", OrderedDict())
        self.global_iid_map = kwargs.get("global_iid_map", OrderedDict())

        for attr in self._MODALITY_SLOTS:
            setattr(self, attr, kwargs.get(attr, None))

        if verbose:
            print("rating_threshold = {:.1f}".format(rating_threshold))
            print("exclude_unknowns = {}".format(exclude_unknowns))

    @property
    def total_users(self):
        return len(self.global_uid_map)

    @property
    def total_items(self):
        return len(self.global_iid_map)

    def _reset(self):
        """Re-seed the protocol RNG and test-set iterator RNG."""
        self.rng = get_rng(self.seed)
        self.test_set = self.test_set.reset()

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

    def _build_datasets(self, train_data, test_data, val_data=None):
        # train first: train entities take the dense-index prefix
        def build_split(split_data, exclude_unknowns):
            # every split shares the global id maps; train keeps all rows
            return Dataset.build(
                data=split_data,
                fmt=self.fmt,
                global_uid_map=self.global_uid_map,
                global_iid_map=self.global_iid_map,
                seed=self.seed,
                exclude_unknowns=exclude_unknowns,
            )

        self.train_set = build_split(train_data, False)
        self.test_set = build_split(test_data, self.exclude_unknowns)
        if val_data:
            self.val_set = build_split(val_data, self.exclude_unknowns)

        if self.verbose:
            tr, te, va = self.train_set, self.test_set, self.val_set
            lines = [
                "---", "Training data:",
                f"Number of users = {tr.num_users}",
                f"Number of items = {tr.num_items}",
                f"Number of ratings = {tr.num_ratings}",
                f"Max rating = {tr.max_rating:.1f}",
                f"Min rating = {tr.min_rating:.1f}",
                f"Global mean = {tr.global_mean:.1f}",
                "---", "Test data:",
                f"Number of users = {len(te.uid_map)}",
                f"Number of items = {len(te.iid_map)}",
                f"Number of ratings = {te.num_ratings}",
                f"Number of unknown users = {te.num_users - tr.num_users}",
                f"Number of unknown items = {te.num_items - tr.num_items}",
            ]
            if va is not None:
                lines += [
                    "---", "Validation data:",
                    f"Number of users = {len(va.uid_map)}",
                    f"Number of items = {len(va.iid_map)}",
                    f"Number of ratings = {va.num_ratings}",
                ]
            lines += [
                "---",
                f"Total users = {self.total_users}",
                f"Total items = {self.total_items}",
            ]
            print("\n".join(lines))

    def _build_modalities(self):
        # user-side slots build against the global user id map, item-side
        # slots against the global item id map, interaction-level slots
        # (sentiment, reviews) against the train set's maps and pairs
        train_kw = dict(
            uid_map=self.train_set.uid_map,
            iid_map=self.train_set.iid_map,
            dok_matrix=self.train_set.dok_matrix,
        )
        for attr in self._MODALITY_SLOTS:
            modality = getattr(self, attr)
            if modality is None:
                continue
            if attr.startswith("user_"):
                modality.build(id_map=self.global_uid_map, **train_kw)
            elif attr.startswith("item_"):
                modality.build(id_map=self.global_iid_map, **train_kw)
            else:
                modality.build(**train_kw)
        self.add_modalities(
            **{attr: getattr(self, attr) for attr in self._MODALITY_SLOTS}
        )

    def add_modalities(self, **kwargs):
        """Attach built modalities to every dataset."""
        for attr in self._MODALITY_SLOTS:
            setattr(self, attr, kwargs.get(attr, None))
        slots = {attr: getattr(self, attr) for attr in self._MODALITY_SLOTS}
        for data_set in (self.train_set, self.test_set, self.val_set):
            if data_set is not None:
                data_set.add_modalities(**slots)

    def build(self, train_data, test_data, val_data=None):
        """Build datasets over fresh global ID maps, then modalities."""
        if train_data is None or len(train_data) == 0:
            raise ValueError("train_data must be a non-empty collection")
        if test_data is None or len(test_data) == 0:
            raise ValueError("test_data must be a non-empty collection")

        self.global_uid_map.clear()
        self.global_iid_map.clear()

        self._build_datasets(train_data, test_data, val_data)
        self._build_modalities()

        return self

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
        mesh=None,
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
            mesh=mesh,
        )
        names = [mt.name for mt in rating_metrics + ranking_metrics]
        return Result(
            model.name,
            OrderedDict(zip(names, rat_avg + rank_avg)),
            OrderedDict(zip(names, rat_user + rank_user)),
        )

    def _score_split(self, model, split, heldout_val, metric_pair, user_based):
        """transform + eval one held-out split; returns (Result, seconds)."""
        rating_metrics, ranking_metrics = metric_pair
        start = time.time()
        model.transform(split)
        result = self.eval(
            model=model,
            train_set=self.train_set,
            test_set=split,
            val_set=heldout_val,
            rating_threshold=self.rating_threshold,
            exclude_unknowns=self.exclude_unknowns,
            rating_metrics=rating_metrics,
            ranking_metrics=ranking_metrics,
            user_based=user_based,
            verbose=self.verbose,
            mesh=self.mesh,
        )
        return result, time.time() - start

    def evaluate(self, model, metrics, user_based, show_validation=True):
        """Timed fit + eval of one model; returns (test_result, val_result)."""
        for attr in ("train_set", "test_set"):
            if getattr(self, attr) is None:
                raise ValueError(
                    f"no {attr} available — build/split the data first"
                )

        self._reset()

        if self.verbose:
            print("\n[{}] Training started!".format(model.name))
        start = time.time()
        model.fit(self.train_set, self.val_set)
        train_time = time.time() - start

        if self.verbose:
            print("\n[{}] evaluating...".format(model.name))
        metric_pair = self.organize_metrics(metrics)

        test_result, test_time = self._score_split(
            model, self.test_set, self.val_set, metric_pair, user_based
        )
        test_result.metric_avg_results["Train (s)"] = train_time
        test_result.metric_avg_results["Test (s)"] = test_time

        val_result = None
        if show_validation and self.val_set is not None:
            val_result, val_time = self._score_split(
                model, self.val_set, None, metric_pair, user_based
            )
            val_result.metric_avg_results["Time (s)"] = val_time

        return test_result, val_result

    @classmethod
    def from_splits(
        cls,
        train_data,
        test_data,
        val_data=None,
        fmt="UIR",
        rating_threshold=1.0,
        exclude_unknowns=False,
        seed=None,
        verbose=False,
        **kwargs,
    ):
        """Build an evaluation method from pre-split data."""
        method = cls(
            fmt=fmt,
            rating_threshold=rating_threshold,
            exclude_unknowns=exclude_unknowns,
            seed=seed,
            verbose=verbose,
            **kwargs,
        )
        return method.build(
            train_data=train_data, test_data=test_data, val_data=val_data
        )


def _modality_slot(attr, expected):
    """One typed modality property: None or an instance of ``expected``."""
    storage = "_" + attr

    def fget(self):
        return getattr(self, storage, None)

    def fset(self, value):
        if value is not None and not isinstance(value, expected):
            raise ValueError(
                "the {} modality must be a {}, got {}".format(
                    attr, expected.__name__, type(value).__name__
                )
            )
        setattr(self, storage, value)

    return property(fget, fset)


for _attr, _expected in BaseMethod._MODALITY_SLOTS.items():
    setattr(BaseMethod, _attr, _modality_slot(_attr, _expected))
del _attr, _expected
