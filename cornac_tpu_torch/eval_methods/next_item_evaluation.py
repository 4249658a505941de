"""Next-item (session-based) evaluation.

Port of ``cornac_tpu/eval_methods/next_item_evaluation.py``: modes 'last'
and 'next', session- or user-averaged results, and the three constructors
(``from_splits``, ``from_timestamps``, a global temporal cutoff, and
``leave_last_out``). The prediction positions of the test sessions are
scored in chunks of 256 through ``NextItemRecommender.score_history_batch``
(one padded forward on the model's device for GRU4Rec and SASRec) and
ranked by the batched metrics (``RankingContext``); a chunk's float64
scores are (256, items), so the (positions x items) matrix is never built
whole. A model with ``score_history_batch_device`` (GRU4Rec, SASRec,
TransformerRec) keeps a chunk's scores on its device, where the context
ranks them (without tie counts to read, each target's rank alone).
"""

import time
import warnings
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from ..data import SequentialDataset
from ..experiment.result import Result
from ..metrics import RankingContext
from ..models.recommender import NextItemRecommender
from ..utils import validate_format
from .base_method import BaseMethod

EVALUATION_MODES = frozenset(["last", "next"])



def _fit_width(scores, n_items):
    """Slice or min-fill-expand a score matrix (numpy, or a tensor on the
    model's device) to exactly n_items columns (models trained before
    eval-time unknowns may return narrower rows)."""
    if scores.shape[1] >= n_items:
        return scores[:, :n_items]
    if isinstance(scores, torch.Tensor):
        fill = scores.min(dim=1, keepdim=True).values
        return torch.cat([scores, fill.expand(-1, n_items - scores.shape[1])], 1)
    fill = scores.min(axis=1, keepdims=True)
    out = np.broadcast_to(fill, (scores.shape[0], n_items)).copy()
    out[:, : scores.shape[1]] = scores
    return out


def ranking_eval(
    model, metrics, train_set, test_set,
    user_based=False, exclude_unknowns=True,
    mode="last", verbose=False, batch_size=256,
):
    """Evaluate ranking metrics over test-session prediction positions.

    The flat task list (one entry per prediction position) feeds the
    batched device scorer; per-position metric values are then
    aggregated by numpy group-by over the grouping key (user or
    session, depending on the averaging mode)."""
    if not metrics:
        return [], []

    n_items = train_set.num_items if exclude_unknowns else test_set.num_items

    # one flat pass over the test sessions: every prediction position
    # becomes (group_key, user, history, target)
    tasks = []
    for [sid], [mapped_ids], [session_items] in test_set.si_iter(
        batch_size=1, shuffle=False
    ):
        if len(session_items) < 2:  # too short to predict from
            continue
        user_idx = int(test_set.uir_tuple[0][mapped_ids[0]])
        group = user_idx if user_based else sid
        first = 1 if mode == "next" else len(session_items) - 1
        tasks.extend(
            (group, user_idx, list(session_items[:pos]), session_items[pos])
            for pos in range(first, len(session_items))
        )

    # score + metric every position in device-sized chunks; a model that
    # scores on its device (``score_history_batch_device``) hands the
    # context its tensor, ranked there
    on_device = getattr(model, "score_history_batch_device", None)
    ties = any(mt.uses_ties for mt in metrics)
    task_groups, values = [], []  # aligned: values[j] is (n_metrics,)
    for start in range(0, len(tasks), batch_size):
        chunk = tasks[start : start + batch_size]
        users, histories = np.asarray([t[1] for t in chunk]), [t[2] for t in chunk]
        if on_device is not None:
            scores = _fit_width(on_device(users, histories), n_items)
        else:
            scores = _fit_width(
                np.asarray(model.score_history_batch(users, histories), dtype=np.float64),
                n_items,
            )

        targets = np.asarray([t[3] for t in chunk])
        usable = np.flatnonzero(targets < n_items)
        if not len(usable):
            continue
        # every position usable (the common case): the chunk's own rows,
        # not a copy of them
        if len(usable) < len(chunk):
            scores = scores[usable]
        ctx = RankingContext(scores, targets=targets[usable], ties=ties)
        per_metric = np.stack(
            [np.asarray(mt.batch_compute(ctx), dtype=float) for mt in metrics]
        )  # (n_metrics, n_usable)
        task_groups.extend(chunk[j][0] for j in usable)
        values.append(per_metric)

    if not values:
        nan = float("nan")
        return [nan] * len(metrics), [defaultdict(list) for _ in metrics]

    values = np.concatenate(values, axis=1)  # (n_metrics, n_positions)
    group_arr = np.asarray(task_groups)
    uniq, inverse = np.unique(group_arr, return_inverse=True)
    counts = np.bincount(inverse).astype(float)

    avg_results = []
    per_user = []
    for mi in range(len(metrics)):
        bucket = defaultdict(list)
        if user_based:
            # mean over users of each user's per-position mean
            sums = np.bincount(inverse, weights=values[mi])
            avg_results.append(float((sums / counts).mean()))
            for g, v in zip(group_arr.tolist(), values[mi].tolist()):
                bucket[g].append(v)
        else:
            # plain mean over positions; per-user results stay empty in
            # session-averaged mode (as in the per-user protocol contract)
            avg_results.append(float(values[mi].mean()))
        per_user.append(bucket)
    return avg_results, per_user


class NextItemEvaluation(BaseMethod):
    """Next-item evaluation protocol over SequentialDatasets."""

    def __init__(
        self, data=None, test_size=0.2, val_size=0.0, fmt="SIT",
        seed=None, mode="last", exclude_unknowns=True, verbose=False,
        **kwargs,
    ):
        # test_size/val_size mirror the reference signature
        # (next_item_evaluation.py:211-212); there as here the direct
        # constructor performs no split — the from_splits/from_timestamps/
        # leave_last_out classmethods do — so they are stored, not acted on.
        self.test_size, self.val_size = test_size, val_size
        super().__init__(
            data=data, fmt=fmt, seed=seed, verbose=verbose,
            exclude_unknowns=exclude_unknowns, **kwargs,
        )
        if mode not in EVALUATION_MODES:
            raise ValueError(f"{mode} is not supported. ({EVALUATION_MODES})")
        self.mode = mode
        self.global_sid_map = kwargs.get("global_sid_map", OrderedDict())

    def _build_one_split(self, split_data, exclude_unknowns):
        """All three splits share id maps and build kwargs; only the data
        and the unknown-handling differ."""
        return SequentialDataset.build(
            data=split_data,
            fmt=self.fmt,
            global_uid_map=self.global_uid_map,
            global_iid_map=self.global_iid_map,
            global_sid_map=self.global_sid_map,
            seed=self.seed,
            exclude_unknowns=exclude_unknowns,
        )

    def _build_datasets(self, train_data, test_data, val_data=None):
        # train keeps every event (unknowns only matter for scoring); the
        # held-out splits honor the protocol's exclude_unknowns choice
        self.train_set = self._build_one_split(train_data, False)
        self.test_set = self._build_one_split(test_data, self.exclude_unknowns)
        if val_data:
            self.val_set = self._build_one_split(val_data, self.exclude_unknowns)

        if self.verbose:
            tr, te = self.train_set, self.test_set
            print(
                "---\nTraining data:\n"
                f"Number of users = {tr.num_users}\n"
                f"Number of items = {tr.num_items}\n"
                f"Number of sessions = {tr.num_sessions}\n"
                "---\nTest data:\n"
                f"Number of sessions = {te.num_sessions}"
            )

        self.total_sessions = sum(
            s.num_sessions
            for s in (self.train_set, self.test_set, self.val_set)
            if s is not None
        )

    def _build_modalities(self):
        # sequential protocols carry item-side auxiliary modalities (e.g.
        # TIGER's precomputed content embeddings via item_feature)
        for item_modality in [self.item_feature, self.item_text, self.item_image]:
            if item_modality is None:
                continue
            item_modality.build(id_map=self.global_iid_map)
        self.add_modalities(
            item_feature=self.item_feature,
            item_text=self.item_text,
            item_image=self.item_image,
        )

    @staticmethod
    def eval(
        model, train_set, test_set, exclude_unknowns, ranking_metrics,
        user_based=False, verbose=False, mode="last", **kwargs,
    ):
        avg, per_user = ranking_eval(
            model, ranking_metrics, train_set, test_set,
            user_based=user_based, exclude_unknowns=exclude_unknowns,
            mode=mode, verbose=verbose,
        )
        names = [mt.name for mt in ranking_metrics]
        return Result(
            model.name,
            OrderedDict(zip(names, avg)),
            OrderedDict(zip(names, per_user)),
        )

    def _score_split(self, model, split, ranking_metrics, user_based):
        """transform + eval one held-out split; returns (Result, seconds)."""
        start = time.time()
        model.transform(split)
        result = self.eval(
            model, self.train_set, split, self.exclude_unknowns,
            ranking_metrics, user_based=user_based, mode=self.mode,
            verbose=self.verbose,
        )
        return result, time.time() - start

    def evaluate(self, model, metrics, user_based, show_validation=True):
        wrapped = getattr(model, "model", None)
        if not any(
            isinstance(m, NextItemRecommender) for m in (model, wrapped)
        ):
            raise ValueError(
                "model must be a NextItemRecommender but '%s' is provided" % type(model)
            )
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
        rating_metrics, ranking_metrics = self.organize_metrics(metrics)
        if rating_metrics:
            warnings.warn(
                "NextItemEvaluation only supports ranking metrics. The given "
                "rating metrics {} will be ignored!".format(
                    [mt.name for mt in rating_metrics]
                )
            )

        test_result, test_time = self._score_split(
            model, self.test_set, ranking_metrics, user_based
        )
        test_result.metric_avg_results["Train (s)"] = train_time
        test_result.metric_avg_results["Test (s)"] = test_time

        val_result = None
        if show_validation and self.val_set is not None:
            val_result, val_time = self._score_split(
                model, self.val_set, ranking_metrics, user_based
            )
            val_result.metric_avg_results["Time (s)"] = val_time

        return test_result, val_result

    @classmethod
    def from_splits(
        cls, train_data, test_data, val_data=None, fmt="SIT",
        exclude_unknowns=False, seed=None, verbose=False, **kwargs,
    ):
        """Build from pre-split sequential data."""
        method = cls(
            fmt=fmt, exclude_unknowns=exclude_unknowns,
            seed=seed, verbose=verbose, **kwargs,
        )
        return method.build(
            train_data=train_data, test_data=test_data, val_data=val_data
        )

    @classmethod
    def from_timestamps(
        cls, data, test_timestamp, val_timestamp=None, fmt="USIT",
        exclude_unknowns=True, mode="last", seed=None, verbose=False,
        **kwargs,
    ):
        """Global temporal split: each session goes wholly to the split
        indicated by its last event's timestamp (train < val_ts <= val <
        test_ts <= test). Leakage-free protocol per Meng et al. (RecSys
        2020) and Hidasi & Czapp (RecSys 2023)."""
        fmt = validate_format(fmt, ["SIT", "USIT", "SITJson", "USITJson"])

        if val_timestamp is not None and val_timestamp >= test_timestamp:
            raise ValueError(
                f"val_timestamp ({val_timestamp}) must come strictly "
                f"before test_timestamp ({test_timestamp})."
            )

        has_user = fmt in ("USIT", "USITJson")
        sid_pos, ts_pos = (1, 3) if has_user else (0, 2)

        # a session's split is decided by its LAST event, so the whole
        # session lands in one partition (no within-session leakage)
        last_ts = defaultdict(lambda: float("-inf"))
        for tup in data:
            sid = tup[sid_pos]
            last_ts[sid] = max(last_ts[sid], float(tup[ts_pos]))

        def bucket_of(sid):
            ts = last_ts[sid]
            if ts >= test_timestamp:
                return 2
            if val_timestamp is not None and ts >= val_timestamp:
                return 1
            return 0

        parts = ([], [], [])
        for tup in data:
            parts[bucket_of(tup[sid_pos])].append(tup)
        train_data, val_data, test_data = parts

        if not train_data:
            raise ValueError(
                "Empty train partition: no session ends before the cutoff."
            )
        if not test_data:
            raise ValueError(
                f"Empty test partition: no session ends at or after "
                f"test_timestamp ({test_timestamp})."
            )
        if val_timestamp is not None and not val_data:
            warnings.warn(
                "Empty validation partition; proceeding with no validation set."
            )
            val_data = None

        return cls.from_splits(
            train_data, test_data, val_data=val_data, fmt=fmt,
            exclude_unknowns=exclude_unknowns, seed=seed,
            verbose=verbose, mode=mode, **kwargs,
        )

    @classmethod
    def leave_last_out(
        cls, data, fmt="UIRT", exclude_unknowns=True, mode="last",
        seed=None, verbose=False, **kwargs,
    ):
        """Per-user leave-last-out: each user's chronological interactions
        form one session; last item -> test, second-to-last -> val. Standard
        protocol of the sequential-recommendation literature (SASRec,
        BERT4Rec); see from_timestamps for the leakage-free alternative."""
        fmt = validate_format(fmt, ["UIRT"])

        by_user = OrderedDict()
        for u, i, _, t in data:
            by_user.setdefault(u, []).append((float(t), i, t))

        train_data, val_data, test_data = [], [], []
        n_skipped = 0
        for u, events in by_user.items():
            if len(events) < 3:
                n_skipped += 1
                continue
            events.sort(key=lambda x: x[0])
            seq = [(u, u, i, t) for _, i, t in events]
            train_data.extend(seq[:-2])
            val_data.extend(seq[:-1])
            test_data.extend(seq)

        if len(train_data) == 0:
            raise ValueError("Empty train set: no user has at least 3 interactions.")

        if verbose:
            print(
                "Leave-last-out: {} users kept, {} dropped (<3 interactions)".format(
                    len(by_user) - n_skipped, n_skipped
                )
            )

        return cls.from_splits(
            train_data, test_data, val_data=val_data, fmt="USIT",
            exclude_unknowns=exclude_unknowns, seed=seed,
            verbose=verbose, mode=mode, **kwargs,
        )
