"""Experiment: run many models through one evaluation method.

Port of ``cornac_tpu/experiment/experiment.py``: validation filtering,
verbose propagation, model auto-save, and the VALIDATION/TEST console +
``CornacExp-*.log`` output, the fold-based branch for cross-validation
and propensity-stratified evaluation (one table per model, no validation
table, no model auto-save), and ``checkpoint_dir``: mid-training
checkpoints and resume for every model.
"""

import os
from datetime import datetime

from ..metrics.ranking import RankingMetric
from ..metrics.rating import RatingMetric
from ..models.recommender import Recommender
from .result import CVExperimentResult, ExperimentResult


def _filter_instances(seq, types, kind):
    """Keep only instances of ``types``; reject non-sequence input."""
    if not hasattr(seq, "__len__"):
        raise ValueError("{} have to be an array but {}".format(kind, type(seq)))
    return [x for x in seq if isinstance(x, types)]


def _is_fold_based(eval_method):
    from ..eval_methods.cross_validation import CrossValidation
    from ..eval_methods.propensity_stratified_evaluation import (
        PropensityStratifiedEvaluation,
    )

    return isinstance(eval_method, (CrossValidation, PropensityStratifiedEvaluation))


def _write_log(text, save_dir):
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f")
    path = os.path.join(save_dir or ".", "CornacExp-{}.log".format(stamp))
    with open(path, "w") as f:
        f.write(text)


class Experiment:
    """Evaluate ``models`` with ``metrics`` under ``eval_method``, print the
    comparison table, and write it to a timestamped log file.

    Parameters
    ----------
    eval_method: BaseMethod
        Evaluation protocol (e.g. RatioSplit).
    models: list of Recommender
        Models to compare.
    metrics: list of RatingMetric/RankingMetric
        Metrics to report.
    user_based: bool, default: True
        Average rating metrics per-user first (vs per-rating).
    show_validation: bool, default: True
        Also report results on the validation set when present.
    verbose: bool, default: False
        Propagates to the eval method and the models.
    save_dir: str, optional
        Where to store trained models and the log file.
    checkpoint_dir: str, optional
        Turn on periodic mid-training checkpoints (and resume) for every
        model, stored under ``checkpoint_dir/<model name>``
        (``Recommender.enable_checkpointing``).
    checkpoint_every: int, default: 10
        Epoch interval between checkpoints.
    """

    def __init__(
        self,
        eval_method,
        models,
        metrics,
        user_based=True,
        show_validation=True,
        verbose=False,
        save_dir=None,
        checkpoint_dir=None,
        checkpoint_every=10,
    ):
        self.eval_method = eval_method
        self.models = _filter_instances(models, Recommender, "models")
        self.metrics = _filter_instances(
            metrics, (RatingMetric, RankingMetric), "metrics"
        )
        self.user_based = user_based
        self.show_validation = show_validation
        self.verbose = verbose
        self.save_dir = save_dir
        self.result = None
        self.val_result = None
        if checkpoint_dir is not None:
            for model in self.models:
                model.enable_checkpointing(
                    os.path.join(checkpoint_dir, model.name),
                    every=checkpoint_every,
                )

    def run(self):
        """Fit + evaluate every model; print and log the result tables."""
        fold_based = _is_fold_based(self.eval_method)
        self.result = CVExperimentResult() if fold_based else ExperimentResult()
        want_val = (
            not fold_based
            and self.show_validation
            and self.eval_method.val_set is not None
        )
        self.val_result = ExperimentResult() if want_val else None

        if self.verbose:
            self.eval_method.verbose = True
            for model in self.models:
                model.verbose = True

        for model in self.models:
            test_result, val_result = self.eval_method.evaluate(
                model=model,
                metrics=self.metrics,
                user_based=self.user_based,
                show_validation=self.show_validation,
            )
            self.result.append(test_result)
            if self.val_result is not None:
                self.val_result.append(val_result)
            if self.save_dir and not fold_based:
                model.save(self.save_dir)

        sections = []
        if self.val_result is not None:
            sections.append("\nVALIDATION:\n...\n{}".format(self.val_result))
        sections.append("\nTEST:\n...\n{}".format(self.result))
        report = "".join(sections)

        print(report)
        _write_log(report, self.save_dir)
