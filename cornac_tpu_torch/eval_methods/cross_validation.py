"""k-fold cross-validation protocol.

Port of ``cornac_tpu/eval_methods/cross_validation.py``: the balanced fold
labels consume the seeded stream in the same order (one shuffle of the
labels, then one draw for the remainder), so the folds are the JAX
package's for a seed; each fold trains a fresh clone of the model.
"""

import numpy as np

from ..experiment.result import CVResult
from ..utils.common import safe_indexing
from .base_method import BaseMethod


class CrossValidation(BaseMethod):
    """Assign every rating to one of ``n_folds``; each fold serves once as
    the test (and validation) set while a fresh clone of the model trains on
    the remaining folds."""

    def __init__(
        self,
        data,
        n_folds=5,
        rating_threshold=1.0,
        partition=None,
        seed=None,
        exclude_unknowns=True,
        verbose=False,
        **kwargs,
    ):
        super().__init__(
            data=data,
            rating_threshold=rating_threshold,
            seed=seed,
            exclude_unknowns=exclude_unknowns,
            verbose=verbose,
            **kwargs,
        )

        self.n_folds = n_folds
        self.n_ratings = len(self.data)
        self.current_fold = 0
        self.current_split = None

        if partition is not None:
            partition = np.asarray(partition)
            if partition.shape[0] != self.n_ratings:
                raise ValueError(
                    f"partition labels one entry per rating: got "
                    f"{partition.shape[0]} labels for {self.n_ratings} ratings"
                )
            if np.unique(partition).size != self.n_folds:
                raise ValueError(
                    f"partition uses {np.unique(partition).size} distinct fold "
                    f"labels but n_folds={self.n_folds}"
                )
        else:
            partition = self._draw_fold_labels()
        self._partition = partition

    def _draw_fold_labels(self):
        """Balanced random fold labels: every fold gets ``n // k`` ratings,
        and each leftover rating lands on an independently drawn fold."""
        per_fold, leftover = divmod(self.n_ratings, self.n_folds)

        labels = np.repeat(np.arange(self.n_folds), per_fold)
        self.rng.shuffle(labels)
        if leftover:
            spill = self.rng.choice(self.n_folds, size=leftover, replace=True, p=None)
            labels = np.concatenate((labels, spill))
        return labels

    def _build_fold(self, fold):
        """Materialize train/test sets with ``fold`` held out."""
        self.current_fold = fold
        if self.verbose:
            print(f"Fold: {fold + 1}")

        mask = self._partition == fold
        held = safe_indexing(self.data, np.flatnonzero(mask))
        rest = safe_indexing(self.data, np.flatnonzero(~mask))
        self.build(train_data=rest, test_data=held, val_data=held)

    def evaluate(self, model, metrics, user_based, show_validation):
        agg = CVResult(model.name)

        for fold in range(self.n_folds):
            self._build_fold(fold)
            per_fold, _ = BaseMethod.evaluate(
                self,
                model.clone(),  # fresh parameters per fold
                metrics,
                user_based,
                show_validation=False,
            )
            agg.append(per_fold)
        self.current_fold = 0

        agg.organize()
        return agg, None
