"""TimestampSplit: global chronological split by cutoff or ratio.

A copy of ``cornac_tpu/eval_methods/timestamp_split.py`` (host numpy): the
same cutoffs, windows and errors, so the splits are the JAX package's.
"""

import warnings

import numpy as np

from ..utils.common import safe_indexing
from .base_method import BaseMethod
from .ratio_split import RatioSplit


class TimestampSplit(BaseMethod):
    """Partition interactions along the time axis.

    Two cutoff timestamps define three half-open windows::

        train:      ts <  val_timestamp
        validation: val_timestamp <= ts < test_timestamp
        test:       ts >= test_timestamp

    Callers pick exactly one configuration mode: pass both cutoffs
    explicitly, or pass ``test_size`` (optionally ``val_size``) and let the
    cutoffs be derived so the chronologically-latest fraction of
    interactions lands in test.
    """

    def __init__(
        self,
        data,
        val_timestamp=None,
        test_timestamp=None,
        test_size=None,
        val_size=None,
        fmt="UIRT",
        rating_threshold=1.0,
        seed=None,
        exclude_unknowns=True,
        verbose=False,
        **kwargs,
    ):
        super().__init__(
            data=data,
            fmt=fmt,
            rating_threshold=rating_threshold,
            seed=seed,
            exclude_unknowns=exclude_unknowns,
            verbose=verbose,
            **kwargs,
        )

        if fmt != "UIRT" or len(self.data[0]) != 4:
            raise ValueError(
                "TimestampSplit needs a timestamp column: load the data with "
                'fmt="UIRT" (4 fields per interaction)'
            )

        cutoff_mode = val_timestamp is not None or test_timestamp is not None
        ratio_mode = test_size is not None or val_size is not None
        if cutoff_mode and ratio_mode:
            raise ValueError(
                "cutoff arguments (val_timestamp/test_timestamp) and ratio "
                "arguments (test_size/val_size) are mutually exclusive"
            )

        if cutoff_mode:
            if val_timestamp is None or test_timestamp is None:
                raise ValueError(
                    "cutoff mode needs both val_timestamp and test_timestamp "
                    "(pass test_size instead to split by ratio)"
                )
            if not val_timestamp < test_timestamp:
                raise ValueError(
                    f"cutoffs out of order: val_timestamp={val_timestamp} must "
                    f"precede test_timestamp={test_timestamp}"
                )
            self.val_timestamp, self.test_timestamp = val_timestamp, test_timestamp
        elif test_size is not None:
            self.val_timestamp, self.test_timestamp = self._derive_cutoffs(
                test_size, val_size
            )
        else:
            raise ValueError(
                "no split requested: pass val_timestamp+test_timestamp, or "
                "test_size (optionally val_size)"
            )

        self._split()

    def _derive_cutoffs(self, test_size, val_size):
        """Turn count/fraction sizes into the two cutoff timestamps.

        The sorted timestamp vector is indexed at the train and train+val
        boundaries; ``_split``'s ``<`` / ``>=`` comparisons then decide which
        side tied timestamps fall on.
        """
        n_train, n_val, n_test = RatioSplit.validate_size(
            val_size=val_size, test_size=test_size, data_size=len(self.data)
        )
        if n_test == 0:
            raise ValueError(
                f"test_size={test_size} resolves to zero test interactions"
            )

        timeline = np.sort(np.asarray([row[3] for row in self.data]))
        test_cut = timeline[n_train + n_val]
        val_cut = timeline[n_train] if n_val > 0 else test_cut

        if val_cut == timeline[0]:
            raise ValueError(
                "every interaction at or after the first timestamp would be "
                "held out (tied timestamps at the train boundary); shrink "
                "test_size/val_size or pass explicit cutoffs"
            )
        if n_val > 0 and val_cut == test_cut:
            warnings.warn(
                "tied timestamps squeezed the validation window to nothing; "
                "no val_set will be built"
            )

        return val_cut, test_cut

    def _split(self):
        # one vectorized pass over the timestamp column; the two cutoffs
        # induce three boolean masks
        ts = np.asarray([row[3] for row in self.data])
        before_val = ts < self.val_timestamp
        before_test = ts < self.test_timestamp

        train_idx = np.flatnonzero(before_val)
        val_idx = np.flatnonzero(before_test & ~before_val)
        test_idx = np.flatnonzero(~before_test)

        if train_idx.size == 0:
            raise ValueError(
                f"nothing precedes val_timestamp={self.val_timestamp}: the "
                "training window is empty"
            )
        if test_idx.size == 0:
            raise ValueError(
                f"nothing at or after test_timestamp={self.test_timestamp}: "
                "the test window is empty"
            )

        self.build(
            train_data=safe_indexing(self.data, train_idx),
            test_data=safe_indexing(self.data, test_idx),
            val_data=safe_indexing(self.data, val_idx) if val_idx.size else None,
        )
