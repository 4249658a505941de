"""StratifiedSplit: per-user or per-item (optionally chronological) split.

A copy of ``cornac_tpu/eval_methods/stratified_split.py`` (host numpy):
groups come from one stable argsort and boundary cuts, and each group's
draws are made in first-appearance order of its key from the same seeded
legacy ``RandomState``, so for a seed the splits are the JAX package's,
byte for byte.
"""

import numpy as np

from ..utils.common import safe_indexing
from .base_method import BaseMethod
from .ratio_split import RatioSplit


class StratifiedSplit(BaseMethod):
    """Slice each user's (or item's) interactions into train/val/test.

    With ``chrono=True`` data is first ordered globally by timestamp; each
    group keeps its chronological head for training and samples val/test
    from a shuffled tail.
    """

    def __init__(
        self,
        data,
        group_by="user",
        chrono=False,
        fmt="UIRT",
        test_size=0.2,
        val_size=0.0,
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

        if group_by not in ("user", "item"):
            raise ValueError(f"group_by accepts 'user' or 'item', got {group_by!r}")
        has_time = fmt == "UIRT" and len(self.data[0]) == 4
        if chrono and not has_time:
            msg = 'chrono=True needs timestamps: supply 4-column data with fmt="UIRT"'
            raise ValueError(msg)

        self.chrono = chrono
        self.group_by = group_by
        self.val_size = val_size
        self.test_size = test_size

        self._split()

    def _group_slices(self, data):
        """Yield each group's positions (into ``data``) in first-appearance
        order of the group key, via one shared stable sort."""
        col = 0 if self.group_by == "user" else 1
        keys = np.asarray([row[col] for row in data])

        order = np.argsort(keys, kind="stable")
        cuts = np.flatnonzero(keys[order][1:] != keys[order][:-1]) + 1
        starts = np.concatenate(([0], cuts))
        ends = np.concatenate((cuts, [keys.size]))

        # a stable sort puts each group's earliest position first, so
        # ordering groups by that position recovers first-appearance order
        for g in np.argsort(order[starts], kind="stable"):
            yield order[starts[g] : ends[g]]

    def _split(self):
        data = sorted(self.data, key=lambda row: row[3]) if self.chrono else self.data

        buckets = {"train": [], "val": [], "test": []}
        for positions in self._group_slices(data):
            sizes = RatioSplit.validate_size(
                self.val_size, self.test_size, positions.size
            )
            n_train, n_test = sizes[0], sizes[2]
            if not self.chrono:
                arranged = self.rng.permutation(positions)
            else:
                # chronological head trains as-is; only the tail is shuffled
                tail = self.rng.permutation(positions[n_train:])
                arranged = np.concatenate((positions[:n_train], tail))

            buckets["train"].append(arranged[:n_train])
            if n_test == 0:
                # reference quirk (stratified_split.py:137-139): a zero-size
                # per-group test share slices [-0:] = the whole group, and
                # the val share [n_train:-0] collapses to empty
                buckets["val"].append(arranged[:0])
                buckets["test"].append(arranged)
            else:
                buckets["val"].append(arranged[n_train : positions.size - n_test])
                buckets["test"].append(arranged[positions.size - n_test :])

        picked = {
            name: np.concatenate(parts) if parts else np.empty(0, dtype=int)
            for name, parts in buckets.items()
        }
        val_data = (
            safe_indexing(data, picked["val"]) if picked["val"].size else None
        )
        self.build(
            train_data=safe_indexing(data, picked["train"]),
            test_data=safe_indexing(data, picked["test"]),
            val_data=val_data,
        )
