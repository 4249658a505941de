"""RatioSplit: shuffled train/val/test split by proportion or count.

A copy of ``cornac_tpu/eval_methods/ratio_split.py``: the permutation
comes from the same seeded legacy ``RandomState``, so for a seed the
splits and ID maps are byte-identical to the JAX package's, the
``test_size=0`` ``[-0:]`` quirk and fractional absolute sizes included.
"""

import math

from ..utils.common import safe_indexing
from .base_method import BaseMethod


class RatioSplit(BaseMethod):
    """Shuffle the data once, then carve consecutive slices of the permuted
    index vector into train / val / test.

    ``test_size`` / ``val_size`` are proportions when < 1, absolute counts
    otherwise.
    """

    def __init__(
        self,
        data,
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
            rating_threshold=rating_threshold,
            seed=seed,
            exclude_unknowns=exclude_unknowns,
            verbose=verbose,
            **kwargs,
        )

        n_total = kwargs.get("data_size", len(data))
        sizes = self.validate_size(val_size, test_size, n_total)
        self.train_size, self.val_size, self.test_size = sizes
        self._split()

    @staticmethod
    def validate_size(val_size, test_size, data_size):
        """Resolve the two held-out sizes into integer ``(train, val, test)``
        counts.

        Each requested size goes through the same normalization: ``None``
        means zero, a value in ``[0, 1)`` is a fraction of ``data_size``
        (rounded up), and anything >= 1 is taken as an absolute count.
        """
        resolved = {}
        for name, requested in (("val_size", val_size), ("test_size", test_size)):
            if requested is None:
                requested = 0.0
            if requested < 0:
                raise ValueError(f"{name}={requested} cannot be negative")
            if requested >= data_size:
                msg = (
                    f"{name}={requested} must leave room inside "
                    f"data_size={data_size}"
                )
                raise ValueError(msg)
            # fractions round up; absolute sizes stay as given (possibly
            # fractional) until the final int conversion, like the
            # reference — int()-ing early changes the derived train count
            resolved[name] = (
                math.ceil(requested * data_size) if requested < 1 else requested
            )

        held_out = resolved["val_size"] + resolved["test_size"]
        if held_out >= data_size:
            msg = (
                f"held-out total val+test={held_out} must leave at least one "
                f"training interaction out of data_size={data_size}"
            )
            raise ValueError(msg)

        return (
            int(data_size - held_out),
            int(resolved["val_size"]),
            int(resolved["test_size"]),
        )

    def _split(self):
        # one draw from the seeded stream; slice boundaries are cumulative
        # offsets into the permuted index vector
        shuffled = self.rng.permutation(len(self.data))
        # boundaries anchored at the END for test (reference's [-t:] form):
        # with fractional absolute sizes the three counts may not sum to
        # data_size, and any remainder belongs to the middle (val) slice
        cut = len(self.data) - self.test_size
        if self.test_size == 0:
            # reference quirk (ratio_split.py:119-120): the zero-size test
            # slice is data_idx[-0:], i.e. the WHOLE shuffled array, and the
            # val slice [train:-0] collapses to empty — preserved for parity
            test_rows, held_val = shuffled, shuffled[:0]
        else:
            test_rows = shuffled[cut:]
            held_val = shuffled[self.train_size : cut]

        self.build(
            train_data=safe_indexing(self.data, shuffled[: self.train_size]),
            test_data=safe_indexing(self.data, test_rows),
            val_data=safe_indexing(self.data, held_val) if held_val.size else None,
        )
