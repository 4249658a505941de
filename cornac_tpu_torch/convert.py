"""Carry a fitted JAX-package model into the port as plain arrays.

The port never unpickles a ``cornac_tpu`` pickle (that would import the
JAX package): the caller reads the fitted attributes out as numpy arrays
and plain values, and the port rebuilds its own model from them.
"""

from collections import OrderedDict

import numpy as np

from .models.bpr import BPR

_BPR_META = (
    "k", "use_bias", "num_users", "num_items", "uid_map", "iid_map",
    "min_rating", "max_rating", "global_mean",
)


def bpr_from_arrays(arrays, meta, device=None, train_set=None):
    """A fitted port ``BPR`` from ``arrays`` (``u_factors``, ``i_factors``,
    ``i_biases`` as numpy) and ``meta`` (``k``, ``use_bias``, ``num_users``,
    ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``, ``max_rating``,
    ``global_mean``). ``device``: where the model scores (default: the
    card). ``train_set``: the port ``Dataset`` it was fitted on, kept as
    the model's ``train_set`` as ``fit`` keeps it (wrapping the model in an
    ANN index needs it)."""
    missing = [name for name in _BPR_META if name not in meta]
    if missing:
        raise KeyError(f"meta lacks {missing}")
    model = BPR(
        k=meta["k"], use_bias=meta["use_bias"], trainable=False,
        init_params={
            "U": np.asarray(arrays["u_factors"], np.float32),
            "V": np.asarray(arrays["i_factors"], np.float32),
            "Bi": np.asarray(arrays["i_biases"], np.float32),
        },
        device=device,
    )
    model.reset_info()
    for name in _BPR_META[2:]:
        value = meta[name]
        setattr(model, name, OrderedDict(value) if name.endswith("_map") else value)
    model.train_set, model.val_set = train_set, None
    model.is_fitted = True
    return model
