"""Carry a fitted JAX-package model into the port as plain arrays.

The port never unpickles a ``cornac_tpu`` pickle (that would import the
JAX package): the caller reads the fitted attributes out as numpy arrays
and plain values, and the port rebuilds its own model from them.
"""

from collections import OrderedDict

import numpy as np
from scipy.sparse import csr_matrix

from .models.baseline import BaselineOnly
from .models.bpr import BPR
from .models.knn import ItemKNN, UserKNN
from .models.mf import MF

_SNAPSHOT = (
    "num_users", "num_items", "uid_map", "iid_map",
    "min_rating", "max_rating", "global_mean",
)
_BPR_META = ("k", "use_bias") + _SNAPSHOT
_MF_META = ("k", "use_bias") + _SNAPSHOT
_KNN_OPTIONS = ("k", "similarity", "mean_centered", "weighting", "amplify")
_KNN_CLASSES = {"UserKNN": UserKNN, "ItemKNN": ItemKNN}


def _require(meta, names):
    missing = [name for name in names if name not in meta]
    if missing:
        raise KeyError(f"meta lacks {missing}")


def _snapshot(model, meta):
    """Set the train-set statistics ``fit`` captures, from ``meta``."""
    model.reset_info()
    for name in _SNAPSHOT:
        value = meta[name]
        setattr(model, name, OrderedDict(value) if name.endswith("_map") else value)


def bpr_from_arrays(arrays, meta, device=None, train_set=None):
    """A fitted port ``BPR`` from ``arrays`` (``u_factors``, ``i_factors``,
    ``i_biases`` as numpy) and ``meta`` (``k``, ``use_bias``, ``num_users``,
    ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``, ``max_rating``,
    ``global_mean``). ``device``: where the model scores (default: the
    card). ``train_set``: the port ``Dataset`` it was fitted on, kept as
    the model's ``train_set`` as ``fit`` keeps it (wrapping the model in an
    ANN index needs it)."""
    _require(meta, _BPR_META)
    model = BPR(
        k=meta["k"], use_bias=meta["use_bias"], trainable=False,
        init_params={
            "U": np.asarray(arrays["u_factors"], np.float32),
            "V": np.asarray(arrays["i_factors"], np.float32),
            "Bi": np.asarray(arrays["i_biases"], np.float32),
        },
        device=device,
    )
    _snapshot(model, meta)
    model.train_set, model.val_set = train_set, None
    model.is_fitted = True
    return model


def mf_from_arrays(arrays, meta, device=None):
    """A fitted port ``MF`` from ``arrays`` (``u_factors``, ``i_factors``,
    ``u_biases``, ``i_biases`` as numpy) and ``meta`` (``k``, ``use_bias``,
    ``num_users``, ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``,
    ``max_rating``, ``global_mean``). ``global_mean`` is the fitted model's
    (0 without the biases). ``device``: where the model scores (default:
    the card)."""
    _require(meta, _MF_META)
    model = MF(
        k=meta["k"], use_bias=meta["use_bias"], trainable=False,
        init_params={name: np.asarray(arrays[key], np.float32) for name, key in (
            ("U", "u_factors"), ("V", "i_factors"), ("Bu", "u_biases"), ("Bi", "i_biases"))},
        device=device,
    )
    _snapshot(model, meta)
    model.global_mean = np.float32(meta["global_mean"])
    model.train_set = model.val_set = None
    model.is_fitted = True
    return model


def baseline_from_arrays(arrays, meta, device=None):
    """A fitted port ``BaselineOnly`` from ``arrays`` (``u_biases``,
    ``i_biases`` as numpy) and ``meta`` (``num_users``, ``num_items``,
    ``uid_map``, ``iid_map``, ``min_rating``, ``max_rating``,
    ``global_mean``). ``device``: where the model scores (default: the
    card)."""
    _require(meta, _SNAPSHOT)
    model = BaselineOnly(
        trainable=False, device=device,
        init_params={"Bu": np.asarray(arrays["u_biases"], np.float32),
                     "Bi": np.asarray(arrays["i_biases"], np.float32)},
    )
    _snapshot(model, meta)
    model.train_set = model.val_set = None
    model.is_fitted = True
    return model


def knn_from_arrays(cls_name, arrays, meta, device=None):
    """A fitted port ``UserKNN`` or ``ItemKNN`` (``cls_name``) from
    ``arrays`` (numpy: ``sim_mat``, ``ui_centered``, ``mean_arr``, and the
    weight matrix as CSR ``data``, ``indices``, ``indptr``, ``shape``) and
    ``meta`` (the constructor options ``k``, ``similarity``,
    ``mean_centered``, ``weighting``, ``amplify``, then ``num_users``,
    ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``,
    ``max_rating``, ``global_mean``). It scores and answers ``neighbors``
    as the model it was read from. ``device``: where the model scores
    (default: the card)."""
    if cls_name not in _KNN_CLASSES:
        raise ValueError(f"cls_name must be one of {sorted(_KNN_CLASSES)}, got {cls_name!r}")
    _require(meta, _KNN_OPTIONS + _SNAPSHOT)
    model = _KNN_CLASSES[cls_name](
        verbose=False, device=device, **{name: meta[name] for name in _KNN_OPTIONS}
    )
    _snapshot(model, meta)
    model.sim_mat = np.asarray(arrays["sim_mat"], dtype=np.float64)
    model.ui_centered = np.asarray(arrays["ui_centered"], dtype=np.float64)
    model.mean_arr = np.asarray(arrays["mean_arr"], dtype=np.float64)
    model._weight_mat = csr_matrix(
        (np.asarray(arrays["data"]), np.asarray(arrays["indices"]), np.asarray(arrays["indptr"])),
        shape=tuple(arrays["shape"]),
    )
    model.train_set = model.val_set = None
    model.is_fitted = True
    return model
