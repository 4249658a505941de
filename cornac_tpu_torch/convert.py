"""Carry a fitted JAX-package model into the port as plain arrays.

The port never unpickles a ``cornac_tpu`` pickle (that would import the
JAX package): the caller reads the fitted attributes out as numpy arrays
and plain values, and the port rebuilds its own model from them.
"""

from collections import OrderedDict

import numpy as np
import torch
from scipy.sparse import csr_matrix

from .device import resolve_device
from .engine.nn import Dense, Tree
from .models.baseline import BaselineOnly
from .models.bpr import BPR, WBPR
from .models.c2pf import C2PF
from .models.cvaecf import CVAECF
from .models.ease import EASE
from .models.fm import FM
from .models.fpmc import FPMC
from .models.gcmc import GCMC
from .models.gru4rec import GRU4Rec
from .models.hpf import HPF
from .models.ibpr import COE, IBPR, OnlineIBPR
from .models.knn import ItemKNN, UserKNN
from .models.mf import MF
from .models.nmf import NMF
from .models.pmf import PMF
from .models.sansa import SANSA
from .models.sasrec import SASRec
from .models.sbpr import SBPR
from .models.skm import SKMeans
from .models.vebpr import VEBPR
from .models.wmf import WMF

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


_BPR_CLASSES = {"BPR": BPR, "WBPR": WBPR, "SBPR": SBPR, "VEBPR": VEBPR}


def bpr_from_arrays(arrays, meta, device=None, train_set=None, cls_name="BPR"):
    """A fitted port ``BPR`` from ``arrays`` (``u_factors``, ``i_factors``,
    ``i_biases`` as numpy) and ``meta`` (``k``, ``use_bias``, ``num_users``,
    ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``, ``max_rating``,
    ``global_mean``). ``device``: where the model scores (default: the
    card). ``train_set``: the port ``Dataset`` it was fitted on, kept as
    the model's ``train_set`` as ``fit`` keeps it (wrapping the model in an
    ANN index needs it). ``cls_name``: the BPR family's class to build,
    ``"BPR"``, ``"WBPR"``, ``"SBPR"`` or ``"VEBPR"`` (which scores without
    a bias: its ``i_biases`` are the zeros the JAX package keeps)."""
    if cls_name not in _BPR_CLASSES:
        raise ValueError(f"cls_name must be one of {sorted(_BPR_CLASSES)}, got {cls_name!r}")
    _require(meta, _BPR_META)
    init = {
        "U": np.asarray(arrays["u_factors"], np.float32),
        "V": np.asarray(arrays["i_factors"], np.float32),
        "Bi": np.asarray(arrays["i_biases"], np.float32),
    }
    kwargs = dict(k=meta["k"], trainable=False, init_params=init, device=device)
    if cls_name != "VEBPR":
        kwargs["use_bias"] = meta["use_bias"]
    model = _BPR_CLASSES[cls_name](**kwargs)
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


# class name -> (class, the fitted arrays it keeps, the options it is built with)
_FACTOR_MODELS = {
    "PMF": (PMF, ("U", "V"), ("k", "variant")),
    "WMF": (WMF, ("U", "V"), ("k",)),
    "IBPR": (IBPR, ("U", "V"), ("k",)),
    "OnlineIBPR": (OnlineIBPR, ("U", "V"), ("k",)),
    "COE": (COE, ("U", "V"), ("k",)),
    "NMF": (NMF, ("u_factors", "i_factors", "u_biases", "i_biases"), ("k", "use_bias")),
    "EASE": (EASE, ("B",), ("lamb", "posB")),
    "HPF": (HPF, ("Theta", "Beta"), ("k", "hierarchical")),
    "SKMeans": (SKMeans, ("centroids", "user_center_sim"), ("k",)),
    "FM": (FM, ("w0", "w", "V"), ("k0", "k1", "k2", "method")),
}


def factor_model_from_arrays(cls_name, arrays, meta, device=None):
    """A fitted port ``PMF``, ``NMF``, ``WMF``, ``EASE``, ``IBPR``,
    ``OnlineIBPR``, ``COE``, ``HPF``, ``SKMeans`` or ``FM`` (``cls_name``)
    from ``arrays`` (numpy, under the model's own attribute names: ``U``,
    ``V`` for PMF, WMF and the triplet models; ``u_factors``,
    ``i_factors``, ``u_biases``, ``i_biases`` for NMF; ``B`` for EASE, with
    its user rows as CSR ``data``, ``indices``, ``indptr``, ``shape``;
    ``Theta``, ``Beta`` for HPF; ``centroids``, ``user_center_sim`` for
    SKMeans; ``w0``, ``w``, ``V`` for FM) and ``meta`` (the options ``k``
    and ``variant`` (PMF), ``k`` and ``use_bias`` (NMF), ``lamb`` and
    ``posB`` (EASE), ``k`` and ``hierarchical`` (HPF), ``k0``, ``k1``,
    ``k2`` and ``method`` (FM), ``k`` (the others), then ``num_users``, ``num_items``,
    ``uid_map``, ``iid_map``, ``min_rating``, ``max_rating``,
    ``global_mean``, the fitted model's). It scores as the model it was read
    from. ``device``: where the model scores (default: the card)."""
    if cls_name not in _FACTOR_MODELS:
        raise ValueError(f"cls_name must be one of {sorted(_FACTOR_MODELS)}, got {cls_name!r}")
    cls, names, options = _FACTOR_MODELS[cls_name]
    _require(meta, options + _SNAPSHOT)
    model = cls(trainable=False, device=device, **{name: meta[name] for name in options})
    _snapshot(model, meta)
    for name in names:
        setattr(model, name, np.asarray(arrays[name]))
    if cls_name == "EASE":
        model.U = _csr(arrays)
    if cls_name == "FM":
        model.w0 = float(model.w0)
    model.train_set = model.val_set = None
    model.is_fitted = True
    return model


_C2PF_TABLES = ("G_s", "G_r", "L_s", "L_r", "L2_s", "L2_r", "L3_s", "L3_r")


def c2pf_from_arrays(arrays, meta, device=None):
    """A fitted port ``C2PF`` from ``arrays`` (numpy: the Gamma tables
    ``G_s``, ``G_r``, ``L_s``, ``L_r``, ``L2_s``, ``L2_r``, the context
    edges' ``L3_s``, ``L3_r``, and ``Theta``, ``Beta``, ``Xi``) and ``meta``
    (``k``, ``variant``, then ``num_users``, ``num_items``, ``uid_map``,
    ``iid_map``, ``min_rating``, ``max_rating``, ``global_mean``). It scores
    and recommends as the model it was read from. ``device``: where the model scores (default: the card)."""
    _require(meta, ("k", "variant") + _SNAPSHOT)
    init = {name: np.asarray(arrays[name], np.float32) for name in _C2PF_TABLES}
    init.update({name: np.asarray(arrays[name]) for name in ("Theta", "Beta", "Xi")})
    model = C2PF(k=meta["k"], variant=meta["variant"], trainable=False, init_params=init,
                 device=device)
    _snapshot(model, meta)
    model.train_set = model.val_set = None
    model.is_fitted = True
    return model


def _csr(arrays, prefix=""):
    return csr_matrix(
        (np.asarray(arrays[prefix + "data"]), np.asarray(arrays[prefix + "indices"]),
         np.asarray(arrays[prefix + "indptr"])), shape=tuple(arrays[prefix + "shape"]))


def sansa_from_arrays(arrays, meta, device=None):
    """A fitted port ``SANSA`` from ``arrays`` (numpy: the factors ``W1``
    and ``W2`` and the user rows ``U`` of the train set, each as CSR
    ``<name>_data``, ``<name>_indices``, ``<name>_indptr``,
    ``<name>_shape``) and ``meta`` (``use_absolute_value_scores``, then
    ``num_users``, ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``,
    ``max_rating``, ``global_mean``). It scores as the model it was read
    from. ``device``: where the model scores (default: the card)."""
    _require(meta, ("use_absolute_value_scores",) + _SNAPSHOT)
    model = SANSA(trainable=False, verbose=False, device=device,
                  use_absolute_value_scores=meta["use_absolute_value_scores"])
    _snapshot(model, meta)
    model.weights = (_csr(arrays, "W1_"), _csr(arrays, "W2_"))
    model.U = _csr(arrays, "U_")
    model.X = model.U.astype(np.float32)
    model.train_set = model.val_set = None
    model.is_fitted = True
    return model


# class name -> (class, the options it is built with)
_PARAM_MODELS = {
    "FPMC": (FPMC, ("embedding_dim",)),
    "GRU4Rec": (GRU4Rec, ("layers", "max_len", "embedding", "constrained_embedding")),
    "SASRec": (SASRec, ("embedding_dim", "max_len", "num_blocks", "num_heads", "use_pos_emb",
                        "use_biases")),
    "CVAECF": (CVAECF, ("z_dim", "h_dim", "autoencoder_structure", "act_fn", "likelihood")),
    "GCMC": (GCMC, ("activation_func", "gcn_agg_accum")),
}


def model_from_params(cls_name, params, meta, device=None, train_set=None):
    """A fitted port ``FPMC``, ``GRU4Rec``, ``SASRec``, ``CVAECF`` or
    ``GCMC`` (``cls_name``) from the JAX model's ``params`` pytree as
    nested dicts and lists of numpy arrays (FPMC's four tables ``V_UI``,
    ``V_IU``, ``V_IL``, ``V_LI``; the others as ``params_to_module`` takes
    them) and ``meta`` (the options ``embedding_dim`` (FPMC); ``layers``,
    ``max_len``, ``embedding``, ``constrained_embedding`` (GRU4Rec);
    ``embedding_dim``, ``max_len``, ``num_blocks``, ``num_heads``,
    ``use_pos_emb``, ``use_biases`` (SASRec); ``z_dim``, ``h_dim``,
    ``autoencoder_structure``, ``act_fn``, ``likelihood`` (CVAECF);
    ``activation_func``, ``gcn_agg_accum`` (GCMC); then ``num_users``,
    ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``,
    ``max_rating``, ``global_mean``, the fitted model's). CVAECF and GCMC
    also need ``train_set``, the port dataset the model was fitted on
    (CVAECF's rating and social rows, GCMC's rating graph, whose node
    features are computed here). It scores as the model it was read from.
    ``device``: where the model scores (default: the card)."""
    if cls_name not in _PARAM_MODELS:
        raise ValueError(f"cls_name must be one of {sorted(_PARAM_MODELS)}, got {cls_name!r}")
    cls, options = _PARAM_MODELS[cls_name]
    _require(meta, options + _SNAPSHOT)
    if cls_name in ("CVAECF", "GCMC") and train_set is None:
        raise ValueError(f"{cls_name} needs the train_set it was fitted on")
    model = cls(trainable=False, device=device, **{name: meta[name] for name in options})
    _snapshot(model, meta)
    dev = resolve_device(device)
    if cls_name == "FPMC":
        model.params = {name: torch.as_tensor(np.asarray(params[name], np.float32), device=dev)
                        for name in ("V_UI", "V_IU", "V_IL", "V_LI")}
    else:
        model.params = params_to_module(params, dev)
    if cls_name == "CVAECF":
        model.r_mat = train_set.matrix
        n_users = model.r_mat.shape[0]
        model.u_adj_mat = train_set.user_graph.matrix[:n_users, :n_users]
    if cls_name == "GCMC":
        model.graph = model._build_graph(train_set, dev)
        model._refresh_embeddings()
    model.train_set = train_set
    model.val_set = None
    model.is_fitted = True
    return model


def optimizer_state_from_arrays(state, device=None):
    """The state of an ``ops.optim`` optimizer from an optax state given as
    nested dicts of numpy arrays under optax's field names: ``{"count",
    "mu", "nu"}`` (adam), ``{"nu"}`` (rmsprop), ``{"sum_of_squares"}``
    (adagrad), ``{}`` (sgd); each moment a dict keyed as the parameters.
    ``device``: where the tensors go (default: the card)."""
    dev = resolve_device(device)

    def convert(value):
        if isinstance(value, dict):
            return {key: convert(v) for key, v in value.items()}
        return torch.as_tensor(np.array(value), device=dev)

    return convert(state)


def params_to_module(tree, device=None):
    """The port's module for a neural model's JAX parameters given as
    nested dicts and lists of numpy arrays (``VAECF.params``,
    ``RecVAE.enc`` and ``.dec``, ``BiVAECF``'s sides, the NCF family's and
    LightGCN/NGCF's ``params``): a ``{"w", "b"}`` dict becomes a ``Dense``
    layer, another dict a ``Tree`` of its entries, a list of layers a
    ``ModuleList``, a list of arrays a ``ParameterList``, an array a
    parameter; so ``encoder.0.w`` names ``tree["encoder"][0]["w"]``, as in
    the modules the port's models build. ``device``: where the parameters
    go (default: the card)."""
    dev = resolve_device(device)
    return _module_of(tree).to(dev)


def _module_of(tree):
    if isinstance(tree, dict):
        if set(tree) == {"w", "b"}:
            return Dense(np.asarray(tree["w"]), np.asarray(tree["b"]))
        return Tree(**{name: _child(v) for name, v in tree.items()})
    if _is_layer_list(tree):
        return torch.nn.ModuleList(_module_of(v) for v in tree)
    raise TypeError(f"expected nested dicts and lists of arrays, got {type(tree).__name__}")


def _is_layer_list(value):
    return isinstance(value, (list, tuple)) and all(isinstance(v, dict) for v in value)


def _child(value):
    if isinstance(value, dict) or _is_layer_list(value):
        return _module_of(value)
    if isinstance(value, (list, tuple)):
        return [np.asarray(a) for a in value]
    return np.asarray(value)
