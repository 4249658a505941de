"""Carry a fitted JAX-package model into the port as plain arrays.

The port never unpickles a ``cornac_tpu`` pickle (that would import the
JAX package): the caller reads the fitted attributes out as numpy arrays
and plain values, and the port rebuilds its own model from them.
"""

from collections import OrderedDict

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse import csr_matrix

from .device import resolve_device
from .engine.nn import Dense, Tree
from .models.baseline import BaselineOnly
from .models.beacon import Beacon
from .models.bpr import BPR, WBPR
from .models.c2pf import C2PF
from .models.causalrec import CausalRec
from .models.cdl import CDL
from .models.comparer import ComparERObj, ComparERSub
from .models.companion import Companion
from .models.convmf import ConvMF
from .models.ctr import CTR
from .models.cvae import CDR, CVAE
from .models.cvaecf import CVAECF
from .models.dmrl import DMRL
from .models.dnntsp import DNNTSP
from .models.ease import EASE
from .models.efm import EFM
from .models.fm import FM
from .models.fpmc import FPMC
from .models.gcmc import GCMC
from .models.gru4rec import GRU4Rec
from .models.hft import HFT
from .models.hpf import HPF
from .models.hrdr import HRDR
from .models.hypar import HypAR
from .models.ibpr import COE, IBPR, OnlineIBPR
from .models.knn import ItemKNN, UserKNN
from .models.lrppm import LRPPM
from .models.mcf import MCF
from .models.mf import MF
from .models.mter import MTER
from .models.narre import NARRE
from .models.nmf import NMF
from .models.pcrl import PCRL
from .models.pmf import PMF
from .models.recommender import Recommender
from .models.review_utils import flatten
from .models.sansa import SANSA
from .models.sasrec import SASRec
from .models.sbpr import SBPR
from .models.skm import SKMeans
from .models.sorec import SoRec
from .models.tiger import TIGER
from .models.transformer_rec import TransformerRec
from .models.trirank import TriRank
from .models.vbpr import AMR, VBPR
from .models.vebpr import VEBPR
from .models.vmf import VMF
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
    "Beacon": (Beacon, ("emb_dim", "rnn_unit", "alpha", "rnn_cell_type", "nb_hop",
                        "max_seq_length")),
    "DNNTSP": (DNNTSP, ("emb_dim", "loss_type")),
    "TransformerRec": (TransformerRec, ("backbone", "objective", "loss_at", "embedding_dim",
                                        "max_len", "num_blocks", "num_heads")),
    "TIGER": (TIGER, ("tokenizer", "rqvae_num_levels", "rqvae_codebook_size", "d_model", "d_ff",
                      "num_heads", "d_kv", "num_enc_layers", "num_dec_layers", "max_len",
                      "scoring", "n_beams")),
}
# the side-information models: class name -> (class, the options it is
# built with); their ``params`` are the JAX model's ``init_params`` names
# (DMRL's and PCRL's: their ``params`` pytrees)
_SIDE_MODELS = {
    "SoRec": (SoRec, ("k",)),
    "MCF": (MCF, ("k",)),
    "VBPR": (VBPR, ("k", "k2")),
    "AMR": (AMR, ("k", "k2")),
    "CausalRec": (CausalRec, ("k", "k2", "tanh", "lambda_2")),
    "VMF": (VMF, ("k", "d")),
    "DMRL": (DMRL, ("embedding_dim", "num_factors", "num_neg")),
    "PCRL": (PCRL, ("k", "z_dims")),
}
_PARAM_MODELS.update(_SIDE_MODELS)
# the text and review models: class name -> (class, the options it is built
# with); ``params`` are NARRE's and HRDR's JAX ``params`` pytrees, CDL's,
# CDR's, CVAE's and CTR's U and V, ConvMF's U, V, theta and its ``cnn``
# pytree, HFT's alpha, beta_u, beta_i, gamma_u and gamma_i
_REVIEW_OPTIONS = ("embedding_size", "id_embedding_size", "n_factors", "attention_size",
                   "kernel_sizes", "n_filters", "max_text_length", "max_num_review")
_TEXT_MODELS = {
    "NARRE": (NARRE, _REVIEW_OPTIONS),
    "HRDR": (HRDR, _REVIEW_OPTIONS + ("n_user_mlp_factors", "n_item_mlp_factors")),
    "CDL": (CDL, ("k",)),
    "CDR": (CDR, ("k",)),
    "CVAE": (CVAE, ("z_dim",)),
    "CTR": (CTR, ("k",)),
    "ConvMF": (ConvMF, ("k", "filter_sizes")),
    "HFT": (HFT, ("k",)),
}
_PARAM_MODELS.update(_TEXT_MODELS)
# the sentiment and explainable models: class name -> (class, the options it
# is built with); ``params`` are the JAX model's ``init_params`` names
# (HypAR's: its ``params`` pytree)
_SENTIMENT_MODELS = {
    "EFM": (EFM, ("num_explicit_factors", "num_latent_factors", "num_most_cared_aspects",
                  "rating_scale", "alpha")),
    "ComparERObj": (ComparERObj, ("num_explicit_factors", "num_latent_factors",
                                  "num_most_cared_aspects", "rating_scale", "alpha")),
    "MTER": (MTER, ()),
    "ComparERSub": (ComparERSub, ()),
    "Companion": (Companion, ()),
    "LRPPM": (LRPPM, ("rating_scale", "alpha", "num_top_aspects")),
    "TriRank": (TriRank, ("alpha", "beta", "gamma", "eta_U", "eta_P", "eta_A", "max_iter")),
    "HypAR": (HypAR, ("stemming", "node_dim", "num_heads", "non_linear", "objective",
                      "review_aggregator", "predictor", "preference_module", "combiner",
                      "graph_type", "embedding_type", "learn_explainability",
                      "learn_method")),
}
_PARAM_MODELS.update(_SENTIMENT_MODELS)
# what a model scores with besides its parameters and options: Beacon's
# correlation matrix (scipy sparse), DNNTSP's padded graph sizes (the JAX
# model's ``_train_N`` and ``_train_T``), TIGER's host tables (``rqvae_params``
# None for the rkmeans tokenizer)
_TIGER_TABLES = ("sid_table", "offsets", "enc_token_table", "level_sizes", "prefix_children",
                 "sid_to_item")
_PARAM_EXTRAS = {"Beacon": ("correlation_matrix",), "DNNTSP": ("train_N", "train_T"),
                 "TIGER": _TIGER_TABLES + ("rqvae_params",)}


def model_from_params(cls_name, params, meta, device=None, train_set=None):
    """A fitted port ``FPMC``, ``GRU4Rec``, ``SASRec``, ``CVAECF``,
    ``GCMC``, ``Beacon``, ``DNNTSP``, ``TransformerRec``, ``TIGER``,
    ``SoRec``, ``MCF``, ``VBPR``, ``AMR``, ``CausalRec``, ``VMF``, ``DMRL``
    or ``PCRL`` (``cls_name``) from the JAX model's
    ``params`` pytree as
    nested dicts and lists of numpy arrays (FPMC's four tables ``V_UI``,
    ``V_IU``, ``V_IL``, ``V_LI``; the others as ``params_to_module`` takes
    them) and ``meta`` (the options ``embedding_dim`` (FPMC); ``layers``,
    ``max_len``, ``embedding``, ``constrained_embedding`` (GRU4Rec);
    ``embedding_dim``, ``max_len``, ``num_blocks``, ``num_heads``,
    ``use_pos_emb``, ``use_biases`` (SASRec); ``z_dim``, ``h_dim``,
    ``autoencoder_structure``, ``act_fn``, ``likelihood`` (CVAECF);
    ``activation_func``, ``gcn_agg_accum`` (GCMC); ``emb_dim``,
    ``rnn_unit``, ``alpha``, ``rnn_cell_type``, ``nb_hop``,
    ``max_seq_length`` and the ``correlation_matrix`` (Beacon); ``emb_dim``,
    ``loss_type``, ``train_N``, ``train_T`` (DNNTSP); ``backbone``,
    ``objective``, ``loss_at``, ``embedding_dim``, ``max_len``,
    ``num_blocks``, ``num_heads`` (TransformerRec, also for BERT4Rec); the
    options ``tokenizer``, ``rqvae_num_levels``, ``rqvae_codebook_size``,
    ``d_model``, ``d_ff``, ``num_heads``, ``d_kv``, ``num_enc_layers``,
    ``num_dec_layers``, ``max_len``, ``scoring``, ``n_beams`` and the host
    tables ``sid_table``, ``offsets``, ``enc_token_table``, ``level_sizes``,
    ``prefix_children``, ``sid_to_item`` and ``rqvae_params`` (None for
    rkmeans) (TIGER); then ``num_users``,
    ``num_items``, ``uid_map``, ``iid_map``, ``min_rating``,
    ``max_rating``, ``global_mean``, the fitted model's). The
    side-information models take their JAX ``init_params`` as ``params``:
    ``U``, ``V``, ``Z`` (SoRec, MCF; option ``k``); ``Bi``, ``Gu``, ``Gi``,
    ``Tu``, ``E``, ``Bp`` (VBPR, AMR; ``k``, ``k2``); those and ``E_ind``
    (and ``E2``, ``E_ind2`` at tanh 2) for CausalRec (``k``, ``k2``,
    ``tanh``, ``lambda_2``, and ``mean_feat`` when the fit was given one);
    ``U``, ``V``, ``P``, ``E`` (VMF; ``k``, ``d``); DMRL's ``params`` pytree
    (``embedding_dim``, ``num_factors``, ``num_neg``); ``G_s``, ``G_r``,
    ``L_s``, ``L_r`` (PCRL, which scores with them alone; ``k``,
    ``z_dims``). The text and review models take NARRE's and HRDR's JAX
    ``params`` pytrees (options ``embedding_size``, ``id_embedding_size``,
    ``n_factors``, ``attention_size``, ``kernel_sizes``, ``n_filters``,
    ``max_text_length``, ``max_num_review``; HRDR also
    ``n_user_mlp_factors``, ``n_item_mlp_factors``), ``U`` and ``V`` (CDL,
    CDR, CTR: ``k``; CVAE: ``z_dim``), ``U``, ``V``, ``theta`` and the
    ``cnn`` pytree (ConvMF: ``k``, ``filter_sizes``), ``alpha``,
    ``beta_u``, ``beta_i``, ``gamma_u``, ``gamma_i`` (HFT: ``k``). CVAECF,
    GCMC, VBPR, AMR, CausalRec, VMF, DMRL, NARRE and HRDR also need
    ``train_set``, the port dataset the model was fitted on (CVAECF's rating
    and social rows, GCMC's rating graph, whose node features are computed
    here, the visual models' item features, the review models' reviews,
    over which their towers collapse). The sentiment and explainable models
    take their JAX ``init_params`` names as ``params``: ``U1``, ``U2``,
    ``V``, ``H1``, ``H2`` (EFM, ComparERObj; options
    ``num_explicit_factors``, ``num_latent_factors``,
    ``num_most_cared_aspects``, ``rating_scale``, ``alpha``); ``G1``,
    ``G2``, ``G3``, ``U``, ``I``, ``A``, ``O`` (MTER, ComparERSub,
    Companion); ``U``, ``I``, ``UA``, ``IA`` (LRPPM: ``rating_scale``,
    ``alpha``, ``num_top_aspects``); ``R``, ``X``, ``Y`` (scipy) and ``p``,
    ``a``, ``u`` (TriRank: ``alpha``, ``beta``, ``gamma``, ``eta_U``,
    ``eta_P``, ``eta_A``, ``max_iter``); HypAR its ``params`` pytree, its
    constructor's structural options and ``ao_feats``. All of them need
    ``train_set``. It scores as the model it was read from.
    ``device``: where the model scores (default: the card)."""
    if cls_name not in _PARAM_MODELS:
        raise ValueError(f"cls_name must be one of {sorted(_PARAM_MODELS)}, got {cls_name!r}")
    cls, options = _PARAM_MODELS[cls_name]
    extras = _PARAM_EXTRAS.get(cls_name, ())
    _require(meta, options + extras + _SNAPSHOT)
    if cls_name in ("CVAECF", "GCMC", "VBPR", "AMR", "CausalRec", "VMF", "DMRL", "NARRE",
                    "HRDR") and train_set is None:
        raise ValueError(f"{cls_name} needs the train_set it was fitted on")
    if cls_name in _SIDE_MODELS:
        return _side_model(cls_name, params, meta, device, train_set)
    if cls_name in _TEXT_MODELS:
        return _text_model(cls_name, params, meta, device, train_set)
    if cls_name in _SENTIMENT_MODELS:
        return _sentiment_model(cls_name, params, meta, device, train_set)
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
    if cls_name == "Beacon":
        model.correlation_matrix = meta["correlation_matrix"]
        model._A_dense = None
    if cls_name == "DNNTSP":
        model._train_N, model._train_T = int(meta["train_N"]), int(meta["train_T"])
    if cls_name == "TIGER":
        model.sid_table, model.offsets, model.enc_token_table = (
            np.asarray(meta[name], np.int64) for name in _TIGER_TABLES[:3])
        model.level_sizes = [int(s) for s in meta["level_sizes"]]
        model.prefix_children, model.sid_to_item = meta["prefix_children"], meta["sid_to_item"]
        model.pad_idx = model.total_items
        if meta["rqvae_params"] is not None:
            model.rqvae_params = params_to_module(meta["rqvae_params"], dev)
    model.train_set = train_set
    model.val_set = None
    model.is_fitted = True
    return model


def _side_model(cls_name, params, meta, device, train_set):
    """``model_from_params`` for the side-information models: the model
    built unfitted from ``params``, then the scoring arrays it derives from
    them (VBPR's and CausalRec's projected features, VMF's ``Q``, PCRL's
    Theta and Beta) as its fit derives them."""
    cls, options = _SIDE_MODELS[cls_name]
    kwargs = {name: meta[name] for name in options}
    arrays = {name: np.asarray(a) for name, a in params.items() if not isinstance(a, dict)}
    if cls_name in ("SoRec", "MCF", "VBPR", "AMR", "PCRL"):
        kwargs["init_params"] = arrays
    model = cls(trainable=False, device=device, **kwargs)
    _snapshot(model, meta)
    dev = resolve_device(device)
    feats = (None if train_set is None or train_set.item_image is None
             else np.asarray(train_set.item_image.features, np.float32))
    if cls_name in ("SoRec", "MCF"):
        model.U, model.V, model.Z = (np.asarray(arrays[n], np.float64) for n in ("U", "V", "Z"))
    elif cls_name in ("VBPR", "AMR"):
        model._finalize(torch.as_tensor(feats[: model.total_items], device=dev))
    elif cls_name == "CausalRec":
        F = feats[: model.total_items]
        mean_feat = meta.get("mean_feat")
        mean_feat = (F.mean(axis=0) if mean_feat is None
                     else np.asarray(mean_feat, np.float32)).reshape(1, -1)
        model._store({n: torch.as_tensor(np.asarray(a, np.float32), device=dev)
                      for n, a in arrays.items()}, torch.as_tensor(F, device=dev), mean_feat)
    elif cls_name == "VMF":
        model._store({n: torch.as_tensor(np.asarray(a, np.float32), device=dev)
                      for n, a in arrays.items()}, feats[: model.num_items])
    elif cls_name == "DMRL":
        text, image = model._item_features(train_set)
        model._n_mod = 1 + (text is not None) + (image is not None)
        model._text, model._image = (None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=dev) for a in (text, image))
        flat = {}
        for name, value in params.items():
            if isinstance(value, dict):
                flat.update({f"{name}.{k}": v for k, v in value.items()})
            else:
                flat[name] = value
        model.params = {n: torch.tensor(np.asarray(a, np.float32), device=dev)
                        for n, a in flat.items()}
    else:  # PCRL, whose constructor took G_s, G_r, L_s, L_r
        model.Theta = model.Gs / np.maximum(model.Gr, 1e-10)
        model.Beta = model.Ls / np.maximum(model.Lr, 1e-10)
    model.train_set = train_set
    model.val_set = None
    model.is_fitted = True
    return model


def _text_model(cls_name, params, meta, device, train_set):
    """``model_from_params`` for the text and review models. NARRE and HRDR
    collapse their towers over ``train_set``'s reviews into the factor
    tables as their fit does (HRDR with the population statistics of its
    batch normalisation, kept in ``bn_stats``)."""
    cls, options = _TEXT_MODELS[cls_name]
    kwargs = {name: meta[name] for name in options}
    if cls_name == "HFT":
        kwargs["init_params"] = {n: np.asarray(params[n], np.float64) if n != "alpha"
                                 else float(params[n]) for n in (
                                     "alpha", "beta_u", "beta_i", "gamma_u", "gamma_i")}
    model = cls(trainable=False, verbose=False, device=device, **kwargs)
    _snapshot(model, meta)
    dev = resolve_device(device)
    if cls_name in ("NARRE", "HRDR"):
        model.params = {n: torch.as_tensor(np.asarray(a, np.float32), device=dev)
                        for n, a in flatten(params).items()}
        model._cache_factors(model._tensors(train_set, dev))
    elif cls_name == "ConvMF":
        model.U, model.V = (np.asarray(params[n], np.float32) for n in ("U", "V"))
        model.theta = np.asarray(params["theta"], np.float32)
        model.cnn = {n: torch.as_tensor(np.asarray(a, np.float32), device=dev)
                     for n, a in flatten(params["cnn"]).items()}
    elif cls_name != "HFT":
        model.U, model.V = (np.asarray(params[n]) for n in ("U", "V"))
    model.train_set = train_set
    model.val_set = None
    model.is_fitted = True
    return model


def _sentiment_model(cls_name, params, meta, device, train_set):
    """``model_from_params`` for the sentiment and explainable models: the
    model built unfitted from its ``init_params`` and fitted with
    ``trainable=False`` on ``train_set``, which builds what it scores with
    besides them (LRPPM's item-aspect quality, TriRank's rating rows, the
    number of aspects), as the JAX model's fit builds it. HypAR builds its
    graphs and takes the JAX model's aspect and opinion features
    (``ao_feats`` in ``meta``; None for learned embeddings)."""
    if train_set is None:
        raise ValueError(f"{cls_name} needs the train_set it was fitted on")
    cls, options = _SENTIMENT_MODELS[cls_name]
    kwargs = {name: meta[name] for name in options}
    if cls_name != "HypAR":
        kwargs["init_params"] = {n: a if sp.issparse(a) else np.asarray(a)
                                 for n, a in params.items()}
    model = cls(verbose=False, device=device, **kwargs)
    model.trainable = False  # TriRank's constructor, as the JAX package's, takes no trainable
    if cls_name == "HypAR":
        Recommender.fit(model, train_set)
        _snapshot(model, meta)
        model._create_graphs(train_set)
        model.net = model.build_net(train_set, params, meta["ao_feats"], resolve_device(device))
        model._cache_inference()
    else:
        model.fit(train_set)
        _snapshot(model, meta)
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
