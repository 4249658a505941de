"""ComparER — Explainable Recommendation with Comparative Constraints on
Product Aspects (Le & Lauw, WSDM 2021).

Port of ``cornac_tpu/models/comparer.py``, two variants on their base
models:

* ``ComparERObj`` (objective aspect quality): EFM plus pairwise
  aspect-quality constraints over chronologically purchased item pairs
  (earlier -> later), folded into EFM's multiplicative updates as extra
  numerator and denominator mass (``efm_iteration``'s ``pairs``); the model
  types Finer, Dominant and Around gate which pairs contribute
  (``_GATE_CODE``).
* ``ComparERSub`` (subjective aspect quality): MTER plus a sampled
  aspect-BPR stream over each user's chronological pairs on the Tucker
  score (``mter_iteration`` with ``n_pair > 0``).

The pair enumeration is host code that gives the JAX package's bytes.
``_chrono_pairs`` is a copy of its loop. ``_build_pairs`` and
``_build_sub_pairs`` compute its skyline loops with numpy, in its order:
the chronological pairs in ``Counter.most_common`` order, the aspects in
the order the loops test them, then a stable sort by count, which is
``most_common``'s order among equal counts.
"""

from collections import Counter
from itertools import combinations

import numpy as np
import torch

from .efm import EFM
from .mter import MTER
from .recommender import Recommender

MODEL_TYPES = {"Dominant": 0, "Around": 1, "Finer": 2}
# the gate codes of efm_iteration (0 = Finer always, 1 = Dominant, 2 = Around)
_GATE_CODE = {"Finer": 0, "Dominant": 1, "Around": 2}


def _chrono_pairs(model, data_set, min_user_freq, enum_window):
    """(user, earlier, later) -> count over each user's chronological
    purchases."""
    pairs = Counter()
    for u_idx, (item_ids, *_) in data_set.chrono_user_data.items():
        if len(item_ids) < min_user_freq:
            continue
        window = (
            len(item_ids) if enum_window is None
            else min(enum_window, len(item_ids))
        )
        subs = [
            item_ids[i : i + window]
            for i in range(len(item_ids) - window + 1)
        ]
        for sub in subs:
            for ei, li in combinations(sub, 2):
                if ei >= model.num_items or li >= model.num_items:
                    continue
                pairs[(u_idx, ei, li)] += 1
    return pairs


def _empty(n):
    return tuple(np.zeros(0, np.int32) for _ in range(n))


def _expand(lo, hi):
    """(owner, position) of every position in each [lo, hi), in order."""
    n = (hi - lo).astype(np.int64)
    owner = np.repeat(np.arange(len(n)), n)
    return owner, np.arange(n.sum()) + np.repeat(lo - (np.cumsum(n) - n), n)


def _sorted_values(K, V, q):
    """V at each key ``q`` of the sorted keys ``K``; 0 where it is absent."""
    if not len(K):
        return np.zeros(len(q))
    at = np.minimum(np.searchsorted(K, q), len(K) - 1)
    return np.where(K[at] == q, V[at], 0.0)


def _csr_values(Y, rows, cols):
    """Y[rows, cols] of a canonical CSR matrix, 0 where not stored."""
    counts = np.diff(Y.indptr)
    keys = np.repeat(np.arange(Y.shape[0], dtype=np.int64), counts) * Y.shape[1] + Y.indices
    return _sorted_values(keys, Y.data, rows * Y.shape[1] + cols)


class ComparERObj(EFM):
    """EFM with comparative constraints on objective aspect quality.
    ``mesh``: EFM's edge split, the pair stream split as the observation
    streams are (``efm.efm_iteration``)."""

    def __init__(
        self,
        name="ComparERObj",
        model_type="Finer",
        num_explicit_factors=128,
        num_latent_factors=128,
        num_most_cared_aspects=100,
        rating_scale=5.0,
        alpha=0.9,
        lambda_x=1,
        lambda_y=1,
        lambda_u=0.01,
        lambda_h=0.01,
        lambda_v=0.01,
        lambda_d=0.01,
        use_item_aspect_popularity=True,
        min_user_freq=2,
        min_pair_freq=1,
        max_pair_freq=1e9,
        min_common_freq=1,
        enum_window=None,
        use_item_pair_popularity=True,
        max_iter=1000,
        num_threads=0,
        early_stopping=None,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        if model_type not in MODEL_TYPES:
            raise ValueError(
                "Invalid model type: {}\nOnly support: {}".format(
                    model_type, list(MODEL_TYPES.keys())
                )
            )
        EFM.__init__(
            self,
            name=name,
            num_explicit_factors=num_explicit_factors,
            num_latent_factors=num_latent_factors,
            num_most_cared_aspects=num_most_cared_aspects,
            rating_scale=rating_scale,
            alpha=alpha,
            lambda_x=lambda_x,
            lambda_y=lambda_y,
            lambda_u=lambda_u,
            lambda_h=lambda_h,
            lambda_v=lambda_v,
            use_item_aspect_popularity=use_item_aspect_popularity,
            max_iter=max_iter,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )
        self.model_type = model_type
        self._gate = _GATE_CODE[model_type]
        self.lambda_d = lambda_d
        self.min_user_freq = min_user_freq
        self.min_pair_freq = min_pair_freq
        self.max_pair_freq = max_pair_freq
        self.min_common_freq = min_common_freq
        self.enum_window = enum_window
        self.use_item_pair_popularity = use_item_pair_popularity
        self.num_threads = num_threads
        self.early_stopping = early_stopping

    def _build_pairs(self, data_set, Y):
        """Skyline aspect pairs: (early, late, aspect, frequency) arrays."""
        chrono = Counter()
        for (u, ei, li), c in _chrono_pairs(
            self, data_set, self.min_user_freq, self.enum_window
        ).items():
            chrono[(ei, li)] += c

        if not chrono:
            return _empty(3) + (np.zeros(0, np.float32),)
        (pairs, counts) = zip(*chrono.most_common())
        E, L = np.asarray(pairs, np.int64).T
        C = np.asarray(counts, np.int64)
        # every (pair, aspect of the later item's row, in the row's order):
        # the JAX package's loop over ``Y[li].indices``
        Y = Y.tocsr()
        if not Y.has_canonical_format:
            raise ValueError("Y must be a canonical CSR matrix (as _build_matrices makes it)")
        P, pos = _expand(Y.indptr[L], Y.indptr[L + 1])
        k = Y.indices[pos].astype(np.int64)
        lv = Y.data[pos]
        ev = _csr_values(Y, E[P], k)
        # common[(ei, li)]: the aspects both items score above 0
        common = np.bincount(P, weights=(ev > 0) & (lv > 0), minlength=len(C))
        keep = lv > ev  # pair_counts' keys, in their insertion order
        P, k = P[keep], k[keep]
        cnt = C[P]
        order = np.argsort(-cnt, kind="stable")  # most_common(): stable, by count
        P, k, cnt = P[order], k[order], cnt[order]
        ok = ((common[P] >= self.min_common_freq) & (cnt >= self.min_pair_freq)
              & (cnt <= self.max_pair_freq))
        return (E[P[ok]].astype(np.int32), L[P[ok]].astype(np.int32), k[ok].astype(np.int32),
                cnt[ok].astype(np.float32))

    def _pairs(self, train_set, Y, dev):
        """The comparative pair stream of ``efm_iteration`` on ``dev``:
        (early, late, aspect, weight); with no usable pair, one pair of
        weight 0, as in the JAX package."""
        p_early, p_late, p_asp, p_freq = self._build_pairs(train_set, Y)
        if not self.use_item_pair_popularity:
            p_freq = np.ones_like(p_freq)
        p_w = self.lambda_d * (1.0 + np.log(np.maximum(p_freq, 1.0)))
        if len(p_early) == 0:  # no usable pairs: plain EFM
            p_early = p_late = np.zeros(1, np.int32)
            p_asp = np.zeros(1, np.int32)
            p_w = np.zeros(1, np.float32)
        return tuple(torch.as_tensor(np.asarray(a, np.int64), device=dev)
                     for a in (p_early, p_late, p_asp)) + (
            torch.as_tensor(np.asarray(p_w, np.float32), device=dev),)

    def get_params(self):
        return {
            "U1": self.U1, "U2": self.U2, "V": self.V,
            "H1": self.H1, "H2": self.H2,
        }

    def monitor_value(self, train_set=None, val_set=None):
        val_set = val_set if val_set is not None else getattr(self, "val_set", None)
        if val_set is None:
            return None
        u, i, r = val_set.uir_tuple
        ok = (u < self.num_users) & (i < self.num_items)
        U1, U2, _, H1, H2 = self._on_device()
        uu = torch.as_tensor(np.asarray(u[ok], np.int64), device=U1.device)
        ii = torch.as_tensor(np.asarray(i[ok], np.int64), device=U1.device)
        pred = torch.sum(U1[uu] * U2[ii], 1) + torch.sum(H1[uu] * H2[ii], 1)
        r_ok = torch.as_tensor(np.asarray(r[ok], np.float64), device=U1.device)
        return -float(torch.sum((pred - r_ok) ** 2))


class ComparERSub(MTER):
    """MTER with comparative constraints on subjective aspect quality.
    ``mesh``: MTER's split of the sampled streams, the pair samples split as
    the others are (``mter.mter_iteration``)."""

    def __init__(
        self,
        name="ComparERSub",
        rating_scale=5.0,
        n_user_factors=8,
        n_item_factors=8,
        n_aspect_factors=8,
        n_opinion_factors=8,
        n_pair_samples=1000,
        n_bpr_samples=1000,
        n_element_samples=50,
        n_top_aspects=100,
        alpha=0.5,
        min_user_freq=2,
        min_pair_freq=1,
        min_common_freq=1,
        use_item_aspect_popularity=True,
        enum_window=None,
        lambda_reg=0.1,
        lambda_bpr=10,
        lambda_d=0.01,
        max_iter=200000,
        lr=0.1,
        n_threads=0,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        MTER.__init__(
            self,
            name=name,
            rating_scale=rating_scale,
            n_user_factors=n_user_factors,
            n_item_factors=n_item_factors,
            n_aspect_factors=n_aspect_factors,
            n_opinion_factors=n_opinion_factors,
            n_bpr_samples=n_bpr_samples,
            n_element_samples=n_element_samples,
            lambda_reg=lambda_reg,
            lambda_bpr=lambda_bpr,
            max_iter=max_iter,
            lr=lr,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )
        self.n_pair_samples = n_pair_samples
        self.n_top_aspects = n_top_aspects
        self.alpha = alpha
        self.min_user_freq = min_user_freq
        self.min_pair_freq = min_pair_freq
        self.min_common_freq = min_common_freq
        # inert, as in the JAX package: the item-quality values are always
        # above 1, so the pair filter reduces to aspect presence
        self.use_item_aspect_popularity = use_item_aspect_popularity
        self.enum_window = enum_window
        self.lambda_d = lambda_d
        self.n_threads = n_threads

    def _build_sub_pairs(self, data_set, user_item_aspect):
        """Per-user skyline aspect pairs from per-user subjective aspect
        scores: (user, early, late, aspect) arrays."""
        chrono = _chrono_pairs(self, data_set, self.min_user_freq, self.enum_window)

        if not chrono:
            return _empty(4)
        (triples, counts) = zip(*chrono.most_common())
        U, E, L = np.asarray(triples, np.int64).T
        C = np.asarray(counts, np.int64)
        A = self.num_aspects
        keys = [k for k in user_item_aspect if k[2] != A]
        if not keys:
            return _empty(4)
        ku, ki, ka = np.asarray(keys, np.int64).T
        kv = np.asarray([user_item_aspect[k] for k in keys], np.float64)
        # item-level aspect presence for the common-aspect filter
        present = np.zeros((max(self.num_items, ki.max() + 1), ka.max() + 1), bool)
        present[ki, ka] = True
        # each (user, item)'s scores of the aspects in range(num_aspects),
        # by one sorted key
        inside = ka < A
        n_i = present.shape[0]
        K = (ku[inside] * n_i + ki[inside]) * A + ka[inside]
        order = np.argsort(K, kind="stable")
        K, V = K[order], kv[inside][order]

        def scores_of(base, a):
            return _sorted_values(K, V, base + a)

        # the JAX package tests every aspect in range(num_aspects); where
        # neither item has a score both read 0 and 0 > 0 fails, so the
        # aspects either item scores give the same counts
        base_l, base_e = (U * n_i + L) * A, (U * n_i + E) * A
        Pl, pos = _expand(np.searchsorted(K, base_l), np.searchsorted(K, base_l + A))
        al = K[pos] - base_l[Pl]
        lv_l, ev_l = V[pos], scores_of(base_e[Pl], al)
        Pe, pos = _expand(np.searchsorted(K, base_e), np.searchsorted(K, base_e + A))
        ae = K[pos] - base_e[Pe]
        only_e = ~np.isin(base_l[Pe] + ae, K)
        Pe, ae, ev_e = Pe[only_e], ae[only_e], V[pos][only_e]
        P = np.concatenate([Pl, Pe])
        a = np.concatenate([al, ae])
        keep = np.concatenate([lv_l > ev_l, 0.0 > ev_e])
        P, a = P[keep], a[keep]
        order = np.lexsort((a, P))  # pair_counts' insertion order: chrono's, then the aspect
        P, a = P[order], a[order]
        cnt = C[P]
        order = np.argsort(-cnt, kind="stable")  # most_common(): stable, by count
        P, a, cnt = P[order], a[order], cnt[order]
        common = (present[E[P]] & present[L[P]]).sum(1)
        ok = (common >= self.min_common_freq) & (cnt >= self.min_pair_freq)
        P = P[ok]
        return (U[P].astype(np.int32), E[P].astype(np.int32), L[P].astype(np.int32),
                a[ok].astype(np.int32))

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        self._init(train_set)
        self._tables = None
        if not self.trainable:
            return self
        dev = self._device()
        rating_matrix, uia, uao, iao = self._build_data(train_set)
        pairs = self._build_sub_pairs(train_set, uia)
        n_pair = self.n_pair_samples if len(pairs[0]) else 0
        if len(pairs[0]) == 0:
            pairs = (np.zeros(1, np.int32),) * 4
        data = self._device_data(train_set, rating_matrix, uia, uao, iao, pairs, dev)
        self._fit_sampled(data, dev, n_pair=n_pair, ld_d=self.lambda_d)
        return self
