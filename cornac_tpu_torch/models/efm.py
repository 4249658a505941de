"""EFM — Explicit Factor Model (Zhang et al., SIGIR 2014).

Port of ``cornac_tpu/models/efm.py``. The fit is ``max_iter``
multiplicative updates of the rating matrix A ~ U1 U2ᵀ + H1 H2ᵀ, the
user-aspect attention X ~ U1 Vᵀ and the item-aspect quality Y ~ U2 Vᵀ,
each a plain loop iteration on the model's device. Every numerator and
denominator sum is one ``accumulate_rows`` call (the hand-written kernel on
the card) over the streams' updates of a table, concatenated in the JAX
package's order (ratings, then attention or quality), numerator and
denominator side by side as columns: the same sums in the same order as the
JAX package's chained scatter-adds, and the same bits on every run.
``ComparERObj`` adds its comparative pair stream (``pairs``) to the same
loop.

``mesh`` (``parallel.make_mesh``): edge parallelism, as in the JAX package.
The tables are replicated and every observation stream (and ComparERObj's
pairs) is split over every rank: each rank computes its edges' numerator
and denominator rows, the rows are gathered back in stream order
(``data_parallel`` over every rank), and every rank applies them with the same single
``accumulate_rows`` call a table, so the fit is the single-device fit bit
for bit on every layout. Of ComparERObj's pairs, whose stream can hold tens
of millions of (pair, aspect) entries, the ranks gather each entry's
weight (one number, its sigmoid and gate) and every rank forms the rows
from it. The JAX package pads the streams to a multiple of
the mesh's size with masked rows; the port's slices need no padding.

Ranking uses the paper's composite score over the user's most-cared
aspects, which the JAX package computes on the host in float64; the port
computes it on the model's device in float64 (``_composite_scores``).
"""

from collections import Counter, OrderedDict

import numpy as np
import scipy.sparse as sp
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..parallel.mesh import check_mesh
from ..parallel.sharded import data_parallel
from ..utils import get_rng
from ..utils.init_utils import uniform
from .recommender import Recommender, pad_to_catalog

EPS = 1e-9


def _sums(n_rows, ids, updates):
    """(n_rows, d) sums of ``updates`` by ``ids`` in batch order, from
    zeros: the JAX package's ``zeros.at[ids].add(updates)``."""
    return accumulate_rows(updates.new_zeros((n_rows, updates.shape[1])), ids, updates)


def efm_iteration(tables, streams, counts, lambdas, pairs=None, model_type=0, mesh=None):
    """One multiplicative update of (U1, U2, V, H1, H2), in place.

    ``streams``: ((A_u, A_i, A_v), (X_u, X_a, X_v), (Y_i, Y_a, Y_v)), ids
    int64 and values float32 tensors; ``counts``: (A by user, A by item, X by
    user, X by aspect, Y by item, Y by aspect), float32; ``lambdas``:
    (x, y, u, h, v); ``pairs``: ComparERObj's (early, late, aspect, weight)
    or None; ``model_type``: its gate code (0 Finer, 1 Dominant, 2
    Around); ``mesh``: each stream's edges split over every rank (module
    docstring)."""
    U1, U2, V, H1, H2 = tables
    (A_u, A_i, A_v), (X_u, X_a, X_v), (Y_i, Y_a, Y_v) = streams
    A_uc, A_ic, X_uc, X_ac, Y_ic, Y_ac = counts
    lambda_x, lambda_y, lambda_u, lambda_h, lambda_v = lambdas
    k1, k2 = U1.shape[1], H1.shape[1]

    pair_U2 = pair_V = None
    if pairs is not None:
        def pair_weights(U2e, U2l, Vp, p_w):
            s_i = torch.sum(U2e * Vp, dim=1)
            s_j = torch.sum(U2l * Vp, dim=1)
            z = 1.0 / (1.0 + torch.exp(s_j - s_i))
            grad = p_w * z
            if model_type == 1:
                grad = grad * (s_i < s_j).to(torch.float32)
            elif model_type == 2:
                grad = grad * (s_i > s_j).to(torch.float32)
            return grad

        # the pairs' weights from the ranks' slices; their rows (three
        # tables' rows a pair, over a stream of up to tens of millions of
        # (pair, aspect) entries) are formed from the weights on every rank
        p_early, p_late, p_asp, p_w = pairs
        U2e, U2l, Vp = U2[p_early], U2[p_late], V[p_asp]
        g = data_parallel(mesh, pair_weights, p_w.shape[0], U2e, U2l, Vp, p_w, axis=None)[:, None]
        # (den, num) of U2 at the early and late items, of V at the aspect
        pair_den_U2 = _sums(U2.shape[0], p_early, g * Vp)
        pair_num_U2 = _sums(U2.shape[0], p_late, g * Vp)
        pair_VV = _sums(V.shape[0], p_asp, torch.cat([g * U2e, g * U2l], 1))
        pair_U2 = (pair_num_U2, pair_den_U2)
        pair_V = (pair_VV[:, k1:], pair_VV[:, :k1])

    def rating_rows(A_u, A_i, A_v):  # A ~ U1 U2^T + H1 H2^T
        U1a, U2a, H1a, H2a = U1[A_u], U2[A_i], H1[A_u], H2[A_i]
        pred_A = torch.sum(U1a * U2a, dim=1) + torch.sum(H1a * H2a, dim=1)
        av, pa = A_v[:, None], pred_A[:, None]
        return (torch.cat([av * U2a, pa * U2a], 1), torch.cat([av * U1a, pa * U1a], 1),
                torch.cat([av * H2a, pa * H2a], 1), torch.cat([av * H1a, pa * H1a], 1))

    def attention_rows(X_u, X_a, X_v):  # X ~ U1 V^T
        U1x, Vx = U1[X_u], V[X_a]
        pred_X = torch.sum(U1x * Vx, dim=1)
        xv, px = (lambda_x * X_v)[:, None], (lambda_x * pred_X)[:, None]
        return torch.cat([xv * Vx, px * Vx], 1), torch.cat([xv * U1x, px * U1x], 1)

    def quality_rows(Y_i, Y_a, Y_v):  # Y ~ U2 V^T
        U2y, Vy = U2[Y_i], V[Y_a]
        pred_Y = torch.sum(U2y * Vy, dim=1)
        yv, py = (lambda_y * Y_v)[:, None], (lambda_y * pred_Y)[:, None]
        return torch.cat([yv * Vy, py * Vy], 1), torch.cat([yv * U2y, py * U2y], 1)

    A_U1, A_U2, A_H1, A_H2 = data_parallel(mesh, rating_rows, A_u.shape[0], A_u, A_i, A_v,
                                           axis=None)
    X_U1, X_V = data_parallel(mesh, attention_rows, X_u.shape[0], X_u, X_a, X_v, axis=None)
    Y_U2, Y_V = data_parallel(mesh, quality_rows, Y_i.shape[0], Y_i, Y_a, Y_v, axis=None)

    # (num | den) of each table, its streams' updates in the JAX order
    U1_nd = accumulate_rows(U1.new_zeros((U1.shape[0], 2 * k1)), torch.cat([A_u, X_u]),
                            torch.cat([A_U1, X_U1]))
    U2_nd = accumulate_rows(U2.new_zeros((U2.shape[0], 2 * k1)), torch.cat([A_i, Y_i]),
                            torch.cat([A_U2, Y_U2]))
    H1_nd = accumulate_rows(H1.new_zeros((H1.shape[0], 2 * k2)), A_u, A_H1)
    H2_nd = accumulate_rows(H2.new_zeros((H2.shape[0], 2 * k2)), A_i, A_H2)
    V_nd = accumulate_rows(V.new_zeros((V.shape[0], 2 * k1)), torch.cat([X_a, Y_a]),
                           torch.cat([X_V, Y_V]))

    V_num, V_den = V_nd[:, :k1], V_nd[:, k1:]
    U2_num, U2_den = U2_nd[:, :k1], U2_nd[:, k1:]
    if pairs is not None:
        V_num, V_den = V_num + pair_V[0], V_den + pair_V[1]
        U2_num, U2_den = U2_num + pair_U2[0], U2_den + pair_U2[1]
    V_new = V * torch.sqrt(V_num / (V_den + (X_ac + Y_ac)[:, None] * lambda_v * V + EPS))
    U1_new = U1 * torch.sqrt(
        U1_nd[:, :k1] / (U1_nd[:, k1:] + (A_uc + X_uc)[:, None] * lambda_u * U1 + EPS))
    U2_new = U2 * torch.sqrt(U2_num / (U2_den + (A_ic + Y_ic)[:, None] * lambda_u * U2 + EPS))
    H1_new = H1 * torch.sqrt(H1_nd[:, :k2] / (H1_nd[:, k2:] + A_uc[:, None] * lambda_h * H1 + EPS))
    H2_new = H2 * torch.sqrt(H2_nd[:, :k2] / (H2_nd[:, k2:] + A_ic[:, None] * lambda_h * H2 + EPS))
    for t, new in zip(tables, (U1_new, U2_new, V_new, H1_new, H2_new)):
        t.copy_(new)
    return tables


def efm_fit(tables, streams, counts, lambdas, n_iters, pairs=None, model_type=0, mesh=None):
    """``n_iters`` of ``efm_iteration`` (the JAX package's ``_efm_fit``),
    in place; returns the tables."""
    for _ in range(n_iters):
        efm_iteration(tables, streams, counts, lambdas, pairs, model_type, mesh)
    return tables


def _counts(idx, n):
    c = np.zeros(n, np.float32)
    np.add.at(c, idx, 1)
    return c


def efm_device_inputs(model, A, X, Y, dev):
    """(streams, counts, lambdas) of ``efm_iteration`` from the matrices of
    ``_build_matrices``, on ``dev``."""
    A_coo, X_coo, Y_coo = A.tocoo(), X.tocoo(), Y.tocoo()

    def stream(coo):
        return (torch.as_tensor(np.asarray(coo.row, np.int64), device=dev),
                torch.as_tensor(np.asarray(coo.col, np.int64), device=dev),
                torch.as_tensor(np.asarray(coo.data, np.float32), device=dev))

    counts = tuple(torch.as_tensor(c, device=dev) for c in (
        _counts(A_coo.row, model.num_users), _counts(A_coo.col, model.num_items),
        _counts(X_coo.row, model.num_users), _counts(X_coo.col, model.num_aspects),
        _counts(Y_coo.row, model.num_items), _counts(Y_coo.col, model.num_aspects)))
    lambdas = tuple(float(np.float32(v)) for v in (
        model.lambda_x, model.lambda_y, model.lambda_u, model.lambda_h, model.lambda_v))
    return (stream(A_coo), stream(X_coo), stream(Y_coo)), counts, lambdas


class EFM(Recommender):
    """Explicit factor model with aspect-level explanations.

    Parameters mirror the JAX package's. ``device``: where the model fits
    and scores (default: the card). ``mesh``: a ``parallel.make_mesh``
    mesh; every rank calls ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="EFM",
        num_explicit_factors=40,
        num_latent_factors=60,
        num_most_cared_aspects=15,
        rating_scale=5.0,
        alpha=0.85,
        lambda_x=1,
        lambda_y=1,
        lambda_u=0.01,
        lambda_h=0.01,
        lambda_v=0.01,
        use_item_aspect_popularity=True,
        max_iter=100,
        num_threads=0,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.num_threads = num_threads
        self.num_explicit_factors = num_explicit_factors
        self.num_latent_factors = num_latent_factors
        self.num_most_cared_aspects = num_most_cared_aspects
        self.rating_scale = rating_scale
        self.alpha = alpha
        self.lambda_x = lambda_x
        self.lambda_y = lambda_y
        self.lambda_u = lambda_u
        self.lambda_h = lambda_h
        self.lambda_v = lambda_v
        self.use_item_aspect_popularity = use_item_aspect_popularity
        self.max_iter = max_iter
        self.seed = seed
        self.ignored_attrs.append("_tables")

        self.init_params = {} if init_params is None else init_params
        self.U1 = self.init_params.get("U1", None)
        self.U2 = self.init_params.get("U2", None)
        self.V = self.init_params.get("V", None)
        self.H1 = self.init_params.get("H1", None)
        self.H2 = self.init_params.get("H2", None)

    @property
    def num_aspects(self):
        return self.train_set.sentiment.num_aspects

    def _compute_attention_score(self, count):
        return 1 + (self.rating_scale - 1) * (2 / (1 + np.exp(-count)) - 1)

    def _compute_quality_score(self, sentiment):
        return 1 + (self.rating_scale - 1) / (1 + np.exp(-sentiment))

    def _build_matrices(self, data_set):
        """A (ratings), X (user-aspect attention), Y (item-aspect quality)."""
        sentiment = data_set.sentiment
        u, i, r = data_set.uir_tuple
        keep = (u < self.num_users) & (i < self.num_items)
        A = sp.csr_matrix(
            (r[keep], (u[keep], i[keep])), shape=(self.num_users, self.num_items)
        )

        att, att_u, att_a = [], [], []
        for uid, tup_ids_by_item in sentiment.user_sentiment.items():
            if uid >= self.num_users:
                continue
            aspects = [
                tup[0]
                for tup_id in tup_ids_by_item.values()
                for tup in sentiment.sentiment[tup_id]
            ]
            for aid, count in Counter(aspects).items():
                att.append(self._compute_attention_score(count))
                att_u.append(uid)
                att_a.append(aid)
        X = sp.csr_matrix(
            (att, (att_u, att_a)), shape=(self.num_users, self.num_aspects)
        )

        qual, qual_i, qual_a = [], [], []
        for iid, tup_ids_by_user in sentiment.item_sentiment.items():
            if iid >= self.num_items:
                continue
            aspect_count = Counter(
                tup[0]
                for tup_id in tup_ids_by_user.values()
                for tup in sentiment.sentiment[tup_id]
            )
            total_by_aspect = OrderedDict()
            for tup_id in tup_ids_by_user.values():
                for aid, _, polarity in sentiment.sentiment[tup_id]:
                    total_by_aspect[aid] = total_by_aspect.get(aid, 0) + polarity
            for aid, total in total_by_aspect.items():
                qual_i.append(iid)
                qual_a.append(aid)
                if self.use_item_aspect_popularity:
                    qual.append(self._compute_quality_score(total))
                else:
                    qual.append(
                        self._compute_quality_score(total / aspect_count[aid])
                    )
        Y = sp.csr_matrix(
            (qual, (qual_i, qual_a)), shape=(self.num_items, self.num_aspects)
        )
        return A, X, Y

    def _init_tables(self):
        """The initial U1, U2, V, H1, H2 from the seed (numpy draws in the
        JAX package's order) where ``init_params`` did not give them."""
        rng = get_rng(self.seed)
        n_factors = self.num_explicit_factors + self.num_latent_factors
        high = np.sqrt(self.rating_scale / n_factors)
        for attr, shape in (
            ("U1", (self.num_users, self.num_explicit_factors)),
            ("U2", (self.num_items, self.num_explicit_factors)),
            ("V", (self.num_aspects, self.num_explicit_factors)),
            ("H1", (self.num_users, self.num_latent_factors)),
            ("H2", (self.num_items, self.num_latent_factors)),
        ):
            if getattr(self, attr) is None:
                setattr(self, attr, uniform(shape, high=high, random_state=rng))

    def _pairs(self, train_set, Y, dev):
        """The comparative pair stream of ``efm_iteration``: None for EFM."""
        return None

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        self._tables = None
        if not self.trainable:
            return self
        self._init_tables()
        dev = self._device()
        A, X, Y = self._build_matrices(train_set)
        streams, counts, lambdas = efm_device_inputs(self, A, X, Y, dev)
        pairs = self._pairs(train_set, Y, dev)
        tables = tuple(torch.as_tensor(np.asarray(getattr(self, n), np.float32), device=dev)
                       .clone() for n in ("U1", "U2", "V", "H1", "H2"))
        with torch.no_grad():
            efm_fit(tables, streams, counts, lambdas, self.max_iter, pairs,
                    getattr(self, "_gate", 0), self.mesh)
        self.U1, self.U2, self.V, self.H1, self.H2 = (
            t.cpu().numpy().astype(np.float64) for t in tables)
        return self

    def _on_device(self):
        """(U1, U2, V, H1, H2) as float64 tensors on the model's device,
        copied once after a fit."""
        if getattr(self, "_tables", None) is None:
            dev = self._device()
            self._tables = tuple(torch.as_tensor(np.asarray(getattr(self, n), np.float64),
                                                 device=dev)
                                 for n in ("U1", "U2", "V", "H1", "H2"))
        return self._tables

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        U1, U2, _, H1, H2 = self._on_device()
        if item_idx is None:
            return (U2 @ U1[user_idx] + H2 @ H1[user_idx]).cpu().numpy()
        return float(U2[item_idx] @ U1[user_idx] + H2[item_idx] @ H1[user_idx])

    def _composite_scores(self, users):
        """Paper eq. 6, computed on the device in float64, as host numpy:
        alpha * most-cared aspect match + (1 - alpha) * rating. The
        most-cared aspects come from
        ``torch.topk``; where the JAX package's ``argsort`` breaks ties
        otherwise, the tied aspects are those whose attention is exactly 0
        (no one mentions them: their V rows are 0 after the first update),
        whose terms are 0 in either choice."""
        U1, U2, V, H1, H2 = self._on_device()
        u = torch.as_tensor(np.asarray(users, np.int64), device=U1.device)
        X_ = U1[u] @ V.T  # (B, n_aspects)
        kmca = min(self.num_most_cared_aspects, X_.shape[1])
        top_x, top_idx = torch.topk(X_, kmca, dim=1)
        weights = torch.zeros_like(X_).scatter_(1, top_idx, top_x)
        explicit = (weights @ (V @ U2.T)) / (kmca * self.rating_scale)
        base = U1[u] @ U2.T + H1[u] @ H2.T
        return (self.alpha * explicit + (1 - self.alpha) * base).cpu().numpy()

    def rank(self, user_idx, item_indices=None, k=-1, **kwargs):
        known_item_scores = self._composite_scores(np.asarray([user_idx]))[0]

        if len(known_item_scores) == self.total_items:
            all_item_scores = known_item_scores
        else:
            all_item_scores = np.ones(self.total_items) * np.min(known_item_scores)
            all_item_scores[: self.num_items] = known_item_scores

        item_indices = (
            np.arange(self.num_items)
            if item_indices is None
            else np.asarray(item_indices)
        )
        item_scores = all_item_scores[item_indices]
        if k != -1:
            partitioned_idx = np.argpartition(item_scores, -k)
            top_k_idx = partitioned_idx[-k:]
            sorted_top_k_idx = top_k_idx[np.argsort(item_scores[top_k_idx])]
            partitioned_idx[-k:] = sorted_top_k_idx
            ranked_items = item_indices[partitioned_idx[::-1]]
        else:
            ranked_items = item_indices[item_scores.argsort()[::-1]]
        return ranked_items, item_scores

    def score_batch(self, user_indices):
        # the ranking path uses the composite score, as the JAX package's
        # rank() override does
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._composite_scores(np.where(known, users, 0))
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        U1, U2, _, H1, H2 = self._on_device()
        u = torch.as_tensor(np.where(known, users, 0).astype(np.int64), device=U1.device)
        i = torch.as_tensor(np.where(known, items, 0).astype(np.int64), device=U1.device)
        preds = (torch.sum(U1[u] * U2[i], 1) + torch.sum(H1[u] * H2[i], 1)).cpu().numpy()
        return np.where(known, preds, self.default_score())
