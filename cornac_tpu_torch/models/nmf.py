"""NMF — Non-negative MF by multiplicative updates (Lee & Seung, 2001).

Port of ``cornac_tpu/models/nmf.py``: the whole fit is full-batch epochs
on the model's device, no sampling. Each epoch gathers the factor rows of
every observed rating, predicts, adds the bias steps, then sums the four
numerator and denominator tables and updates U and V elementwise. Every
scatter-add goes through the deterministic ``ops.accumulate.accumulate_rows``,
which sums in the order of the ratings, as XLA's CPU scatter does; from the
same numpy initial factors a fit is the same in both packages up to the
order of float32 sums inside the products.

``mesh`` (``parallel.make_mesh``) trains one process a rank and keeps the
single-device fit's bits: U, Bu and the user counts, and V, Bi and the item
counts, are row-sharded over "model" and the ratings replicated, as in the
JAX package, and each epoch's per-rating rows are split over "data"
(``_nmf_epochs``).
"""

import functools

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.dispatch import full_f32
from ..parallel.mesh import check_mesh, shard_tables
from ..parallel.sharded import (
    data_parallel,
    gather_shards,
    local_shard,
    row_shard_lookup,
    row_shard_scatter_add,
)
from ..utils import get_rng
from ..utils.init_utils import uniform, zeros
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def _nmf_rows(pu, qi, bu, bi, r, lr, lambda_bu, lambda_bi, mu, use_bias):
    """The per-rating part of an epoch from the rating's fetched rows: the
    rows of U's and V's numerators and denominators, then, with the
    biases, the two bias steps."""
    pred = (pu * qi).sum(1)
    if use_bias:
        pred = pred + mu + bu + bi
    out = (r[:, None] * qi, pred[:, None] * qi, r[:, None] * pu, pred[:, None] * pu)
    if use_bias:
        err = r - pred
        out += (lr * (err - lambda_bu * bu), lr * (err - lambda_bi * bi))
    return out


def _nmf_epochs(U, V, Bu, Bi, rid, cid, val, user_counts, item_counts, lr, lambda_u, lambda_v,
                lambda_bu, lambda_bi, mu, n_epochs, use_bias, mesh=None):
    """``n_epochs`` multiplicative-update epochs, as
    ``cornac_tpu/models/nmf.py::_nmf_fit``, on the device tensors given:
    U (num_users, k), V (num_items, k), Bu, Bi float32; rid, cid int64 and
    val float32 (|R|,); the counts of ratings per user and per item. Returns
    the new (U, V, Bu, Bi).

    ``mesh``: the tables and counts are this rank's row shards over
    "model" and the ratings whole. Each rank fetches the rows of its data
    slice of the ratings (``row_shard_lookup``), the per-rating rows are
    gathered back in rating order (``data_parallel``) and each rank sums
    those of its rows (``row_shard_scatter_add``): the single-device bits."""
    eps = 1e-9
    if mesh is None:
        lookup, scatter = (lambda t, ids: t[ids]), accumulate_rows
    else:
        lookup = functools.partial(row_shard_lookup, mesh)
        scatter = functools.partial(row_shard_scatter_add, mesh)

    def rows(r_, c_, v_):
        return _nmf_rows(lookup(U, r_), lookup(V, c_), lookup(Bu, r_), lookup(Bi, c_), v_, lr,
                         lambda_bu, lambda_bi, mu, use_bias)

    for _ in range(n_epochs):
        out = data_parallel(mesh, rows, val.shape[0], rid, cid, val)
        if use_bias:
            Bu = scatter(Bu.clone(), rid, out[4])
            Bi = scatter(Bi.clone(), cid, out[5])
        U_num, U_den, V_num, V_den = (
            scatter(torch.zeros_like(T), ids, x)
            for T, ids, x in ((U, rid, out[0]), (U, rid, out[1]), (V, cid, out[2]),
                              (V, cid, out[3])))
        U = U * U_num / (U_den + user_counts[:, None] * lambda_u * U + eps)
        V = V * V_num / (V_den + item_counts[:, None] * lambda_v * V + eps)
    return U, V, Bu, Bi


class NMF(Recommender, ANNMixin):
    """NMF with whole-epoch multiplicative updates on the device.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate`` (the biases only), the regularizers ``lambda_u``,
    ``lambda_v``, ``lambda_bu``, ``lambda_bi`` (all replaced by
    ``lambda_reg`` when it is positive), ``use_bias``, ``init_params``
    ({'U','V','Bu','Bi','mu'}), ``seed``. ``device``: where the model trains
    and scores (default: the card). ``mesh``: a ``parallel.make_mesh``
    mesh; every rank calls ``fit``, and the factors equal the single-device
    fit's (module docstring).
    """

    def __init__(
        self,
        name="NMF",
        k=15,
        max_iter=50,
        learning_rate=0.005,
        lambda_reg=0.0,
        lambda_u=0.06,
        lambda_v=0.06,
        lambda_bu=0.02,
        lambda_bi=0.02,
        use_bias=False,
        num_threads=0,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.num_threads = num_threads  # the JAX package's OpenMP knob, accepted and unused
        self.k = k
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.lambda_reg = lambda_reg
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.lambda_bu = lambda_bu
        self.lambda_bi = lambda_bi
        self.use_bias = use_bias
        self.seed = seed

        if self.lambda_reg > 0:
            self.lambda_u = self.lambda_v = self.lambda_reg
            self.lambda_bu = self.lambda_bi = self.lambda_reg

        self.init_params = {} if init_params is None else init_params
        self.u_factors = self.init_params.get("U", None)
        self.i_factors = self.init_params.get("V", None)
        self.u_biases = self.init_params.get("Bu", None)
        self.i_biases = self.init_params.get("Bi", None)
        self.global_mean_init = self.init_params.get("mu", None)

    def _init(self):
        rng = get_rng(self.seed)
        if self.u_factors is None:
            self.u_factors = uniform((self.num_users, self.k), random_state=rng)
        if self.i_factors is None:
            self.i_factors = uniform((self.num_items, self.k), random_state=rng)
        if self.u_biases is None:
            self.u_biases = zeros(self.num_users)
        if self.i_biases is None:
            self.i_biases = zeros(self.num_items)
        if not self.use_bias:
            self.global_mean = 0.0
        elif self.global_mean_init is not None:
            self.global_mean = self.global_mean_init

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self._init()
        if not self.trainable:
            return self

        mesh = self.mesh
        dev = self._device()
        rid, cid, val = train_set.uir_tuple
        user_counts = np.bincount(rid, minlength=self.num_users).astype(np.float32)
        item_counts = np.bincount(cid, minlength=self.num_items).astype(np.float32)
        tables = [torch.tensor(np.asarray(a, np.float32), device=dev) for a in (
            self.u_factors, self.i_factors, self.u_biases, self.i_biases, val, user_counts,
            item_counts)]
        n_u, n_i = tables[0].shape[0], tables[1].shape[0]
        if mesh is not None:
            # this rank's row shards of U, V, Bu, Bi and the two counts
            tables = [local_shard(shard_tables(mesh, t)) if j != 4 else t
                      for j, t in enumerate(tables)]
        ids = [torch.as_tensor(np.asarray(a, np.int64), device=dev) for a in (rid, cid)]
        U, V, Bu, Bi = _nmf_epochs(
            *tables[:4], *ids, *tables[4:], self.learning_rate, self.lambda_u, self.lambda_v,
            self.lambda_bu, self.lambda_bi, float(np.float32(self.global_mean)), self.max_iter,
            self.use_bias, mesh,
        )
        if mesh is not None:
            U, Bu = (gather_shards(mesh, t)[:n_u] for t in (U, Bu))
            V, Bi = (gather_shards(mesh, t)[:n_i] for t in (V, Bi))
        self.u_factors, self.i_factors, self.u_biases, self.i_biases = (
            t.cpu().numpy() for t in (U, V, Bu, Bi))
        return self

    def score(self, user_idx, item_idx=None):
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        if item_idx is None:
            known_item_scores = self.global_mean + self.i_biases.astype(np.float64)
            if self.knows_user(user_idx):
                known_item_scores = known_item_scores + self.u_biases[user_idx]
                known_item_scores = known_item_scores + self.i_factors @ self.u_factors[user_idx]
            return known_item_scores

        item_score = self.global_mean + self.i_biases[item_idx]
        if self.knows_user(user_idx):
            item_score += self.u_biases[user_idx]
            item_score += self.u_factors[user_idx].dot(self.i_factors[item_idx])
        return item_score

    def score_batch_device(self, user_indices):
        dev = self._device()
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        U, V, Bu, Bi = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                        for a in (self.u_factors, self.i_factors, self.u_biases, self.i_biases))
        safe = torch.as_tensor(np.where(known, users, 0), dtype=torch.long, device=dev)
        known_d = torch.as_tensor(known.astype(np.float32), device=dev)
        with full_f32():
            personal = (U[safe] * known_d[:, None]) @ V.T
        return float(np.float32(self.global_mean)) + (Bu[safe] * known_d)[:, None] + Bi + personal

    def score_batch(self, user_indices):
        scores = self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known_u = (users >= 0) & (users < self.num_users)
        known_i = (items >= 0) & (items < self.num_items)
        u_safe = np.where(known_u, users, 0)
        i_safe = np.where(known_i, items, 0)
        personal = self.u_biases[u_safe] + np.sum(
            self.u_factors[u_safe] * self.i_factors[i_safe], axis=1)
        scores = float(self.global_mean) + self.i_biases[i_safe] + np.where(known_u, personal, 0.0)
        return np.where(known_i, scores, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        user_vectors = self.u_factors
        if self.use_bias:
            user_vectors = np.concatenate(
                (user_vectors, np.ones([user_vectors.shape[0], 1])), axis=1)
        return user_vectors

    def get_item_vectors(self):
        item_vectors = self.i_factors
        if self.use_bias:
            item_vectors = np.concatenate((item_vectors, self.i_biases.reshape((-1, 1))), axis=1)
        return item_vectors
