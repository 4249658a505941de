"""SoRec — Social Recommendation via Probabilistic Matrix Co-Factorization
(Ma et al., CIKM 2008).

Port of ``cornac_tpu/models/sorec.py``: the rating matrix (U, V) and the
social adjacency (U, Z) co-factorised with a shared user table. Each epoch
runs the trust stream (U and Z at ``lambda_c * learning_rate``) and then
the rating stream (U and V) through the shared RMSProp stream epoch
(``ops.rmsprop``), both in orders that the fit's numpy generator draws, as
the JAX package's fit draws them: a seeded fit visits the same
observations in the same minibatches in either package. The tables stay on
the model's device for the whole fit; nothing syncs with the host inside an
epoch unless ``verbose`` asks for the loss.

``mesh`` (``parallel.make_mesh``) row-shards U, V, Z and their RMSProp
caches over "model", as in the JAX package, and runs both streams through
the stream epoch's ``mesh`` path (``ops.rmsprop``: each minibatch split
over "data", each row written on the rank that owns it): the
single-device fit's bits on every layout, as PMF keeps them. MCF
(``models/mcf.py``) shares this.
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.dense_scores import device_dot
from ..ops.rmsprop import run_stream_epoch
from ..parallel.mesh import check_mesh, shard_tables
from ..utils import get_rng
from ..utils.common import scale, sigmoid
from ..utils.init_utils import normal
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def link_weights(rows, cols, vals):
    """The trust edges' values weighted by the degrees of their ends,
    ``sqrt(in(j) / (in(j) + out(u))) * v`` for the edge u -> j, as float32,
    byte for byte what the JAX package's per-edge loop over
    ``get_node_degree`` gives: the degrees counted over the same edges (the
    train triplet), the ratio and root in float64."""
    rows, cols = np.asarray(rows), np.asarray(cols)
    width = int(max(rows.max(initial=-1), cols.max(initial=-1))) + 1
    ins = np.bincount(cols, minlength=width)[cols]
    outs = np.bincount(rows, minlength=width)[rows]
    return (np.sqrt(ins / (ins + outs)) * np.asarray(vals)).astype(np.float32)


def scaled_ratings(values, lo, hi):
    """Ratings mapped onto [0, 1] for the sigmoid link, as SoRec and MCF
    map them (a one-value range from [0, hi])."""
    if [lo, hi] == [0, 1]:
        return values
    return scale(values, 0.0, 1.0, 0.0 if lo == hi else lo, hi)


def stream_tensors(rows, cols, vals, device):
    """A stream's (n, 2) int64 pairs and (n,) float32 values on ``device``."""
    pairs = torch.as_tensor(np.stack([np.asarray(rows), np.asarray(cols)], axis=1)
                            .astype(np.int64), device=device)
    return pairs, torch.as_tensor(np.asarray(vals, np.float32), device=device)


class _StreamCoFactor(Recommender, ANNMixin):
    """Scoring shared by SoRec and MCF: dot products of U and V, through a
    sigmoid and back onto the rating scale for (user, item) pairs."""

    def _unscaled(self, preds):
        lo = 0.0 if self.min_rating == self.max_rating else self.min_rating
        return scale(sigmoid(preds), lo, self.max_rating, 0.0, 1.0)

    def _known_scores_device(self, safe_users, known):
        return device_dot(np.asarray(self.U, np.float32)[safe_users], self.V, self._device())

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self.U[np.where(known, users, 0)] @ self.V.T
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        preds = np.sum(self.U[np.where(known, users, 0)] * self.V[np.where(known, items, 0)],
                       axis=1)
        return np.where(known, self._unscaled(preds), self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.U

    def get_item_vectors(self):
        return self.V

    def _tables(self, rows_z, rng):
        """U, V and Z from ``init_params`` or N(0, 0.001) from ``rng``, in
        that order, as the JAX package draws them."""
        if self.U is None:
            self.U = normal((self.num_users, self.k), std=0.001, random_state=rng)
        if self.V is None:
            self.V = normal((self.num_items, self.k), std=0.001, random_state=rng)
        if self.Z is None:
            self.Z = normal((rows_z, self.k), std=0.001, random_state=rng)
        dev = self._device()
        return [torch.tensor(np.asarray(a, np.float32), device=dev)
                for a in (self.U, self.V, self.Z)]

    def _store(self, U, V, Z):
        self.U, self.V, self.Z = (t.cpu().numpy().astype(np.float64) for t in (U, V, Z))

    def _stream_state(self, U, V, Z):
        """The tables and their zero caches, each row-sharded over "model"
        on a mesh (``DTensor``s, padded to the shard count): (tables,
        caches)."""
        tables = [U, V, Z]
        caches = [torch.zeros_like(t) for t in tables]
        if self.mesh is not None:
            tables = list(shard_tables(self.mesh, *tables))
            caches = list(shard_tables(self.mesh, *caches))
        return tables, caches

    def _store_state(self, tables, rows):
        """Keep the fitted tables, the padding rows of their shards cut
        (``rows``: each table's own rows)."""
        if self.mesh is not None:
            tables = [t.full_tensor()[:n] for t, n in zip(tables, rows)]
        self._store(*tables)


class SoRec(_StreamCoFactor):
    """Co-factorise the rating matrix (U, V) and the social adjacency
    matrix (U, Z) with a shared user table.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``lambda_c`` (the trust stream's weight),
    ``lambda_reg``, ``gamma`` (the caches' decay), ``weight_link``,
    ``batch_size``, ``init_params`` ({'U', 'V', 'Z'}), ``seed``.
    ``device``: where the model trains and scores (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``, and
    the factors equal the single-device fit's (module docstring).
    """

    def __init__(
        self,
        name="SoRec",
        k=5,
        max_iter=100,
        learning_rate=0.001,
        lambda_c=10,
        lambda_reg=0.001,
        gamma=0.9,
        weight_link=True,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.lambda_c = lambda_c
        self.lambda_reg = lambda_reg
        self.gamma = gamma
        self.weight_link = weight_link
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)
        self.Z = self.init_params.get("Z", None)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        U, V, Z = self._tables(self.num_users, rng)
        rat_uid, rat_iid, rat_val = train_set.uir_tuple
        users = set(rat_uid)
        net_uid, net_jid, net_val = train_set.user_graph.get_train_triplet(users, users)
        if self.weight_link:
            net_val = link_weights(net_uid, net_jid, net_val)
        rat_val = scaled_ratings(rat_val, self.min_rating, self.max_rating)

        dev = U.device
        net = stream_tensors(net_uid, net_jid, net_val, dev)
        rat = stream_tensors(rat_uid, rat_iid, rat_val, dev)
        rows = [t.shape[0] for t in (U, V, Z)]
        (U, V, Z), (cu, cv, cz) = self._stream_state(U, V, Z)
        lr, reg = self.learning_rate, self.lambda_reg
        for epoch in range(self.max_iter):
            loss = 0.0
            if len(net_val) > 0:
                # the trust stream: both tables move at lambda_c * lr
                loss = run_stream_epoch(U, Z, cu, cz, *net, rng, self.lambda_c * lr,
                                        self.lambda_c * lr, reg, self.gamma, self.batch_size,
                                        mesh=self.mesh)
            loss = loss + run_stream_epoch(U, V, cu, cv, *rat, rng, lr, lr, reg, self.gamma,
                                           self.batch_size, mesh=self.mesh)
            if self.verbose:
                print("epoch %i, loss: %f" % (epoch, float(loss)))

        self._store_state((U, V, Z), rows)
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if item_idx is None:
            return self.V.dot(self.U[user_idx, :])
        return self._unscaled(self.V[item_idx, :].dot(self.U[user_idx, :]))
