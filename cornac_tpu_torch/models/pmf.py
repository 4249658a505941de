"""PMF — Probabilistic Matrix Factorization (Mnih & Salakhutdinov, NIPS 2008).

Port of ``cornac_tpu/models/pmf.py``: RMSProp SGD over the observed ratings
in minibatches, linear or non-linear (the Gaussian mean through a sigmoid,
ratings rescaled to [0, 1]). The trainer ``_pmf_epoch`` is eager torch on
the model's device. Each epoch visits the ratings in a fresh permutation
from a ``torch.Generator`` seeded from (the fit's seed, the global epoch
index) and runs the shared stream epoch ``ops.rmsprop.rmsprop_stream_epoch``
(the RMSProp caches written back, the updates summed through the
deterministic ``ops.accumulate.accumulate_rows``). Nothing syncs with the
host inside an epoch.

``mesh`` (``parallel.make_mesh``) trains one process a rank and keeps the
single-device fit's bits: U, V and their RMSProp caches are row-sharded
over "model", as in the JAX package, every rank draws the same
permutation, and the stream epoch splits each minibatch over "data" and
writes each row on the rank that owns it (``ops.rmsprop``).
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.dispatch import full_f32
from ..ops.rmsprop import rmsprop_stream_epoch, set_rows_last_wins  # noqa: F401
from ..parallel.mesh import check_mesh, shard_tables
from ..parallel.sharded import local_shard
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.common import scale, sigmoid
from ..utils.init_utils import normal
from .mf import _epoch_permutation
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def _pmf_epoch(U, V, cache_u, cache_v, perm, mask, pairs, val, lr, reg, gamma, batch_size,
               non_linear, mesh=None):
    """One RMSProp epoch over the ratings in the order ``perm`` ((n_total,)
    int64, |R| padded to whole minibatches; ``mask`` (n_total,) float32 is 0
    on the padding), updating the four tables in place: the shared stream
    epoch ``ops.rmsprop.rmsprop_stream_epoch`` with U and V at one learning
    rate, as ``cornac_tpu/models/pmf.py::_pmf_epochs`` runs it. Returns the
    epoch's loss (a device scalar). With ``mesh`` the tables are this rank's
    row shards."""
    return rmsprop_stream_epoch(U, V, cache_u, cache_v, perm, mask, pairs, val, lr, lr, reg,
                                gamma, batch_size, non_linear, mesh)


class PMF(Recommender, ANNMixin):
    """PMF with RMSProp minibatch SGD on the device.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``gamma`` (the caches' decay), ``lambda_reg``,
    ``variant`` (``"linear"`` or ``"non_linear"``), ``batch_size``,
    ``init_params`` ({'U','V'}), ``seed``. ``device``: where the model trains
    and scores (default: the card). ``mesh``: a ``parallel.make_mesh``
    mesh; every rank calls ``fit``, and the factors equal the single-device
    fit's (module docstring).
    """

    def __init__(
        self,
        k=5,
        max_iter=100,
        learning_rate=0.001,
        gamma=0.9,
        lambda_reg=0.001,
        name="PMF",
        variant="non_linear",
        batch_size=1024,
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
        self.k = k
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.gamma = gamma
        self.lambda_reg = lambda_reg
        self.variant = variant
        self.batch_size = batch_size
        self.seed = seed

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set)

        if not self.trainable:
            return self

        if self.variant not in ("linear", "non_linear"):
            raise ValueError('variant must be one of {"linear","non_linear"}')

        rng = get_rng(self.seed)
        if self.U is None:
            self.U = normal((self.num_users, self.k), std=0.001, random_state=rng,
                            dtype=np.float64)
        if self.V is None:
            self.V = normal((self.num_items, self.k), std=0.001, random_state=rng,
                            dtype=np.float64)

        uid, iid, rat = train_set.uir_tuple
        rat = np.asarray(rat, dtype=np.float32)
        if self.variant == "non_linear" and [self.min_rating, self.max_rating] != [0, 1]:
            rat = scale(rat, 0.0, 1.0, self.min_rating, self.max_rating)

        mesh = self.mesh
        dev = self._device()
        n = len(rat)
        bsz = min(self.batch_size, n)
        n_pad = (-n) % bsz
        pairs = torch.as_tensor(np.stack([uid, iid], axis=1).astype(np.int64), device=dev)
        val = torch.as_tensor(np.asarray(rat, np.float32), device=dev)
        mask = torch.cat([torch.ones(n, device=dev), torch.zeros(n_pad, device=dev)])
        pad = torch.zeros(n_pad, dtype=torch.int64, device=dev)
        U = torch.tensor(np.asarray(self.U, np.float32), device=dev)
        V = torch.tensor(np.asarray(self.V, np.float32), device=dev)
        state = (U, V, torch.zeros_like(U), torch.zeros_like(V))
        if mesh is not None:
            state = shard_tables(mesh, *state)  # DTensors: what a checkpoint gathers
        seed = rng.randint(2**31)
        non_linear = self.variant == "non_linear"

        def run_chunk(state, start, e):
            for epoch in range(start, start + e):
                perm = _epoch_permutation(n, epoch_generator(seed, epoch, dev))
                loss = _pmf_epoch(*(local_shard(t) for t in state), torch.cat([perm, pad]),
                                  mask, pairs, val, self.learning_rate, self.lambda_reg,
                                  self.gamma, bsz, non_linear, mesh)
            return state, loss

        epoch_loop(self, self.max_iter, run_chunk, state,
                   on_report=lambda done, loss: print("epoch %i, loss: %f" % (done - 1,
                                                                               float(loss))))
        if mesh is not None:
            U, V = state[0].full_tensor()[:U.shape[0]], state[1].full_tensor()[:V.shape[0]]
        self.U = U.cpu().numpy().astype(np.float64)
        self.V = V.cpu().numpy().astype(np.float64)
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        if item_idx is None:
            return self.V.dot(self.U[user_idx, :])

        user_pred = self.V[item_idx, :].dot(self.U[user_idx, :])
        if self.variant == "non_linear":
            user_pred = sigmoid(user_pred)
            user_pred = scale(user_pred, self.min_rating, self.max_rating, 0.0, 1.0)
        return user_pred

    def _known_scores_device(self, safe_users, known):
        dev = self._device()
        U, V = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (self.U, self.V))
        with full_f32():
            return U[torch.as_tensor(safe_users, dtype=torch.long, device=dev)] @ V.T

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._known_scores_device(np.where(known, users, 0), known)
        scores = scores.cpu().numpy().astype(np.float64)
        # cold-start users: a flat row of the default score
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        u_safe = np.where(known, users, 0)
        i_safe = np.where(known, items, 0)
        preds = np.sum(self.U[u_safe] * self.V[i_safe], axis=1)
        if self.variant == "non_linear":
            preds = scale(sigmoid(preds), self.min_rating, self.max_rating, 0.0, 1.0)
        return np.where(known, preds, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.U

    def get_item_vectors(self):
        return self.V

