"""VMF — Visual Matrix Factorization (Park, Kim & Choi, 2017).

Port of ``cornac_tpu/models/vmf.py``: pointwise regression of the ratings
scaled onto [0, 1] by ``sigmoid(U_u . V_i + P_u . (E f_i))``, RMSProp
(optax's rule, ``ops.optim.rmsprop``) over U, V, P and E. Each epoch visits
the ratings in a permutation of |R| rounded up to whole minibatches, taken
modulo |R| (``vmf_order``), from a ``torch.Generator`` seeded from (the
fit's seed, the global epoch index), as the JAX package takes its order
from its key. The item features stay on the model's device; the gradients
of the row gathers sum through ``accumulate_rows``. Nothing syncs with the
host inside an epoch.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank,
the minibatch rounded down to a multiple of the mesh's size as in the JAX
package: every rank draws the whole order and sums the terms of its rows
of each minibatch (E's penalty on rank 0 alone), and ``ops.optim.step``
sums the gradients.
"""

import numpy as np
import torch

from ..exception import CornacException, ScoreException
from ..ops.accumulate import gather_rows
from ..ops.optim import rmsprop, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, round_batch
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.common import scale
from .mf import _epoch_permutation
from .recommender import Recommender, pad_to_catalog

TABLES = ("U", "V", "P", "E")


def vmf_order(gen, n, n_total):
    """An epoch's order: a permutation of ``n_total`` positions modulo
    ``n``."""
    return _epoch_permutation(n_total, gen) % n


def vmf_loss(params, F, u, i, r, hyper, dense=True):
    """The JAX package's ``loss_fn``: half the squared error of the sigmoid
    prediction and the halved L2 terms. ``hyper``: (lambda_u, lambda_v,
    lambda_p, lambda_e). With ``dense`` False (a rank of a mesh but the
    first) E's penalty is left out: every other term is a sum over the
    rows."""
    lu, lv, lp, le = hyper
    U_u, V_i, P_u = (gather_rows(params["U"], u), gather_rows(params["V"], i),
                     gather_rows(params["P"], u))
    vis = F[i] @ params["E"]
    pred = torch.sigmoid((U_u * V_i).sum(1) + (P_u * vis).sum(1))
    loss = 0.5 * ((r - pred) ** 2).sum()
    reg = lu * 0.5 * (U_u ** 2).sum() + lv * 0.5 * (V_i ** 2).sum() + lp * 0.5 * (P_u ** 2).sum()
    if dense:
        reg = reg + le * 0.5 * (params["E"] ** 2).sum()
    return loss + reg


def vmf_epoch(params, opt, opt_state, order, triples, F, hyper, batch_size, mesh=None):
    """One epoch of RMSProp steps in the order ``order``, updating
    ``params`` in place. ``triples``: ((n, 2) int64 pairs, (n,) float32
    scaled ratings). Returns (the new state, the summed loss). ``mesh``:
    each rank takes its share of every minibatch (module docstring)."""
    pairs, rat = triples
    loss_sum = torch.zeros((), dtype=torch.float32, device=pairs.device)
    share = Share(mesh, batch_size)
    for s in range(0, order.shape[0], batch_size):
        idx = share.take(order[s:s + batch_size])
        u, i = pairs[idx].unbind(1)
        loss = vmf_loss(params, F, u, i, rat[idx], hyper, share.first)
        opt_state = step(params, opt, opt_state, loss, mesh, None)
        loss_sum += loss.detach()
    if mesh is not None:  # the ranks' shares make the minibatches' losses
        all_sum(mesh, loss_sum, None)
    return opt_state, loss_sum


class VMF(Recommender):
    """sigmoid(u.v + p.(E f_i)) regression on scaled ratings.

    Parameters mirror the JAX package: ``k``, ``d`` (the visual factors),
    ``n_epochs``, ``batch_size``, ``learning_rate``, ``gamma`` (RMSProp's
    decay), ``lambda_u``, ``lambda_v``, ``lambda_p``, ``lambda_e``,
    ``use_gpu`` (kept for the signature), ``init_params`` ({'U', 'V', 'P',
    'E'}), ``seed``. ``device``: where the model trains (default: the
    card). ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls
    ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="VMF",
        k=10,
        d=10,
        n_epochs=100,
        batch_size=100,
        learning_rate=0.001,
        gamma=0.9,
        lambda_u=0.001,
        lambda_v=0.001,
        lambda_p=1.0,
        lambda_e=10.0,
        trainable=True,
        verbose=False,
        use_gpu=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.d = d
        self.n_epochs = n_epochs
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.gamma = gamma
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.lambda_p = lambda_p
        self.lambda_e = lambda_e
        self.use_gpu = use_gpu
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.init_params = {} if init_params is None else init_params

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.item_image is None:
            raise CornacException("this model needs the item_image modality attached to the "
                                  "eval method")

        rng = get_rng(self.seed)
        features = np.asarray(train_set.item_image.features[: self.num_items], dtype=np.float32)
        shapes = {"U": (self.num_users, self.k), "V": (self.num_items, self.k),
                  "P": (self.num_users, self.d), "E": (features.shape[1], self.d)}
        dev = self._device()
        params = {}
        for name in TABLES:  # drawn in this order, each only when not given
            given = self.init_params.get(name)
            value = given if given is not None else rng.randn(*shapes[name])
            params[name] = torch.tensor(np.asarray(value, np.float32), device=dev,
                                        requires_grad=True)
        if not self.trainable:
            self._store(params, features)
            return self

        rid, cid, rat = train_set.uir_tuple
        rat = scale(rat.astype(np.float32), 0.0, 1.0, self.min_rating, self.max_rating)
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        triples = (pairs, torch.as_tensor(np.asarray(rat, np.float32), device=dev))
        F = torch.as_tensor(features, device=dev)
        n = len(rid)
        bsz = round_batch(self.mesh, min(self.batch_size, n))
        n_batches = (n + bsz - 1) // bsz
        hyper = (self.lambda_u, self.lambda_v, self.lambda_p, self.lambda_e)
        opt = rmsprop(self.learning_rate, decay=self.gamma)
        seed = rng.randint(2**31)

        def run_chunk(opt_state, start, e):
            for epoch in range(start, start + e):
                order = vmf_order(epoch_generator(seed, epoch, dev), n, n_batches * bsz)
                opt_state, loss_sum = vmf_epoch(params, opt, opt_state, order, triples, F,
                                                hyper, bsz, self.mesh)
            return opt_state, loss_sum

        epoch_loop(self, self.n_epochs, run_chunk, opt.init(params), resident=params,
                   on_report=lambda done, loss: print(
                       "Epoch %d/%d, loss: %.4f" % (done, self.n_epochs,
                                                    float(loss) / n_batches)))

        self._store(params, features)
        return self

    def _store(self, params, features):
        self.U, self.V, self.P, self.E = (
            params[name].detach().cpu().numpy().astype(np.float64) for name in TABLES)
        self.Q = features.astype(np.float64) @ self.E  # projected visual factors

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if item_idx is None:
            return self.V @ self.U[user_idx] + self.Q @ self.P[user_idx]
        return self.V[item_idx] @ self.U[user_idx] + self.Q[item_idx] @ self.P[user_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        safe = np.where(known, users, 0)
        scores = self.U[safe] @ self.V.T + self.P[safe] @ self.Q.T
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
