"""PMF — Probabilistic Matrix Factorization (Mnih & Salakhutdinov, NIPS 2008).

Port of ``cornac_tpu/models/pmf.py``: RMSProp SGD over the observed ratings
in minibatches, linear or non-linear (the Gaussian mean through a sigmoid,
ratings rescaled to [0, 1]). The trainer ``_pmf_epoch`` is eager torch on
the model's device. Each epoch visits the ratings in a fresh permutation
from a ``torch.Generator`` seeded from (the fit's seed, the global epoch
index); each minibatch gathers the rows of U, V and their RMSProp caches,
writes the caches back and adds the updates through the deterministic
``ops.accumulate.accumulate_rows``. Nothing syncs with the host inside an
epoch. The JAX package's padding of the columns to 64 is left out: padded
columns are exactly zero either way.
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.dispatch import full_f32
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator, epoch_loop
from ..utils.common import scale, sigmoid
from ..utils.init_utils import normal
from .mf import _epoch_permutation
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def set_rows_last_wins(table, ids, values):
    """``table[ids[p]] = values[p]`` for every batch position p, in place,
    where for a row that appears more than once the last position in batch
    order wins: the rule of ``cache.at[u].set(...)`` in the JAX package on
    its CPU reference (XLA applies a scatter's updates in order). A max of
    the batch positions per row (order-free, so deterministic on the card),
    then one gather: every duplicate of a row writes the same value."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((table.shape[0],), -1, dtype=torch.int64, device=ids.device)
    last.scatter_reduce_(0, ids, pos, reduce="amax")
    table[ids] = values[last[ids]]
    return table


def _pmf_epoch(U, V, cache_u, cache_v, perm, mask, pairs, val, lr, reg, gamma, batch_size,
               non_linear):
    """One RMSProp epoch over the ratings in the order ``perm`` ((n_total,)
    int64, |R| padded to whole minibatches; ``mask`` (n_total,) float32 is 0
    on the padding), updating the four tables in place. Returns the epoch's
    loss (a device scalar).

    The caches are written as ``_pmf_epochs`` writes them
    (``cornac_tpu/models/pmf.py:76-77``): each position writes its new cache
    row, a padded position the old one, and the last position of a row in
    the minibatch wins (``set_rows_last_wins``). The factor updates use each
    position's own new cache value and sum through ``accumulate_rows``."""
    eps = 1e-8
    loss = torch.zeros((), dtype=torch.float32, device=U.device)
    for s in range(0, perm.shape[0], batch_size):
        idx, m = perm[s:s + batch_size], mask[s:s + batch_size]
        u, i = pairs[idx].unbind(1)
        r = val[idx]
        pu, qi = U[u], V[i]
        sc = (pu * qi).sum(1)
        if non_linear:
            sg = torch.sigmoid(torch.clamp(sc, -6.0, 6.0))
            e = r - sg
            we = e * sg * (1.0 - sg)
        else:
            e = r - sc
            we = e
        we = we * m
        loss += ((e * e + reg * ((pu * pu).sum(1) + (qi * qi).sum(1))) * m).sum()
        mm = m[:, None]
        gu = we[:, None] * qi - reg * pu * mm
        gv = we[:, None] * pu - reg * qi * mm
        old_u, old_v = cache_u[u], cache_v[i]
        cu = gamma * old_u + (1 - gamma) * gu * gu
        cv = gamma * old_v + (1 - gamma) * gv * gv
        set_rows_last_wins(cache_u, u, torch.where(mm > 0, cu, old_u))
        set_rows_last_wins(cache_v, i, torch.where(mm > 0, cv, old_v))
        accumulate_rows(U, u, lr * gu / (torch.sqrt(cu) + eps) * mm)
        accumulate_rows(V, i, lr * gv / (torch.sqrt(cv) + eps) * mm)
    return loss


class PMF(Recommender, ANNMixin):
    """PMF with RMSProp minibatch SGD on the device.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``gamma`` (the caches' decay), ``lambda_reg``,
    ``variant`` (``"linear"`` or ``"non_linear"``), ``batch_size``,
    ``init_params`` ({'U','V'}), ``seed``. ``device``: where the model trains
    and scores (default: the card). ``mesh`` is not ported yet.
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
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.mesh = mesh
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
        seed = rng.randint(2**31)
        non_linear = self.variant == "non_linear"

        def run_chunk(state, start, e):
            for epoch in range(start, start + e):
                perm = _epoch_permutation(n, epoch_generator(seed, epoch, dev))
                loss = _pmf_epoch(*state, torch.cat([perm, pad]), mask, pairs, val,
                                  self.learning_rate, self.lambda_reg, self.gamma, bsz,
                                  non_linear)
            return state, loss

        epoch_loop(self, self.max_iter, run_chunk, state,
                   on_report=lambda done, loss: print("epoch %i, loss: %f" % (done - 1,
                                                                               float(loss))))
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

