"""Non-personalized and bias-only baselines.

Port of ``cornac_tpu/models/baseline.py``: ``GlobalAvg``, ``MostPop`` and
``BaselineOnly``, whose bias-only SGD epoch runs as eager torch on the
model's device with the deterministic ``ops.accumulate.accumulate_rows``.
As in the JAX package, ``BaselineOnly`` draws each epoch's permutation with
numpy from its seed, so the two packages visit the ratings in the same
order.
"""

import numpy as np
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.dense_scores import device_broadcast_row
from ..utils import get_rng
from ..utils.init_utils import zeros
from .recommender import Recommender


class GlobalAvg(Recommender):
    """Predict the global mean rating for every pair."""

    def __init__(self, name="GlobalAvg", device=None):
        super().__init__(name=name, trainable=False)
        self.device = device

    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            return np.full(self.num_items, self.global_mean)
        return self.global_mean

    def _known_scores_device(self, safe_users, known):
        return device_broadcast_row(np.full(self.num_items, self.global_mean),
                                    len(safe_users), self._device())

    def score_batch(self, user_indices):
        return np.full((len(user_indices), self.total_items), self.global_mean)

    def score_pairs(self, user_indices, item_indices):
        return np.full(len(user_indices), self.global_mean)


class MostPop(Recommender):
    """Rank items by train-set interaction count."""

    def __init__(self, name="MostPop", device=None):
        super().__init__(name=name, trainable=False)
        self.device = device
        self.item_pop = None

    def fit(self, train_set, val_set=None):
        super().fit(train_set, val_set)
        self.item_pop = np.ediff1d(train_set.csc_matrix.indptr)
        return self

    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            return self.item_pop
        return self.item_pop[item_idx]

    def _known_scores_device(self, safe_users, known):
        return device_broadcast_row(self.item_pop, len(safe_users), self._device())

    def score_batch(self, user_indices):
        row = np.asarray(self.item_pop, dtype=np.float64)
        if len(row) < self.total_items:
            full = np.full(self.total_items, row.min())
            full[: len(row)] = row
            row = full
        return np.broadcast_to(row, (len(user_indices), len(row))).copy()

    def score_pairs(self, user_indices, item_indices):
        items = np.asarray(item_indices)
        known = items < len(self.item_pop)
        return np.where(
            known, self.item_pop[np.minimum(items, len(self.item_pop) - 1)], 0.0
        ).astype(np.float64)


def _bias_sgd_epoch(Bu, Bi, perm, mask, rid, cid, val, lr, reg, mu, batch_size):
    """One epoch of bias-only SGD (r ~ mu + bu + bi) over the ratings in the
    order ``perm`` (|R| padded to whole minibatches, ``mask`` 0 on the
    padding), updating ``Bu`` and ``Bi`` in place. Returns half the summed
    squared error (a device scalar)."""
    loss = torch.zeros((), dtype=torch.float32, device=Bu.device)
    for s in range(0, perm.shape[0], batch_size):
        idx, m = perm[s:s + batch_size], mask[s:s + batch_size]
        u, i = rid[idx], cid[idx]
        err = (val[idx] - (mu + Bu[u] + Bi[i])) * m
        loss += (err * err).sum()
        accumulate_rows(Bu, u, lr * (err - reg * Bu[u] * m))
        accumulate_rows(Bi, i, lr * (err - reg * Bi[i] * m))
    return 0.5 * loss


class BaselineOnly(Recommender):
    """r_ui ~ mu + b_u + b_i fitted by SGD (Koren, TKDD 2010)."""

    def __init__(
        self,
        name="BaselineOnly",
        max_iter=20,
        learning_rate=0.01,
        lambda_reg=0.02,
        batch_size=256,
        early_stop=False,
        num_threads=0,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.mesh = mesh
        self.device = device
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.lambda_reg = lambda_reg
        self.batch_size = batch_size
        self.early_stop = early_stop
        self.num_threads = num_threads
        self.seed = seed

        self.init_params = {} if init_params is None else init_params
        self.u_biases = self.init_params.get("Bu", None)
        self.i_biases = self.init_params.get("Bi", None)

    def _init(self):
        if self.u_biases is None:
            self.u_biases = zeros(self.num_users, dtype=np.float32)
        if self.i_biases is None:
            self.i_biases = zeros(self.num_items, dtype=np.float32)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self._init()
        if not self.trainable:
            return self

        dev = self._device()
        rng = get_rng(self.seed)
        rid, cid, val = train_set.uir_tuple
        n = len(val)
        bsz = min(self.batch_size, n)
        n_pad = (-n) % bsz

        rid_d = torch.as_tensor(np.asarray(rid, np.int64), device=dev)
        cid_d = torch.as_tensor(np.asarray(cid, np.int64), device=dev)
        val_d = torch.as_tensor(np.asarray(val, np.float32), device=dev)
        mask = torch.cat([torch.ones(n, device=dev), torch.zeros(n_pad, device=dev)])
        # copies: the epochs update them in place
        Bu = torch.tensor(np.asarray(self.u_biases, np.float32), device=dev)
        Bi = torch.tensor(np.asarray(self.i_biases, np.float32), device=dev)
        mu = float(np.float32(self.global_mean))
        last_loss = 0.0
        for epoch in range(self.max_iter):
            perm = np.concatenate([rng.permutation(n), np.zeros(n_pad, np.int64)])
            loss = _bias_sgd_epoch(Bu, Bi, torch.as_tensor(perm, device=dev), mask, rid_d,
                                   cid_d, val_d, self.learning_rate, self.lambda_reg, mu, bsz)
            if not (self.verbose or self.early_stop):
                continue
            loss = float(loss)
            if self.verbose:
                print("Epoch %d/%d, loss = %.2f" % (epoch + 1, self.max_iter, loss))
            if self.early_stop and epoch > 0 and abs(loss - last_loss) < 1e-5:
                break
            last_loss = loss

        self.u_biases = Bu.cpu().numpy()
        self.i_biases = Bi.cpu().numpy()
        return self

    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            known_item_scores = self.global_mean + self.i_biases.astype(np.float64)
            if self.knows_user(user_idx):
                known_item_scores += self.u_biases[user_idx]
            return known_item_scores
        score = self.global_mean + (
            self.i_biases[item_idx] if self.knows_item(item_idx) else 0.0
        )
        if self.knows_user(user_idx):
            score += self.u_biases[user_idx]
        return score

    def score_batch_device(self, user_indices):
        dev = self._device()
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        bu = np.where(known, self.u_biases[np.where(known, users, 0)], 0.0)
        return (
            float(np.float32(self.global_mean))
            + torch.as_tensor(np.asarray(bu, np.float32), device=dev)[:, None]
            + torch.as_tensor(np.asarray(self.i_biases, np.float32), device=dev)[None, :]
        )

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        bu = np.where(known, self.u_biases[np.where(known, users, 0)], 0.0)
        scores = self.global_mean + bu[:, None] + self.i_biases[None, :]
        total = self.total_items
        if scores.shape[1] < total:
            out = np.broadcast_to(
                scores.min(axis=1, keepdims=True), (scores.shape[0], total)
            ).copy()
            out[:, : scores.shape[1]] = scores
            return out
        return scores

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known_u = (users >= 0) & (users < self.num_users)
        known_i = (items >= 0) & (items < self.num_items)
        bu = np.where(known_u, self.u_biases[np.where(known_u, users, 0)], 0.0)
        bi = np.where(known_i, self.i_biases[np.where(known_i, items, 0)], 0.0)
        return self.global_mean + bu + bi
