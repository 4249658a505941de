"""HRDR — Hybrid neural recommendation with joint deep Representation
learning of ratings and reviews (Liu et al., Neurocomputing 2021).

Port of ``cornac_tpu/models/hrdr.py``: per-review text CNN towers whose
attention is driven by a rating-row MLP (three dense layers, then a batch
normalisation), and a prediction head on pu = [rating_h, ou, user_emb] ⊙
qi = [rating_h, oi, item_emb]. The batch normalisation uses the batch's
statistics in training (biased variance, eps ``BN_EPS``, keras' default)
and, outside training, statistics over every entity of the side
(``_population_bn_stats``), as the JAX package does. Training, draws,
gradients and scoring are NARRE's (``narre.ReviewRegressor``); the rating
rows are the dense train matrix, resident on the model's device. On a
mesh (NARRE's) the batch statistics are the whole minibatch's: each rank's
sums over its rows are summed over the ranks, forward and backward
(``Share.sum``).
"""

import numpy as np
import torch

from ..ops.accumulate import gather_rows
from .cdl import dense_rows
from .narre import ReviewRegressor
from .review_utils import (
    apply_dense,
    flatten,
    init_dense_np,
    init_text_cnn,
    masked_attention,
    text_cnn,
)

BN_EPS = 1e-3  # keras BatchNormalization default epsilon


def _bn_train(x, scale, offset, share=None):
    """Batch normalisation with the batch's statistics; ``share``
    (``parallel.sharded.Share``): ``x`` is a rank's rows of a minibatch,
    and the statistics are the whole minibatch's."""
    if share is None:
        mean = x.mean(dim=0)
        var = ((x - mean) ** 2).mean(dim=0)
    else:
        mean = share.sum(x.sum(dim=0)) / share.n
        var = share.sum(((x - mean) ** 2).sum(dim=0)) / share.n
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + offset


def _bn_eval(x, stats, scale, offset):
    mean, var = stats
    return (x - mean) / torch.sqrt(var + BN_EPS) * scale + offset


class HRDR(ReviewRegressor):
    """Rating-guided review attention rating regressor.

    Parameters mirror the JAX package: NARRE's, and
    ``n_user_mlp_factors``, ``n_item_mlp_factors`` (the rating MLPs' first
    widths). The rating MLP's output is ``n_filters * len(kernel_sizes)``
    wide. ``device``: where the model trains and scores (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``
    (``narre``'s module docstring).
    """

    def __init__(
        self,
        name="HRDR",
        embedding_size=100,
        id_embedding_size=32,
        n_factors=32,
        attention_size=16,
        kernel_sizes=None,
        n_filters=64,
        n_user_mlp_factors=128,
        n_item_mlp_factors=128,
        dropout_rate=0.5,
        max_text_length=50,
        max_num_review=32,
        batch_size=64,
        max_iter=10,
        optimizer="adam",
        learning_rate=0.001,
        model_selection="last",
        user_based=True,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self._setup(name, embedding_size, id_embedding_size, n_factors, attention_size,
                    kernel_sizes, n_filters, dropout_rate, max_text_length, max_num_review,
                    batch_size, max_iter, optimizer, learning_rate, model_selection, user_based,
                    init_params, seed, mesh, device)
        self.n_user_mlp_factors = n_user_mlp_factors
        self.n_item_mlp_factors = n_item_mlp_factors

    def _init_all(self, rng, n_vocab):
        """The initial parameters as a flat dict of float32 arrays, drawn
        from ``rng`` in the JAX package's order."""
        E, D = self.embedding_size, self.id_embedding_size
        FK = self._filters
        word = self._word_table(rng, n_vocab)

        def uni(*shape):
            return rng.uniform(-0.05, 0.05, size=shape).astype(np.float32)

        umlp, imlp = self.n_user_mlp_factors, self.n_item_mlp_factors
        tree = {"word_u": word, "word_i": word.copy()}
        tree["user_emb"] = uni(self.num_users, D)
        tree["item_emb"] = uni(self.num_items, D)
        tree["bu"] = np.full((self.num_users,), 0.1, np.float32)
        tree["bi"] = np.full((self.num_items,), 0.1, np.float32)
        tree["mu"] = np.float32(self.global_mean)
        tree["cnn_u"] = init_text_cnn(rng, E, self.kernel_sizes, self.n_filters)
        tree["cnn_i"] = init_text_cnn(rng, E, self.kernel_sizes, self.n_filters)
        for side, fan_in, width in (("u", self.num_items, umlp), ("i", self.num_users, imlp)):
            tree[side + "_mlp1"] = init_dense_np(rng, fan_in, width)
            tree[side + "_mlp2"] = init_dense_np(rng, width, width // 2)
            tree[side + "_mlp3"] = init_dense_np(rng, width // 2, FK)
            tree[side + "_bn_scale"] = np.ones((FK,), np.float32)
            tree[side + "_bn_offset"] = np.zeros((FK,), np.float32)
        tree["att_u1"] = init_dense_np(rng, FK, self.attention_size)
        tree["att_u2"] = init_dense_np(rng, self.attention_size, 1)
        tree["att_i1"] = init_dense_np(rng, FK, self.attention_size)
        tree["att_i2"] = init_dense_np(rng, self.attention_size, 1)
        tree["ou"] = init_dense_np(rng, FK, self.n_factors)
        tree["oi"] = init_dense_np(rng, FK, self.n_factors)
        tree["W1"] = init_dense_np(rng, FK + self.n_factors + D, 1, bias=False)
        return flatten(tree)

    def _tensors(self, train_set, dev):
        t = self._reviews(train_set, dev)
        t["u_rows"] = dense_rows(train_set, dev, by="user")
        t["i_rows"] = dense_rows(train_set, dev, by="item")
        return t

    def _rating_mlp_prebn(self, params, rows, side):
        h = torch.relu(apply_dense(params, side + "_mlp1", rows))
        h = torch.relu(apply_dense(params, side + "_mlp2", h))
        return torch.relu(apply_dense(params, side + "_mlp3", h))

    def _rating_mlp(self, params, rows, side, bn_stats, share=None):
        h = self._rating_mlp_prebn(params, rows, side)
        scale, offset = params[side + "_bn_scale"], params[side + "_bn_offset"]
        if bn_stats is None:
            return _bn_train(h, scale, offset, share)
        return _bn_eval(h, bn_stats, scale, offset)

    def _population_bn_stats(self, params, t, side):
        """The batch normalisation's (mean, biased variance) over every
        entity of ``side``."""
        h = self._rating_mlp_prebn(params, t[side + "_rows"], side)
        return h.mean(dim=0), ((h - h.mean(dim=0)) ** 2).mean(dim=0)

    def _eval_stats(self, params, t):
        return (self._population_bn_stats(params, t, "u"),
                self._population_bn_stats(params, t, "i"))

    def _tower(self, params, t, side, idx, mask, bn_stats, share=None):
        """(rating_h, o) of the side for entities ``idx``: the rating MLP
        over their rating rows, the CNN over each review, attention driven
        by the rating MLP, the attended sum (dropped out by ``mask``),
        projected."""
        emb, cnt = self._words(params, side, t, idx)
        h = text_cnn(params, "cnn_" + side, emb, self.kernel_sizes)  # (B, R, FK)
        rating_h = self._rating_mlp(params, t[side + "_rows"][idx], side, bn_stats, share)
        a = apply_dense(params, f"att_{side}2", torch.relu(
            apply_dense(params, f"att_{side}1", h * rating_h[:, None, :])))
        att = masked_attention(a, cnt, self.max_num_review)
        o = self._dropout((att * h).sum(1), mask)
        return rating_h, apply_dense(params, "o" + side, o)

    def _predict(self, params, t, u, i, masks, stats=None, share=None):
        """(predictions (B,), pu, qi) for the pairs (u, i); ``masks`` the
        towers' keep masks or None, ``stats`` the population statistics of
        both sides (None: the batch's; ``share``: the whole minibatch's, of
        which (u, i) are a rank's rows)."""
        mu_, mi_ = (None, None) if masks is None else masks
        su, si = (None, None) if stats is None else stats
        ur_h, ou = self._tower(params, t, "u", u, mu_, su, share)
        ir_h, oi = self._tower(params, t, "i", i, mi_, si, share)
        pu = torch.cat([ur_h, ou, gather_rows(params["user_emb"], u)], dim=-1)
        qi = torch.cat([ir_h, oi, gather_rows(params["item_emb"], i)], dim=-1)
        pred = (apply_dense(params, "W1", pu * qi)[:, 0] + gather_rows(params["bu"], u)
                + gather_rows(params["bi"], i) + params["mu"])
        return pred, pu, qi

    def _factor_rows(self, params, t, side, idx, stats):
        rh, o = self._tower(params, t, side, idx, None, stats[0 if side == "u" else 1])
        emb = params["user_emb" if side == "u" else "item_emb"][idx]
        return torch.cat([rh, o, emb], dim=-1)

    def _store_factors(self, P, Q):
        self.P, self.Q = P, Q
