"""NARRE — Neural Attentional Rating Regression with Review-level
Explanations (Chen et al., WWW 2018).

Port of ``cornac_tpu/models/narre.py``: a text CNN over each of an entity's
reviews, review-level attention with the partner's id embedding, a
latent-factor rating head and the mean squared error, trained by Adam or
RMSProp (optax's rules, ``ops.optim``). The reviews are packed once into
``(N, R, L)`` id tensors on the model's device (``review_utils``).

Each epoch takes its draws from one ``torch.Generator`` seeded from (the
fit's seed, the global epoch index): the order (a permutation of |R|
rounded up to whole minibatches, modulo |R|), then each step's dropout keep
masks of the user and the item tower (``draws``), which the loss takes as
arguments, so a test can hand it the JAX key's own. The gradients of the
gathers sum through ``accumulate_rows``; those of the word tables skip the
empty review slots (``review_utils.empty_slot_ids``), whose gradient is
exactly 0. Nothing syncs with the host inside an epoch. After the fit the
towers collapse into factor tables (P = user_emb + X, Q = item_emb + Y), so
scoring is one product.

``mesh`` (``parallel.make_mesh``) trains data-parallel over every rank, as
the JAX package shards each minibatch over all mesh axes: the parameters,
the optimizer's state and the review packs are replicated, the minibatch
is rounded down to a multiple of the mesh's size, and each rank takes its
rows (``parallel.sharded.Share``) with its rows of the dropout masks drawn
for the whole minibatch, its squared errors over the whole minibatch's
count, and ``ops.optim.step`` sums the gradients over every rank. A rank's
gathers sum its rows' gradients in batch order (``accumulate_rows``, the
empty review slots dropped, as on one device). HRDR's batch normalisation
takes the whole minibatch's statistics, the ranks' partial sums summed
forward and backward (``Share.sum``). The sums over the ranks take another
order than one device's backward, so a fit agrees with the plain fit to
float32 rounding, and bit for bit on a mesh of one rank.
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import gather_rows
from ..ops.dense_scores import device_dot
from ..ops.optim import adam, rmsprop, step
from ..parallel.mesh import check_mesh
from ..parallel.sharded import Share, all_sum, round_batch
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from .mf import _epoch_permutation
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog
from .review_utils import (
    apply_dense,
    build_review_tensors,
    empty_slot_ids,
    flatten,
    init_dense_np,
    init_text_cnn,
    masked_attention,
    text_cnn,
)
from .vaecf import batch_mean

CACHE_ROWS = 256  # entities a tower runs at once when it caches or validates


class ReviewRegressor(Recommender, ANNMixin):
    """What NARRE and HRDR share: the constructor, the fit's loop, the
    epoch, validation and scoring of the collapsed factor tables. A
    subclass gives ``_init_all``, ``_tensors``, ``_predict`` and
    ``_factor_rows``."""

    def _setup(self, name, embedding_size, id_embedding_size, n_factors, attention_size,
               kernel_sizes, n_filters, dropout_rate, max_text_length, max_num_review,
               batch_size, max_iter, optimizer, learning_rate, model_selection, user_based,
               init_params, seed, mesh, device):
        self.embedding_size = embedding_size
        self.id_embedding_size = id_embedding_size
        self.n_factors = n_factors
        self.attention_size = attention_size
        self.kernel_sizes = [3] if kernel_sizes is None else list(kernel_sizes)
        self.n_filters = n_filters
        self.dropout_rate = dropout_rate
        self.max_text_length = max_text_length
        self.max_num_review = max_num_review
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.optimizer = optimizer
        self.learning_rate = learning_rate
        self.model_selection = model_selection
        self.user_based = user_based
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.init_params = {} if init_params is None else init_params
        self.losses = {"train_losses": [], "val_losses": []}
        if model_selection not in ("last", "best"):
            raise ValueError("model_selection is either 'last' or 'best'")
        if optimizer not in ("adam", "rmsprop"):
            raise ValueError("optimizer is either 'rmsprop' or 'adam'")

    @property
    def _filters(self):
        return self.n_filters * len(self.kernel_sizes)

    def _word_table(self, rng, n_vocab):
        """The word embeddings: U(-0.5, 0.5), the four special tokens'
        rows zero."""
        word = rng.uniform(-0.5, 0.5, size=(n_vocab, self.embedding_size)).astype(np.float32)
        word[:4] = 0.0
        return word

    def _reviews(self, train_set, dev):
        """The user and item review packs as int64 tensors on ``dev``:
        {"u_rev", "u_ids", "u_cnt", "i_rev", "i_ids", "i_cnt"}."""
        R, L = self.max_num_review, self.max_text_length
        out = {}
        for side, by in (("u", "user"), ("i", "item")):
            for key, a in zip(("rev", "ids", "cnt"),
                              build_review_tensors(train_set, R, L, by=by)):
                out[f"{side}_{key}"] = torch.as_tensor(a.astype(np.int64), device=dev)
        return out

    def _words(self, params, side, t, idx):
        """(B, R, L, E) word embeddings of the reviews of entities ``idx``
        on ``side``, and their counts."""
        rev, cnt = t[side + "_rev"][idx], t[side + "_cnt"][idx]
        word = params["word_" + side]
        grad_ids = empty_slot_ids(rev, cnt, word.shape[0]).reshape(-1)
        emb = gather_rows(word, rev.reshape(-1), grad_ids)
        return emb.reshape(rev.shape + (word.shape[1],)), cnt

    def draws(self, gen, B):
        """A step's dropout keep masks from ``gen``: the user tower's, then
        the item tower's, (B, filters) float32 each; None without dropout."""
        if self.dropout_rate <= 0:
            return None
        keep = 1.0 - self.dropout_rate
        shape = (B, self._filters)
        return tuple((torch.rand(shape, generator=gen, device=gen.device) < keep)
                     .to(torch.float32) for _ in range(2))

    def _dropout(self, o, mask):
        return o if mask is None else o * mask / (1.0 - self.dropout_rate)

    def loss_on(self, params, t, u, i, r, masks, share=None):
        """The mean squared error of the predictions for (u, i) against
        ``r`` with the keep masks ``masks`` (None: no dropout). ``share``
        (``parallel.sharded.Share``): (u, i, r, masks) are a rank's rows of
        a minibatch, and the loss is its share of the minibatch's mean."""
        if share is None:
            return torch.mean((self._predict(params, t, u, i, masks)[0] - r) ** 2)
        pred = self._predict(params, t, u, i, masks, share=share)[0]
        return batch_mean((pred - r) ** 2, share.n)

    def epoch(self, params, opt, opt_state, t, order, data, step_draws, batch_size):
        """One epoch of optimizer steps in the order ``order`` ((n_total,)
        int64 indices into the ratings ``data`` = (users, items, values)),
        each step's keep masks from ``step_draws(B)``, updating ``params`` in
        place. Returns (the new state, the summed loss, a device scalar).
        On a mesh each rank takes its share of every minibatch (module
        docstring)."""
        users, items, values = data
        loss_sum = torch.zeros((), dtype=torch.float32, device=order.device)
        mesh = self.mesh
        share = None if mesh is None else Share(mesh, batch_size)
        for s in range(0, order.shape[0], batch_size):
            idx = order[s: s + batch_size]
            masks = step_draws(idx.shape[0])
            if share is None:  # loss_on's six arguments, as callers wrap it
                loss = self.loss_on(params, t, users[idx], items[idx], values[idx], masks)
            else:
                idx = share.take(idx)
                masks = None if masks is None else tuple(share.take(m) for m in masks)
                loss = self.loss_on(params, t, users[idx], items[idx], values[idx], masks, share)
            opt_state = step(params, opt, opt_state, loss, mesh, None)
            loss_sum += loss.detach()
        if mesh is not None:  # the ranks' shares make the minibatches' losses
            all_sum(mesh, loss_sum, None)
        return opt_state, loss_sum

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.review_text is None:
            raise ValueError(f"{self.name} requires a review_text (ReviewModality)")
        if not self.trainable:
            return self

        rng = get_rng(self.seed)
        self._vocab = train_set.review_text.vocab
        dev = self._device()
        params = {name: torch.tensor(np.asarray(a, np.float32), device=dev, requires_grad=True)
                  for name, a in self._init_all(rng, self._vocab.size).items()}
        t = self._tensors(train_set, dev)
        uid, iid, rating = train_set.uir_tuple
        n = len(uid)
        bsz = round_batch(self.mesh, min(self.batch_size, n))
        n_total = n + (-n) % bsz
        n_batches = n_total // bsz
        data = (torch.as_tensor(np.asarray(uid, np.int64), device=dev),
                torch.as_tensor(np.asarray(iid, np.int64), device=dev),
                torch.as_tensor(np.asarray(rating, np.float32), device=dev))
        opt = (adam if self.optimizer == "adam" else rmsprop)(self.learning_rate)
        opt_state = opt.init(params)
        seed = rng.randint(2**31)

        track_best = val_set is not None and self.model_selection == "best"
        best_loss, best_params = np.inf, None
        for e in range(self.max_iter):
            gen = epoch_generator(seed, e, dev)
            order = _epoch_permutation(n_total, gen) % n
            opt_state, loss = self.epoch(params, opt, opt_state, t, order, data,
                                         lambda B: self.draws(gen, B), bsz)
            if not (track_best or self.verbose):
                continue
            self.losses["train_losses"].append(float(loss) / n_batches)
            if track_best:
                vmse = self._val_mse(params, t, val_set)
                self.losses["val_losses"].append(vmse)
                if vmse < best_loss:
                    best_loss = vmse
                    best_params = {k: p.detach().clone() for k, p in params.items()}
                    self.best_epoch = e + 1
            if self.verbose:
                print("Epoch %d/%d, loss: %.4f" % (e + 1, self.max_iter, float(loss) / n_batches))
        if best_params is not None:
            params = best_params

        self.params = {k: p.detach() for k, p in params.items()}
        self._cache_factors(t)
        return self

    def _eval_stats(self, params, t):
        """What the towers need outside training (HRDR's population
        statistics; NARRE's none)."""
        return None

    @torch.no_grad()
    def _val_mse(self, params, t, val_set):
        vu, vi, vr = val_set.uir_tuple
        dev = t["u_rev"].device
        stats = self._eval_stats(params, t)
        pred = []
        for s in range(0, len(vu), CACHE_ROWS):
            u = torch.as_tensor(np.asarray(vu[s: s + CACHE_ROWS], np.int64), device=dev)
            i = torch.as_tensor(np.asarray(vi[s: s + CACHE_ROWS], np.int64), device=dev)
            pred.append(self._predict(params, t, u, i, None, stats)[0])
        pred = torch.cat(pred).cpu().numpy() if pred else np.zeros(0, np.float32)
        return float(np.mean((pred - np.asarray(vr, np.float32)) ** 2))

    @torch.no_grad()
    def _cache_factors(self, t):
        """Collapse the towers into the factor tables P and Q (reference
        ``get_weights``), in chunks of ``CACHE_ROWS`` entities."""
        params = self.params
        stats = self._eval_stats(params, t)
        if stats is not None:  # HRDR's population statistics, kept
            self.bn_stats = tuple(tuple(x.cpu().numpy() for x in side) for side in stats)
        dev = t["u_rev"].device
        tables = []
        for side, count in (("u", self.num_users), ("i", self.num_items)):
            rows = [self._factor_rows(params, t, side,
                                      torch.arange(s, min(s + CACHE_ROWS, count), device=dev),
                                      stats)
                    for s in range(0, count, CACHE_ROWS)]
            tables.append(torch.cat(rows).cpu().numpy())
        self._store_factors(*tables)
        self.W1 = params["W1.w"][:, 0].cpu().numpy()
        self.bu = params["bu"].cpu().numpy()
        self.bi = params["bi"].cpu().numpy()
        self.mu = float(params["mu"])

    # ------------------------------------------------------------- scoring
    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        h0 = self.P[user_idx] * self.Q
        scores = h0 @ self.W1 + self.bu[user_idx] + self.bi + self.mu
        return scores if item_idx is None else float(scores[item_idx])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        safe = np.where(known, users, 0)
        scores = ((self.P[safe] * self.W1[None, :]) @ self.Q.T + self.bu[safe][:, None]
                  + self.bi[None, :] + self.mu).astype(np.float64)
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def _known_scores_device(self, safe_users, known):
        return device_dot(self.get_user_vectors()[safe_users], self.get_item_vectors(),
                          self._device())

    def score_pairs(self, user_indices, item_indices):
        """``score(u, i)`` for aligned pairs at once, the same product per
        pair; unknown users or items get ``default_score()``."""
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        u, i = np.where(known, users, 0), np.where(known, items, 0)
        preds = (self.P[u] * self.Q[i]) @ self.W1 + self.bu[u] + self.bi[i] + self.mu
        return np.where(known, preds, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return np.concatenate([self.P, self.bu[:, None], np.ones((self.num_users, 1))], axis=1)

    def get_item_vectors(self):
        return np.concatenate([self.Q * self.W1[None, :], np.ones((self.num_items, 1)),
                               self.bi[:, None] + self.mu], axis=1)


class NARRE(ReviewRegressor):
    """Review-attention rating regressor.

    Parameters mirror the JAX package: ``embedding_size``,
    ``id_embedding_size``, ``n_factors``, ``attention_size``,
    ``kernel_sizes``, ``n_filters``, ``dropout_rate``, ``max_text_length``,
    ``max_num_review``, ``batch_size``, ``max_iter``, ``optimizer`` ('adam'
    or 'rmsprop'), ``learning_rate``, ``model_selection`` ('last' or
    'best'), ``user_based``, ``init_params`` ({'pretrained_word_embeddings':
    {token: vector}}), ``seed``. ``device``: where the model trains and
    scores (default: the card). ``mesh``: a ``parallel.make_mesh`` mesh;
    every rank calls ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="NARRE",
        embedding_size=100,
        id_embedding_size=32,
        n_factors=32,
        attention_size=16,
        kernel_sizes=None,
        n_filters=64,
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

    def _init_all(self, rng, n_vocab):
        """The initial parameters as a flat dict of float32 arrays, drawn
        from ``rng`` in the JAX package's order."""
        E, D, F = self.embedding_size, self.id_embedding_size, self.n_filters
        FK = self._filters
        word = self._word_table(rng, n_vocab)
        pre = self.init_params.get("pretrained_word_embeddings")
        if pre is not None:
            for tok, idx in self._vocab.tok2idx.items():
                vec = pre.get(tok)
                if vec is not None:
                    word[idx] = vec

        def uni(*shape):
            return rng.uniform(-0.05, 0.05, size=shape).astype(np.float32)

        tree = {"word_u": word, "word_i": word.copy()}
        tree["iid_emb"] = uni(self.num_items, D)
        tree["uid_emb"] = uni(self.num_users, D)
        tree["user_emb"] = uni(self.num_users, D)
        tree["item_emb"] = uni(self.num_items, D)
        tree["bu"] = np.full((self.num_users,), 0.1, np.float32)
        tree["bi"] = np.full((self.num_items,), 0.1, np.float32)
        tree["mu"] = np.float32(self.global_mean)
        tree["cnn_u"] = init_text_cnn(rng, E, self.kernel_sizes, F)
        tree["cnn_i"] = init_text_cnn(rng, E, self.kernel_sizes, F)
        tree["att_u1"] = init_dense_np(rng, FK + D, self.attention_size)
        tree["att_u2"] = init_dense_np(rng, self.attention_size, 1)
        tree["att_i1"] = init_dense_np(rng, FK + D, self.attention_size)
        tree["att_i2"] = init_dense_np(rng, self.attention_size, 1)
        tree["Xu"] = init_dense_np(rng, FK, self.n_factors)
        tree["Yi"] = init_dense_np(rng, FK, self.n_factors)
        tree["W1"] = init_dense_np(rng, self.n_factors, 1, bias=False)
        return flatten(tree)

    def _tensors(self, train_set, dev):
        return self._reviews(train_set, dev)

    def _tower(self, params, t, side, idx, mask):
        """(B, n_factors): the side's text tower for entities ``idx``: the
        CNN over each review, attention with the partner's id embedding, the
        attended sum (dropped out by ``mask``), projected."""
        emb, cnt = self._words(params, side, t, idx)
        h = text_cnn(params, "cnn_" + side, emb, self.kernel_sizes)  # (B, R, FK)
        ids = t[side + "_ids"][idx]
        partner = params["iid_emb" if side == "u" else "uid_emb"]
        grad_ids = empty_slot_ids(ids, cnt, partner.shape[0]).reshape(-1)
        p = gather_rows(partner, ids.reshape(-1), grad_ids).reshape(
            ids.shape + (partner.shape[1],))
        a_in = torch.cat([h, p], dim=-1)
        a = apply_dense(params, f"att_{side}2",
                        torch.relu(apply_dense(params, f"att_{side}1", a_in)))
        att = masked_attention(a, cnt, self.max_num_review)
        o = self._dropout((att * h).sum(1), mask)
        return apply_dense(params, "Xu" if side == "u" else "Yi", o)

    def _predict(self, params, t, u, i, masks, stats=None, share=None):
        """(predictions (B,),) for the pairs (u, i); ``masks`` the two
        towers' keep masks or None. A pair's prediction is its own, so a
        rank's share of a minibatch needs nothing of the others'
        (``share``)."""
        mu_, mi_ = (None, None) if masks is None else masks
        Xu = self._tower(params, t, "u", u, mu_)
        Yi = self._tower(params, t, "i", i, mi_)
        h0 = (gather_rows(params["user_emb"], u) + Xu) * (gather_rows(params["item_emb"], i) + Yi)
        return (apply_dense(params, "W1", h0)[:, 0] + gather_rows(params["bu"], u)
                + gather_rows(params["bi"], i) + params["mu"]),

    def _factor_rows(self, params, t, side, idx, stats):
        return self._tower(params, t, side, idx, None)

    def _store_factors(self, X, Y):
        self.X, self.Y = X, Y
        self.P = self.params["user_emb"].cpu().numpy() + X
        self.Q = self.params["item_emb"].cpu().numpy() + Y
