"""HFT — Hidden Factors and Hidden Topics (McAuley & Leskovec, RecSys 2013).

Port of ``cornac_tpu/models/hft.py``. The fit is host code in both
packages: numpy and scipy in float64, the topic draws from the fit's numpy
generator (a vectorised Gibbs sweep: the sampling distribution depends only
on the current parameters, so every word is drawn at once) and L-BFGS
(``scipy.optimize.fmin_l_bfgs_b``) over the rating and corpus objective,
with segment sums for its gradient. The port keeps that fit as its own
copy, so a seeded fit is the JAX package's, bit for bit. Only the fitted
tables go to the model's device, in float64, where ``score``,
``score_batch`` and ``score_pairs`` run; ``recommend_batch`` ranks their
vectors through ``fused_topk``.
"""

import numpy as np
import scipy.optimize as opt
import torch

from ..exception import ScoreException
from ..utils import get_rng
from ..utils.init_utils import normal
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def hft_fit(model, train_set):
    """The JAX package's ``_fit_hft``: returns the fitted (alpha, beta_u,
    beta_i, gamma_u, gamma_i) from ``model``'s initial values, options and
    seed."""
    rng = get_rng(model.seed)
    k, num_users, num_items = model.k, model.num_users, model.num_items

    bow = train_set.item_text.batch_bow(np.arange(num_items), keep_sparse=True).tocsr()
    n_vocab = bow.shape[1]

    # flattened corpus: one entry per (item, unique word) pair
    doc_item = np.repeat(np.arange(num_items), np.diff(bow.indptr))
    doc_word = bow.indices.astype(np.int64)
    total_words = len(doc_word)
    if total_words == 0:
        raise ValueError("Empty corpus: no item text available.")

    item_word_cnt = np.diff(bow.indptr).astype(np.float64)[:, None]

    # initial random topic assignment + count tables
    topics = rng.randint(k, size=total_words)
    word_topic_cnt = np.zeros((n_vocab, k))
    np.add.at(word_topic_cnt, (doc_word, topics), 1)
    item_topic_cnt = np.zeros((num_items, k))
    np.add.at(item_topic_cnt, (doc_item, topics), 1)
    topic_cnt = np.bincount(topics, minlength=k).astype(np.float64)[None, :]
    background_word = np.zeros((n_vocab, 1))
    np.add.at(background_word, (doc_word,), 1)
    background_word /= total_words

    u_idx, i_idx, r_val = train_set.uir_tuple
    kappa = 1.0
    bounds = np.cumsum([1, 1, num_users, num_items, num_users * k, num_items * k])

    def pack(alpha, kap, beta_u, beta_i, gamma_u, gamma_i, topic_word):
        return np.concatenate([[alpha], [kap], beta_u, beta_i, gamma_u.ravel(),
                               gamma_i.ravel(), topic_word.ravel()])

    def unpack(x):
        return (x[0], x[1], x[bounds[1]: bounds[2]], x[bounds[2]: bounds[3]],
                x[bounds[3]: bounds[4]].reshape(num_users, k),
                x[bounds[4]: bounds[5]].reshape(num_items, k),
                x[bounds[5]:].reshape(n_vocab, k))

    params = pack(model.alpha, kappa, model.beta_u, model.beta_i, model.gamma_u, model.gamma_i,
                  np.zeros((n_vocab, k)))

    def objective(x):
        alpha, _, beta_u, beta_i, gamma_u, gamma_i, t_word = unpack(x)
        grad = np.zeros_like(x)
        _, _, dbeta_u, dbeta_i, dgamma_u, dgamma_i, dt_word = unpack(grad)

        pred = alpha + beta_u[u_idx] + beta_i[i_idx] + np.sum(gamma_u[u_idx] * gamma_i[i_idx],
                                                               axis=1)
        err = pred - r_val
        cf_loss = np.sum(err ** 2)

        dalpha = 2 * np.sum(err)
        np.add.at(dbeta_u, u_idx, 2 * err)
        np.add.at(dbeta_i, i_idx, 2 * err)
        np.add.at(dgamma_u, u_idx, 2 * err[:, None] * gamma_i[i_idx])
        np.add.at(dgamma_i, i_idx, 2 * err[:, None] * gamma_u[u_idx])

        reg_loss = 0.0
        if model.l2_reg > 0:
            reg_loss = model.l2_reg * (np.sum(gamma_u ** 2) + np.sum(gamma_i ** 2))
            dgamma_u += 2 * model.l2_reg * gamma_u
            dgamma_i += 2 * model.l2_reg * gamma_i

        # kappa here is the fixed 1.0, not the packed entry: the JAX
        # package's objective reads it so, and the fit follows it
        e_theta = np.exp(kappa * gamma_i)
        t_z = e_theta.sum(axis=1, keepdims=True)
        corpus_ll = model.lambda_text * np.sum(item_topic_cnt * (kappa * gamma_i - np.log(t_z)))
        e_phi = np.exp(background_word + t_word)
        word_z = e_phi.sum(axis=0, keepdims=True)
        corpus_ll += model.lambda_text * np.sum(
            word_topic_cnt * (background_word + t_word - np.log(word_z)))

        q = -model.lambda_text * (item_topic_cnt - item_word_cnt * e_theta / t_z)
        dgamma_i += kappa * q
        dkappa = np.sum(gamma_i * q)
        dt_word += -model.lambda_text * (word_topic_cnt - topic_cnt * e_phi / word_z)

        grad[0] = dalpha
        grad[1] = dkappa
        return cf_loss + reg_loss - corpus_ll, grad

    for it in range(model.max_iter):
        # the parallel Gibbs sweep: the scores do not depend on the counts
        _, kap, _, _, _, gamma_i, t_word = unpack(params)
        logits = kap * gamma_i[doc_item] + background_word[doc_word] + t_word[doc_word]
        logits -= logits.max(axis=1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(axis=1, keepdims=True)
        cdf = probs.cumsum(axis=1)
        draws = rng.rand(total_words, 1)
        topics = (draws > cdf).sum(axis=1)

        word_topic_cnt.fill(0)
        np.add.at(word_topic_cnt, (doc_word, topics), 1)
        item_topic_cnt.fill(0)
        np.add.at(item_topic_cnt, (doc_item, topics), 1)
        topic_cnt = np.bincount(topics, minlength=k).astype(np.float64)[None, :]

        # re-centre topic_word into the background (reference hft.py:152-155)
        avg = t_word.sum(axis=1, keepdims=True) / k
        t_word = t_word - avg
        background_word = background_word + avg
        params = pack(*unpack(params)[:6], t_word)

        res = opt.fmin_l_bfgs_b(objective, x0=params, maxiter=model.grad_iter)
        params = res[0]
        if model.verbose:
            print("Iter %d/%d, loss: %.2f" % (it + 1, model.max_iter, res[1]))

    alpha, _, beta_u, beta_i, gamma_u, gamma_i, _ = unpack(params)
    return float(alpha), beta_u, beta_i, gamma_u, gamma_i


class HFT(Recommender, ANNMixin):
    """Topic-coupled biased MF over item review text.

    Parameters mirror the JAX package: ``k``, ``max_iter``, ``grad_iter``,
    ``lambda_text``, ``l2_reg``, ``vocab_size``, ``init_params`` ({'alpha',
    'beta_u', 'beta_i', 'gamma_u', 'gamma_i'}), ``seed``. ``device``: where
    the fitted tables live and the model scores (default: the card).
    ``mesh`` (which the JAX package's HFT does not take) is refused.
    """

    def __init__(
        self,
        name="HFT",
        k=10,
        max_iter=50,
        grad_iter=50,
        lambda_text=0.1,
        l2_reg=0.001,
        vocab_size=8000,
        init_params=None,
        trainable=True,
        verbose=True,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(
                f"{name}(mesh=...) is refused: the JAX package's HFT constructor "
                "(cornac_tpu.models.HFT) takes no mesh")
        self.mesh = mesh
        self.k = k
        self.max_iter = max_iter
        self.grad_iter = grad_iter
        self.lambda_text = lambda_text
        self.l2_reg = l2_reg
        self.vocab_size = vocab_size
        self.seed = seed
        self.device = device
        self.ignored_attrs.append("_tables")

        self.init_params = {} if init_params is None else init_params
        self.alpha = self.init_params.get("alpha", None)
        self.beta_u = self.init_params.get("beta_u", None)
        self.beta_i = self.init_params.get("beta_i", None)
        self.gamma_u = self.init_params.get("gamma_u", None)
        self.gamma_i = self.init_params.get("gamma_i", None)

    def _init(self):
        rng = get_rng(self.seed)
        if self.alpha is None:
            self.alpha = self.global_mean
        if self.beta_u is None:
            self.beta_u = normal(self.num_users, std=0.01, random_state=rng)
        if self.beta_i is None:
            self.beta_i = normal(self.num_items, std=0.01, random_state=rng)
        if self.gamma_u is None:
            self.gamma_u = normal((self.num_users, self.k), std=0.01, random_state=rng)
        if self.gamma_i is None:
            self.gamma_i = normal((self.num_items, self.k), std=0.01, random_state=rng)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.item_text is None:
            raise ValueError("this model needs the item_text modality attached to the eval method")
        self._init()
        if self.trainable:
            self.alpha, self.beta_u, self.beta_i, self.gamma_u, self.gamma_i = hft_fit(
                self, train_set)
        self._tables = None
        return self

    def _on_device(self):
        """(beta_u, beta_i, gamma_u, gamma_i) as float64 tensors on the
        model's device, copied once after a fit."""
        if getattr(self, "_tables", None) is None:
            dev = self._device()
            self._tables = tuple(torch.as_tensor(np.asarray(a, np.float64), device=dev)
                                 for a in (self.beta_u, self.beta_i, self.gamma_u, self.gamma_i))
        return self._tables

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        bu, bi, gu, gi = self._on_device()
        if item_idx is None:
            return (self.alpha + bu[user_idx] + bi + gi @ gu[user_idx]).cpu().numpy()
        return float(self.alpha + bu[user_idx] + bi[item_idx] + gi[item_idx] @ gu[user_idx])

    def _scores_device(self, safe_users):
        """(B, items) float64 scores of the users ``safe_users`` on the
        model's device."""
        bu, bi, gu, gi = self._on_device()
        u = torch.as_tensor(np.asarray(safe_users, np.int64), device=bu.device)
        return self.alpha + bu[u][:, None] + bi[None, :] + gu[u] @ gi.T

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._scores_device(np.where(known, users, 0)).cpu().numpy()
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        bu, bi, gu, gi = self._on_device()
        u = torch.as_tensor(np.where(known, users, 0).astype(np.int64), device=bu.device)
        i = torch.as_tensor(np.where(known, items, 0).astype(np.int64), device=bu.device)
        preds = (self.alpha + bu[u] + bi[i] + (gu[u] * gi[i]).sum(1)).cpu().numpy()
        return np.where(known, preds, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return np.concatenate(
            (self.gamma_u, self.beta_u.reshape(-1, 1), np.ones((self.num_users, 1))), axis=1)

    def get_item_vectors(self):
        return np.concatenate(
            (self.gamma_i, np.ones((self.num_items, 1)), self.beta_i.reshape(-1, 1)), axis=1)
