"""CTR — Collaborative Topic Regression (Wang & Blei, KDD 2011).

Port of ``cornac_tpu/models/ctr.py``: coordinate ascent of
confidence-weighted ALS for (U, V), the item side pulled toward the items'
topic proportions ``theta``, and an LDA step for ``theta`` and the topics
``beta``. The ALS half-sweeps run on the model's device as batched k x k
solves in float32 (``cvae.weighted_als``); the LDA step stays a host loop
over the items in float64 (per-item responsibilities and a projected
gradient step on the simplex with backtracking), as in the JAX package, so
each iteration copies V to the host once. The whole fit follows the JAX
fit.

``mesh`` (``parallel.make_mesh``), as in the JAX package: the ALS rows are
split over "data" (``weighted_als(mesh=)``); each row is its own k x k
solve, so every layout gives the plain fit's bits. The LDA step stays on
the host, the same on every rank.
"""

import numpy as np
import torch

from ..parallel.mesh import check_mesh
from ..utils import get_rng
from .cdl import _FactorScores, require_text
from .cvae import padded_layouts, weighted_als
from .recommender import Recommender

EPS = 1e-100


def _simplex_project(v, s=1.0):
    """The Euclidean projection of ``v`` onto the simplex of sum ``s``."""
    if v.sum() < s + 1e-10 and np.all(v > 0):
        return v
    u = np.sort(v)[::-1]
    cssv = np.cumsum(u)
    rho = np.nonzero(u * np.arange(1, len(v) + 1) > (cssv - s))[0][-1]
    theta = (cssv[rho] - s) / (rho + 1.0)
    return (v - theta).clip(min=0)


def _f_simplex(gamma, v, lambda_v, x):
    return 0.5 * lambda_v * np.dot(v - x, v - x) - np.sum(gamma * np.log(np.maximum(x, EPS)))


def _optimize_simplex(gamma, v, lambda_v, opt_x, s=1.0):
    """A projected-gradient step with backtracking (reference ctr.py:55-81)."""
    opt_x_old = np.copy(opt_x)
    f_old = _f_simplex(gamma, v, lambda_v, opt_x)
    df = lambda_v * (opt_x - v) - gamma.sum(axis=0) / np.maximum(opt_x, EPS)
    ab_sum = np.sum(np.abs(df))
    if ab_sum > 1.0:
        df /= ab_sum
    opt_x = opt_x - df
    x_bar = _simplex_project(opt_x, s) - opt_x_old
    r = 0.5 * np.dot(df, x_bar)
    t = 0.5
    f_new = f_old
    for _ in range(100):
        opt_x = opt_x_old + t * x_bar
        f_new = _f_simplex(gamma, v, lambda_v, opt_x)
        if f_new > f_old + r * t:
            t *= 0.5
        else:
            break
    return opt_x, f_new


def lda_step(theta, beta, V, bow, lambda_v, eta):
    """The LDA half of an iteration on the host (float64): each item's word
    responsibilities, its simplex step toward V's row, and the topics
    re-estimated from the responsibilities. Updates ``theta`` in place and
    returns the new ``beta``."""
    phi_sum = np.zeros_like(beta) + eta
    for vi in range(theta.shape[0]):
        s, e = bow.indptr[vi], bow.indptr[vi + 1]
        if s == e:
            continue
        w = bow.indices[s:e]
        phi = theta[vi] * beta[w, :] + 1e-100
        phi = phi / phi.sum(1, keepdims=True)
        gamma = bow.data[s:e][:, None] * phi
        theta[vi], _ = _optimize_simplex(gamma=gamma, v=V[vi], lambda_v=lambda_v,
                                         opt_x=theta[vi])
        phi_sum[w, :] += gamma
    return phi_sum / phi_sum.sum(0)


class CTR(_FactorScores):
    """LDA-regularised weighted MF over item text.

    Parameters mirror the JAX package: ``k``, ``lambda_u``, ``lambda_v``,
    ``eta``, ``a``, ``b``, ``max_iter``, ``init_params`` ({'U', 'V'}),
    ``seed``. ``device``: where the ALS solves run and the model scores
    (default: the card). ``mesh``: a ``parallel.make_mesh`` mesh; every
    rank calls ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="CTR",
        k=200,
        lambda_u=0.01,
        lambda_v=0.01,
        eta=0.01,
        a=1,
        b=0.01,
        max_iter=100,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.eta = eta
        self.a = a
        self.b = b
        self.max_iter = max_iter
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.V = self.init_params.get("V", None)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        require_text(train_set)
        rng = get_rng(self.seed)
        if self.U is None:
            self.U = rng.random_sample((self.num_users, self.k))
        if self.V is None:
            self.V = rng.random_sample((self.num_items, self.k))
        if not self.trainable:
            return self

        theta = rng.random_sample((self.num_items, self.k))
        theta = theta / theta.sum(1, keepdims=True)
        n_vocab = train_set.item_text.vocab.size
        beta = rng.random_sample((n_vocab, self.k))
        beta = beta / beta.sum(0)
        bow = train_set.item_text.batch_bow(np.arange(self.num_items), keep_sparse=True).tocsr()
        dev = self._device()
        u_pad, i_pad = padded_layouts(train_set.matrix, dev)

        def on_dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        for it in range(self.max_iter):
            U = weighted_als(on_dev(self.V), u_pad, self.a, self.b, self.lambda_u,
                             mesh=self.mesh)
            self.U = U.cpu().numpy().astype(np.float64)
            V = weighted_als(U, i_pad, self.a, self.b, self.lambda_v, prior=on_dev(theta),
                             mesh=self.mesh)
            self.V = V.cpu().numpy().astype(np.float64)
            beta = lda_step(theta, beta, self.V, bow, self.lambda_v, self.eta)
            if self.verbose:
                print("Iter %d/%d done" % (it + 1, self.max_iter))

        self.theta, self.beta = theta, beta
        return self
