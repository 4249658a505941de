"""SKMeans — spherical k-means recommender (Salah et al., 2016).

Port of ``cornac_tpu/models/skm.py``. The rows of the user-item matrix are
normalised on the host in numpy, as the JAX package does (so both packages
cluster the same float32 X), then the loop runs on the model's device:
centroids = one product (Zᵀ X) normalised, assignment = one product and an
argmax (the first maximum, as ``jnp.argmax``).

The stop is the JAX ``while_loop``'s (``skm.py:31-51``): after each
iteration the float32 likelihood is compared with the previous one, and
the loop ends once they differ by no more than ``tol`` or after
``max_iter`` iterations, so both packages stop at the same iteration with
the same partition. The host checks that every iteration (one read of a
boolean from the card): at the bench shape a fit converges in tens of
iterations of three small launches each, so the read costs less than
running all ``max_iter`` iterations with the state frozen on the card
would (``chip_smoke.py`` phase 12c times the fit).
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.dense_scores import device_dot
from ..ops.dispatch import full_f32
from ..utils import get_rng
from .recommender import Recommender, pad_to_catalog


def _skmeans_iter(X, par, k):
    """(centroids, partition, likelihood) of one spherical k-means step
    from the partition ``par``: X (n, m) float32 with unit rows, par (n,)
    int64 on X's device."""
    Z = torch.nn.functional.one_hot(par, k).to(X.dtype)
    with full_f32():
        MU = Z.T @ X
        MU = MU / (torch.linalg.vector_norm(MU, dim=1, keepdim=True) + 1e-20)
        sim = X @ MU.T  # (n, k)
    return MU, sim.argmax(1), sim.amax(1).sum()


def _skmeans_fit(X, par, k, max_iter, tol, report=None):
    """The whole k-means loop: iterate until the likelihood moves by <=
    ``tol`` (in float32, as the JAX loop's condition) or ``max_iter`` is
    hit. Returns (centroids, partition, likelihood, iterations);
    ``report(it, likelihood)`` is called after each iteration."""
    tol = torch.tensor(tol, dtype=torch.float32, device=X.device)
    l_cur = torch.tensor(float("inf"), device=X.device)
    MU = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    it = 0
    while it < max_iter:
        l_prev = l_cur
        MU, par, l_cur = _skmeans_iter(X, par, k)
        it += 1
        if report is not None:
            report(it, float(l_cur))
        if not bool(torch.abs(l_cur - l_prev) > tol):
            break
    return MU, par, l_cur, it


class SKMeans(Recommender):
    """Cluster users on the unit hypersphere; score by similarity-weighted
    centroid average.

    Parameters mirror the JAX package: ``k``, ``max_iter``, ``tol``,
    ``seed``, ``init_par``. ``device``: where the model trains and scores
    (default: the card).
    """

    def __init__(
        self,
        k=5,
        max_iter=100,
        name="Skmeans",
        trainable=True,
        tol=1e-6,
        verbose=True,
        seed=None,
        init_par=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.init_par = init_par
        self.device = device
        self.centroids = None

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)

        X = np.asarray(train_set.matrix.todense(), dtype=np.float32)
        X = X / (np.linalg.norm(X, axis=1, keepdims=True) + 1e-20)

        if self.trainable:
            n = X.shape[0]
            start = getattr(self, "final_par", self.init_par)
            par = (np.asarray(start) if start is not None
                   else get_rng(self.seed).randint(self.k, size=n))
            dev = self._device()
            report = None
            if self.verbose:
                def report(it, likelihood):
                    print("Iter %i, likelihood: %f" % (it, likelihood))
            MU, par, _, self.n_iter = _skmeans_fit(
                torch.as_tensor(X, device=dev),
                torch.as_tensor(np.asarray(par, np.int64), device=dev),
                self.k, self.max_iter, self.tol, report)
            self.centroids = MU.cpu().numpy().astype(np.float64)
            self.final_par = par.cpu().numpy()
        elif self.verbose:
            print("%s is trained already (trainable = False)" % self.name)

        # user-centroid cosine similarity, used for scoring
        self.user_center_sim = X.astype(np.float64) @ self.centroids.T

        return self

    def _scores_for(self, sims):
        """(B, n_items): similarity-weighted centroid average."""
        weights = sims / (sims.sum(axis=1, keepdims=True) + 1e-20)
        return weights @ self.centroids

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        scores = self._scores_for(self.user_center_sim[user_idx : user_idx + 1])[0]
        return scores if item_idx is None else scores[item_idx]

    def _known_scores_device(self, safe_users, known):
        sims = self.user_center_sim[safe_users]
        weights = sims / (sims.sum(axis=1, keepdims=True) + 1e-20)
        return device_dot(weights, self.centroids.T, self._device())

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._scores_for(self.user_center_sim[np.where(known, users, 0)])
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
