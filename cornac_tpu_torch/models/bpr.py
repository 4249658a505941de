"""BPR — Bayesian Personalized Ranking (Rendle et al., UAI 2009) + WBPR.

Port of ``cornac_tpu/models/bpr.py``, serving side: the constructor,
seeded initialisation, ``fit`` with ``trainable=False`` (which only
captures the train set and initialises, or keeps, the factors) and every
scoring and vector method. Factors are persisted as numpy, as in the JAX
package; their device copies are process-local and rebuilt on demand. The
trainer (``_bpr_epochs`` with its membership rejection and deterministic
row accumulation) is the next slice of the port (ROADMAP.md, section A).
"""

import numpy as np
import torch

from ..utils import get_rng
from ..utils.init_utils import uniform, zeros
from .recommender import ANNMixin, MEASURE_DOT, Recommender

DTYPE = np.float32


def _dot_scores(U, V, Bi, users):
    return Bi[None, :] + U[users] @ V.T


class BPR(Recommender, ANNMixin):
    """BPR recommender.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``lambda_reg``, ``use_bias``, ``init_params``
    ({'U','V','Bi'}), ``seed``, ``batch_size``. ``device``: where scoring
    runs (default: the card; ``"cpu"`` asks for the CPU).
    """

    def __init__(
        self,
        name="BPR",
        k=10,
        max_iter=100,
        learning_rate=0.001,
        lambda_reg=0.01,
        use_bias=True,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.device = device
        self.k = int(k)
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.lambda_reg = lambda_reg
        self.use_bias = use_bias
        # reference OpenMP knob, accepted so reference scripts run unchanged
        self.num_threads = num_threads
        self.batch_size = batch_size
        self.seed = seed
        self.rng = get_rng(seed)

        self.init_params = {} if init_params is None else init_params
        self.u_factors = self.init_params.get("U", None)
        self.i_factors = self.init_params.get("V", None)
        self.i_biases = self.init_params.get("Bi", None)
        self.ignored_attrs.append("_factors_d")

    def _init(self):
        # full-table init over total entities: unknown users/items keep
        # their initial vectors, as in the JAX package
        n_users, n_items = self.total_users, self.total_items
        if self.u_factors is None:
            self.u_factors = (
                uniform((n_users, self.k), random_state=self.rng, dtype=DTYPE) - 0.5
            ) / self.k
        if self.i_factors is None:
            self.i_factors = (
                uniform((n_items, self.k), random_state=self.rng, dtype=DTYPE) - 0.5
            ) / self.k
        if self.i_biases is None or self.use_bias is False:
            self.i_biases = zeros(n_items, dtype=DTYPE)

    def fit(self, train_set, val_set=None):
        if self.trainable:
            raise NotImplementedError(
                f"{type(self).__name__} training is not ported yet: it is the BPR "
                "trainer slice of ROADMAP.md (section A). Pass trainable=False "
                "with init_params to serve given factors."
            )
        Recommender.fit(self, train_set, val_set)
        self._init()
        return self

    def _device_factors(self):
        """(U, V, Bi) float32 tensors on the model's device, rebuilt when
        the numpy factors were replaced or the device changed."""
        dev = self._device()
        srcs = (self.u_factors, self.i_factors, self.i_biases)
        cached = getattr(self, "_factors_d", None)
        if (
            cached is None
            or cached[0] != dev
            or any(a is not b for a, b in zip(cached[1], srcs))
        ):
            tensors = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in srcs
            )
            cached = self._factors_d = (dev, srcs, tensors)
        return cached[2]

    # ------------------------------------------------------------------ #
    # scoring
    # ------------------------------------------------------------------ #
    def score(self, user_idx, item_idx=None):
        if item_idx is None:
            return self.i_biases + self.i_factors @ self.u_factors[user_idx]
        return self.i_biases[item_idx] + np.dot(
            self.u_factors[user_idx], self.i_factors[item_idx]
        )

    def score_batch(self, user_indices):
        return self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)

    def score_batch_device(self, user_indices):
        U, V, Bi = self._device_factors()
        users = torch.as_tensor(np.asarray(user_indices), dtype=torch.long, device=U.device)
        return _dot_scores(U, V, Bi, users)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        return self.i_biases[items] + np.sum(
            self.u_factors[users] * self.i_factors[items], axis=1
        )

    # ------------------------------------------------------------------ #
    # ANN vectors
    # ------------------------------------------------------------------ #
    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return np.concatenate(
            (self.u_factors, np.ones([self.u_factors.shape[0], 1])), axis=1
        )

    def get_item_vectors(self):
        return np.concatenate(
            (self.i_factors, self.i_biases.reshape((-1, 1))), axis=1
        )


class WBPR(BPR):
    """Weighted BPR (Gantner et al.): negatives sampled by popularity. Only
    training differs from BPR, and training comes with the trainer slice."""

    def __init__(
        self,
        name="WBPR",
        k=10,
        max_iter=100,
        learning_rate=0.001,
        lambda_reg=0.01,
        use_bias=True,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        device=None,
    ):
        super().__init__(
            name=name,
            k=k,
            max_iter=max_iter,
            learning_rate=learning_rate,
            lambda_reg=lambda_reg,
            use_bias=use_bias,
            num_threads=num_threads,
            batch_size=batch_size,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            device=device,
        )
