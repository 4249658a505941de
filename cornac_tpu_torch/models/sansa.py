"""SANSA — scalable EASE with a sparse approximate inverse
(Spišák et al., RecSys 2023).

Port of ``cornac_tpu/models/sansa.py``:

1. (ICF only) equilibrate the Gramian by fourth-root column norms,
2. fill-reducing permutation + LDL^T factorization pruned to
   ``weight_matrix_density`` — incomplete with on-the-fly pruning
   (``factorizer_class="ICF"``, with the diagonal-shift breakdown
   escalation) or exact-then-pruned (``"CHOLMOD"`` semantics),
3. UMR approximate inverse of the unit lower-triangular factor,
4. the factored EASE weights ``W1 = W.T``, ``W2 = -W/d/diag``.

Steps 1-4 are the host float64 set-up of the JAX package, in the port's
own copy of ``ops/sparse_chol.py``, so W1 and W2 are the JAX package's bit
for bit (the reference's design: a sequential chain of columns, where its
CHOLMOD/ICF run). Scoring runs on the model's device: W1ᵀ and W2ᵀ are
float64 sparse CSR tensors there, and ``forward`` multiplies a batch of
interaction rows through them with ``torch.sparse`` (the JAX package does
this product on the host with scipy; no TPU kernel is involved).
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..exception import ScoreException
from ..ops.sparse_chol import (
    equilibrate_columns,
    exact_ldlt_pruned,
    icf_ldlt,
    rcm_permutation,
    umr_inverse,
)
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def _csr_tensor(M, device):
    """A scipy matrix as a float64 sparse CSR tensor on ``device``."""
    M = sp.csr_matrix(M, dtype=np.float64)
    return torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr.astype(np.int64), device=device),
        torch.as_tensor(M.indices.astype(np.int64), device=device),
        torch.as_tensor(M.data, device=device), size=M.shape)


class SANSA(Recommender, ANNMixin):
    """Sparse item-item linear autoencoder with factored weights
    ``score(X) = X @ W1 @ W2`` where ``W1 @ W2 = B_EASE - I`` approximately
    (the -I only shifts already-seen items, which ranking excludes).

    Parameters mirror the JAX package; ``device``: where the model scores
    (default: the card).
    """

    def __init__(
        self,
        name="SANSA",
        l2=1.0,
        weight_matrix_density=1e-3,
        compute_gramian=True,
        factorizer_class="ICF",
        factorizer_shift_step=1e-3,
        factorizer_shift_multiplier=2.0,
        inverter_scans=3,
        inverter_finetune_steps=10,
        use_absolute_value_scores=False,
        trainable=True,
        verbose=True,
        seed=None,
        W1=None,
        W2=None,
        X=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.l2 = l2
        self.weight_matrix_density = weight_matrix_density
        self.compute_gramian = compute_gramian
        self.factorizer_class = factorizer_class
        self.factorizer_shift_step = factorizer_shift_step
        self.factorizer_shift_multiplier = factorizer_shift_multiplier
        self.inverter_scans = inverter_scans
        self.inverter_finetune_steps = inverter_finetune_steps
        self.use_absolute_value_scores = use_absolute_value_scores
        self.seed = seed
        self.device = device
        self.ignored_attrs += ["_weights_d"]
        # pre-fitted construction: weights[0]/weights[1] sparse factors and
        # the interaction matrix
        self.X = X.astype(np.float32) if X is not None and X.dtype != np.float32 else X
        self.weights = (W1, W2)
        self._W_cache = None
        if W1 is not None and W2 is not None:
            self.U = self.X

    @property
    def W1(self):
        return self.weights[0]

    @property
    def W2(self):
        return self.weights[1]

    @property
    def W(self):
        """Materialized item-item weight matrix (lazy; only needed by the
        ANN item-vector API — scoring stays in the factored form)."""
        if self._W_cache is None and self.weights[0] is not None:
            self._W_cache = (self.weights[0] @ self.weights[1]).tocsr()
        return self._W_cache

    def _device_weights(self):
        """(W1ᵀ, W2ᵀ) as float64 CSR tensors on the model's device: made
        once per set of weights and device."""
        dev = self._device()
        cached = getattr(self, "_weights_d", None)
        if cached is None or cached[0] != dev or cached[1] is not self.weights:
            cached = self._weights_d = (dev, self.weights, tuple(
                _csr_tensor(W.T, dev) for W in self.weights))
        return cached[2]

    def _dense_rows(self, X):
        """The rows of X (scipy sparse or dense) as a float64 tensor on
        the model's device."""
        X = X.toarray() if sp.issparse(X) else np.asarray(X)
        return torch.as_tensor(np.asarray(X, np.float64), device=self._device())

    def _product(self, x):
        """``x @ W1 @ W2`` for dense rows x on the device, as two sparse
        products ``W2ᵀ (W1ᵀ xᵀ)``."""
        W1t, W2t = self._device_weights()
        return (W2t @ (W1t @ x.T)).T

    def forward(self, X):
        """(B, n_items) float64 tensor on the model's device: the rows X
        (B, n_items) through the factored weights, ``X @ W1 @ W2``."""
        return self._product(self._dense_rows(X))

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self.U = train_set.matrix
        self.X = train_set.matrix.astype(np.float32)
        self._W_cache = None

        X = self.X
        density = float(np.clip(self.weight_matrix_density, 0.0, 1.0))
        icf = str(self.factorizer_class).upper() != "CHOLMOD"

        # Gramian (or the item-item matrix itself when compute_gramian=False),
        # with the ICF equilibration applied in X-space like the reference
        if self.compute_gramian:
            if icf:
                gram = (X.T @ X).tocsr()
                da = equilibrate_columns(np.asarray(gram.multiply(gram).sum(axis=1)).ravel())
                X = X @ sp.diags(1.0 / da)
            A_sp = (X.T @ X).tocsr()
        else:
            A_sp = X.tocsr()
            if icf:
                da = equilibrate_columns(np.asarray(A_sp.multiply(A_sp).sum(axis=1)).ravel())
                scale = sp.diags(1.0 / da)
                A_sp = (scale @ A_sp @ scale).tocsr()

        n = A_sp.shape[0]
        if n > 32768:
            raise ValueError(
                "SANSA's host factorization densifies the permuted Gramian "
                f"(O(n_items^2) float64): {n} items would need "
                f"~{8 * n * n / 2**30:.1f} GiB. This implementation is "
                "gated to catalogs <= 32768 items; use EASE or a factor "
                "model for larger catalogs."
            )
        p = rcm_permutation(A_sp)
        A = A_sp[p][:, p].toarray().astype(np.float64)
        A[np.diag_indices(n)] += float(self.l2)

        if self.verbose:
            print("Computing LDL^T decomposition of permuted item-item matrix...")
        if icf:
            L, d = icf_ldlt(
                A,
                density,
                shift_step=self.factorizer_shift_step,
                shift_multiplier=self.factorizer_shift_multiplier,
                verbose=self.verbose,
            )
        else:
            L, d = exact_ldlt_pruned(A, density)

        if self.verbose:
            print("Computing approximate inverse of L...")
        L_inv = umr_inverse(
            L,
            density,
            scans=self.inverter_scans,
            finetune_steps=self.inverter_finetune_steps,
        )

        # A^{-1} = W.T @ diag(1/d) @ W with W = L_inv column-unpermuted
        inv_p = np.argsort(p)
        W = L_inv[:, inv_p].tocsc()
        W_r = W.copy()
        W_r.data = W_r.data / d[W_r.indices]  # row scale by 1/d
        diag = np.asarray(W.multiply(W_r).sum(axis=0)).ravel()  # diag(A^{-1})
        diag[diag == 0] = 1.0
        # column scale by -1/diag: columns of B = -A^{-1} diagMat(1/diag)
        W_r = (W_r @ sp.diags(-1.0 / diag)).tocsc()
        self.weights = (W.T.tocsr(), W_r.tocsr())
        return self

    def _rows_scores(self, rows):
        """(B, n_items) float64 host scores of interaction rows: the
        factored product plus the rows themselves (W1 @ W2 factors
        B_EASE - I, so seen items score under EASE semantics; unseen items
        have x == 0)."""
        x = self._dense_rows(rows)
        scores = self._product(x) + x
        if self.use_absolute_value_scores:
            scores = scores.abs()
        return scores.cpu().numpy()

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        row = self._rows_scores(self.U[user_idx, :])[0]
        return row if item_idx is None else row[item_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._rows_scores(self.U[np.where(known, users, 0)])
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        # score(u, i) is score(u)[i]: one row per distinct user, on the card
        return self._score_pairs_from_rows(user_indices, item_indices)

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        # factored form: score(u, i) = (X @ W1)[u] . W2[:, i]; dense
        W1t, _ = self._device_weights()
        return (W1t @ self._dense_rows(self.U).T).T.to(torch.float32).cpu().numpy()

    def get_item_vectors(self):
        return np.asarray(self.weights[1].T.todense(), dtype=np.float32)
