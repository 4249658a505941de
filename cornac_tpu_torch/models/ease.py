"""EASE — Embarrassingly Shallow Autoencoder (Steck, WWW 2019).

Port of ``cornac_tpu/models/ease.py``. The interaction matrix X (users x
items, the train ratings) is built on the model's device from the train
set's (user, item, rating) arrays, then G = XᵀX + lamb·I and its inverse,
in float32 as the JAX package computes them (``_ease_B``): plain PyTorch,
as XLA does it there. Where the JAX package densifies X on the host and
scores through scipy, the port scores on the device: each batch's rows of X
are built there from the CSR rows of its users and multiplied by B.
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.dispatch import full_f32
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog


def _ease_B(X, lamb):
    """The closed-form item-item weights from a dense float32 X (on any
    device): B = P / -diag(P) with P = (XᵀX + lamb·I)⁻¹, zero diagonal."""
    with full_f32():
        G = X.T @ X
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    P, _ = torch.linalg.inv_ex(G + lamb * eye)  # no check of the result, so no sync
    B = P / (-torch.diagonal(P))[None, :]
    return B * (1.0 - eye)


def dense_rows(csr, users, num_items, device):
    """The rows ``users`` of the scipy CSR ``csr`` as a dense float32
    (len(users), num_items) tensor on ``device``, built there from the rows'
    entries."""
    rows = csr[np.asarray(users)]
    counts = np.diff(rows.indptr)
    r = torch.as_tensor(np.repeat(np.arange(len(counts)), counts), device=device)
    c = torch.as_tensor(rows.indices.astype(np.int64), device=device)
    v = torch.as_tensor(rows.data.astype(np.float32), device=device)
    out = torch.zeros((len(counts), num_items), dtype=torch.float32, device=device)
    out[r, c] = v
    return out


class EASE(Recommender, ANNMixin):
    """Closed-form linear item-item autoencoder.

    Parameters
    ----------
    lamb: float, default: 500
        L2 regularization of the Gram matrix.
    posB: bool, default: True
        Clamp negative weights in B to zero.
    device: where the model fits and scores (default: the card).
    """

    def __init__(
        self,
        name="EASEᴿ",
        lamb=500,
        posB=True,
        trainable=True,
        verbose=True,
        seed=None,
        B=None,
        U=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.lamb = lamb
        self.posB = posB
        self.seed = seed
        self.B = B
        self.U = U
        self.device = device
        self.ignored_attrs += ["_B_d"]

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)

        self.U = train_set.matrix  # user-item CSR, kept for scoring

        dev = self._device()
        rid, cid, val = train_set.uir_tuple
        X = torch.zeros((self.num_users, self.num_items), dtype=torch.float32, device=dev)
        X[torch.as_tensor(rid, dtype=torch.long, device=dev),
          torch.as_tensor(cid, dtype=torch.long, device=dev)] = torch.as_tensor(
              np.asarray(val, np.float32), device=dev)
        B = _ease_B(X, float(self.lamb))
        del X
        if self.posB:
            B = torch.clamp_min(B, 0.0)
        self.B = B.cpu().numpy().astype(np.float64)
        self._B_d = (dev, self.B, B)
        return self

    def _device_B(self):
        """B as float32 on the model's device: the fit's, or a copy of
        ``self.B`` made again when that was replaced (a load, a given B)."""
        dev = self._device()
        cached = getattr(self, "_B_d", None)
        if cached is None or cached[0] != dev or cached[1] is not self.B:
            B = torch.as_tensor(np.asarray(self.B, np.float32), device=dev)
            cached = self._B_d = (dev, self.B, B)
        return cached[2]

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)

        if item_idx is None:
            return np.asarray(self.U[user_idx, :].dot(self.B)).ravel()
        return float(np.asarray(self.U[user_idx, :].dot(self.B[:, item_idx])).ravel()[0])

    def _known_scores_device(self, safe_users, known):
        B = self._device_B()
        rows = dense_rows(self.U, safe_users, B.shape[0], B.device)
        with full_f32():
            return rows @ B

    def score_batch(self, user_indices):
        scores = self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        rows = self.U[np.where(known, users, 0)].toarray()
        preds = np.einsum("bi,ib->b", rows, self.B[:, np.where(known, items, 0)])
        return np.where(known, preds, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.U

    def get_item_vectors(self):
        return self.B
