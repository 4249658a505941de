"""TriRank — review-aware tripartite graph ranking (He et al., CIKM 2015).

Port of ``cornac_tpu/models/trirank.py``. The fit is host code, as in the
JAX package: the symmetric normalisation of the user-item, item-aspect and
user-aspect matrices in scipy. Scoring is the power iteration of a batch
of users' (item, aspect, user) vectors, which the JAX package runs in
float64 numpy on the host; the port runs it on the model's device in
float64. The normalised matrices go there dense while the rating matrix
has at most ``DENSE_CELLS`` cells (4 GB in float64; the Amazon Toys &
Games counts take 1.8 GB): dense products are cuBLAS's, which sum in one
order on every run, so a batch's scores repeat bit for bit. Past that
they are sparse CSR tensors, whose cuSPARSE products may sum in another
order from run to run. The loop stops where the JAX package's does: after
``max_iter`` steps, or when ``allclose`` holds on all three vectors
(numpy's default tolerances, checked once a step: the JAX package's host
loop).
"""

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ..exception import ScoreException
from ..utils import get_rng
from ..utils.init_utils import uniform
from .recommender import Recommender, pad_to_catalog

EPS = 1e-10
DENSE_CELLS = 500_000_000  # users x items at most for dense float64 matrices


def _sparse(matrix, dev):
    """A scipy matrix as a float64 sparse CSR tensor on ``dev``."""
    m = matrix.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(np.asarray(m.indptr, np.int64)),
        torch.as_tensor(np.asarray(m.indices, np.int64)),
        torch.as_tensor(np.asarray(m.data, np.float64)),
        size=m.shape).to(dev)


def _times(M, v):
    """``(M @ v.T).T`` for a batch ``v`` (B, m): ``v @ M.T`` for a dense
    ``M``, the CSR product for a sparse one."""
    if M.layout == torch.strided:
        return v @ M.T
    return (M @ v.T.contiguous()).T


def _row_entries(matrix, users, dev):
    """(batch rows, columns, values) of the stored entries of ``matrix``'s
    rows ``users``, on ``dev``."""
    sub = matrix.tocsr()[np.asarray(users)]
    rows = np.repeat(np.arange(len(users), dtype=np.int64), np.diff(sub.indptr))
    return (torch.as_tensor(rows, device=dev),
            torch.as_tensor(np.asarray(sub.indices, np.int64), device=dev),
            torch.as_tensor(np.asarray(sub.data, np.float64), device=dev))


def _rows_dense(matrix, users, dev):
    """``matrix[users]`` as a dense float64 tensor on ``dev``, built there
    from the rows' entries."""
    rows, cols, vals = _row_entries(matrix, users, dev)
    out = torch.zeros((len(users), matrix.shape[1]), dtype=torch.float64, device=dev)
    return out.index_put_((rows, cols), vals, accumulate=True)


def _allclose(a, b):
    """``np.allclose(a, b)``: |a - b| <= 1e-8 + 1e-5 |b| everywhere."""
    return torch.all(torch.abs(a - b) <= 1e-8 + 1e-5 * torch.abs(b))


class TriRank(Recommender):
    """Tripartite (user-item-aspect) smoothness ranking. ``device``: where
    the model scores (default: the card). ``mesh``, which the JAX package's
    TriRank does not take, is refused (ROADMAP.md A8)."""

    def __init__(
        self,
        name="TriRank",
        alpha=1,
        beta=1,
        gamma=1,
        eta_U=1,
        eta_P=1,
        eta_A=1,
        max_iter=100,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.mesh = mesh
        self.alpha = alpha
        self.beta = beta
        self.gamma = gamma
        self.eta_U = eta_U
        self.eta_P = eta_P
        self.eta_A = eta_A
        self.max_iter = max_iter
        self.verbose = verbose
        self.seed = seed
        self.device = device
        self.rng = get_rng(seed)
        self.ignored_attrs.append("_tensors")
        self.last_iterations = None

        self.init_params = {} if init_params is None else init_params
        self.R = self.init_params.get("R", None)
        self.X = self.init_params.get("X", None)
        self.Y = self.init_params.get("Y", None)
        self.p = self.init_params.get("p", None)
        self.a = self.init_params.get("a", None)
        self.u = self.init_params.get("u", None)

    def _init(self, train_set):
        if self.p is None:
            self.p = uniform(train_set.num_items, random_state=self.rng)
        if self.a is None:
            self.a = uniform(train_set.sentiment.num_aspects, random_state=self.rng)
        if self.u is None:
            self.u = uniform(train_set.num_users, random_state=self.rng)

    @staticmethod
    def _symmetrical_normalization(matrix):
        """w_ij / sqrt(d_i d_j), vectorized over the nonzeros."""
        matrix = matrix.tocoo()
        row_norm = np.sqrt(np.asarray(matrix.sum(axis=1)).ravel())
        col_norm = np.sqrt(np.asarray(matrix.sum(axis=0)).ravel())
        data = matrix.data / np.maximum(
            row_norm[matrix.row] * col_norm[matrix.col], EPS
        )
        return csr_matrix((data, (matrix.row, matrix.col)), shape=matrix.shape)

    def _create_matrices(self, train_set):
        sentiment = train_set.sentiment
        n_users, n_items = train_set.num_users, train_set.num_items
        n_aspects = sentiment.num_aspects

        X_row, X_col, Y_row, Y_col = [], [], [], []
        for uid, isid in sentiment.user_sentiment.items():
            for iid, sid in isid.items():
                aids = {aid for aid, _, _ in sentiment.sentiment[sid]}
                for aid in aids:
                    X_row.append(iid)
                    X_col.append(aid)
                    Y_row.append(uid)
                    Y_col.append(aid)

        X = csr_matrix(
            (np.ones(len(X_row)), (X_row, X_col)), shape=(n_items, n_aspects)
        )
        Y = csr_matrix(
            (np.ones(len(Y_row)), (Y_row, Y_col)), shape=(n_users, n_aspects)
        )
        X.data = np.log2(X.data) + 1
        Y.data = np.log2(Y.data) + 1

        self.R = self._symmetrical_normalization(train_set.csr_matrix)
        self.X = self._symmetrical_normalization(X)
        self.Y = self._symmetrical_normalization(Y)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        self._init(train_set)
        self.r_mat = train_set.csr_matrix
        self._tensors = None
        if not self.trainable:
            return self
        self._create_matrices(train_set)
        return self

    def _on_device(self):
        """R, Rᵀ, X, Xᵀ, Y, Yᵀ as float64 tensors (dense, or sparse CSR
        past ``DENSE_CELLS``) and the initial p, a, u, on the model's
        device, copied once after a fit."""
        if getattr(self, "_tensors", None) is None:
            dev = self._device()
            if self.R.shape[0] * self.R.shape[1] <= DENSE_CELLS:
                dense = [torch.as_tensor(m.toarray(), device=dev)
                         for m in (self.R, self.X, self.Y)]
                mats = [dense[0], dense[0].T, dense[1], dense[1].T, dense[2], dense[2].T]
            else:
                mats = [_sparse(m, dev) for m in (self.R, self.R.T, self.X, self.X.T, self.Y,
                                                  self.Y.T)]
            vecs = [torch.as_tensor(np.asarray(v, np.float64), device=dev)
                    for v in (self.p, self.a, self.u)]
            self._tensors = mats + vecs
        return self._tensors

    def _online_recommendation_batch(self, users):
        """The power iteration for a batch of users at once, on the device:
        (p, a, u), each (B, n) float64."""
        R, Rt, X, Xt, Y, Yt, p_init, a_init, u_init = self._on_device()
        dev = p_init.device
        B = len(users)
        n_users = u_init.shape[0]
        u_t = torch.as_tensor(np.asarray(users, np.int64), device=dev)

        p_0 = _rows_dense(self.r_mat, users, dev) > 0
        p_0 = p_0.to(torch.float64)
        a_0 = _rows_dense(self.Y, users, dev)
        u_0 = torch.zeros((B, n_users), dtype=torch.float64, device=dev)
        u_0[torch.arange(B, device=dev), u_t] = 1.0

        def l1_normalize(M):
            norms = torch.abs(M).sum(dim=1, keepdim=True)
            return torch.where(norms > 0, M / torch.clamp_min(norms, EPS), M)

        p_0, a_0, u_0 = l1_normalize(p_0), l1_normalize(a_0), l1_normalize(u_0)
        p = p_init.expand(B, -1)
        a = a_init.expand(B, -1)
        u = u_init.expand(B, -1)

        u_den = self.alpha + self.gamma + self.eta_U + EPS
        p_den = self.alpha + self.beta + self.eta_P + EPS
        a_den = self.gamma + self.beta + self.eta_A + EPS

        inc = 1
        while True:
            new_u = (
                self.alpha / u_den * _times(R, p)
                + self.gamma / u_den * _times(Y, a)
                + self.eta_U / u_den * u_0
            )
            new_p = (
                self.alpha / p_den * _times(Rt, new_u)
                + self.beta / p_den * _times(X, a)
                + self.eta_P / p_den * p_0
            )
            new_a = (
                self.gamma / a_den * _times(Yt, new_u)
                + self.beta / a_den * _times(Xt, new_p)
                + self.eta_P / a_den * a_0
            )
            if (self.max_iter > 0 and inc > self.max_iter) or bool(
                _allclose(new_u, u) & _allclose(new_p, p) & _allclose(new_a, a)
            ):
                u, p, a = new_u, new_p, new_a
                break
            u, p, a = new_u, new_p, new_a
            inc += 1
        self.last_iterations = inc
        return p, a, u

    def _scaled_scores(self, users):
        """(B, n_items) float64 scores, computed on the device: the rated
        items zeroed, then rescaled to the rating range."""
        p, _, _ = self._online_recommendation_batch(users)
        rows, cols, _ = _row_entries(self.r_mat, users, p.device)
        p = p.index_put((rows, cols), torch.zeros((), dtype=p.dtype, device=p.device))
        max_p = torch.clamp_min(p.max(dim=1, keepdim=True).values, EPS)
        return (p * (self.max_rating - self.min_rating) / max_p + self.min_rating).cpu().numpy()

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        scores = self._scaled_scores(np.asarray([user_idx]))[0]
        return scores if item_idx is None else scores[item_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._scaled_scores(np.where(known, users, 0))
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
