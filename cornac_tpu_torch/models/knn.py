"""UserKNN / ItemKNN — neighbourhood collaborative filtering.

Port of ``cornac_tpu/models/knn.py`` with the same semantics:

- similarity = co-support cosine: sim(r, c) = <w_r, w_c> / (||w_r|co-rated||
  * ||w_c|co-rated||), denominators restricted to co-rated columns. The
  full matrix (``compute_similarity``) is three plain float32 products
  (``torch.matmul``, TF32 off), row-blocked exactly as the JAX package
  blocks them, so the same ``chunk`` gives the same numbers.
- score(u, i) = sum_{top-k co-raters by similarity} sim * rating /
  (sum |sim| + 1e-8) (+ the user's mean for mean-centred explicit data).
  The per-item top-k runs over a masked (neighbours x items) weight
  tensor per chunk of 16 query users, with equal weights taken lower
  neighbour index first, as ``jax.lax.top_k`` takes them: on star
  ratings such ties are common, and they decide which neighbours' ratings
  enter the score.
- ``neighbors`` / ``nearest_users`` / ``nearest_items`` (the related-items
  serving surface) build their table with ``ops.cosine_topk_sparse``, the
  hand-written kernel on the card, which walks the weight matrix's
  nonzeros and forms neither the dense weights nor the (n, n) matrix.

Unlike the JAX package, which uploads ``ui_centered`` (UserKNN) or
``sim_mat`` (ItemKNN) on every ``score`` call, the port keeps a float32
copy of what scoring reads resident on the model's device once it has
been built; the numbers are the same. Those copies are process-local
(``ignored_attrs``): a saved model holds the numpy arrays, as the JAX
package's does, and a loaded one rebuilds them on first use.
"""

import numpy as np
import torch
from scipy.sparse import coo_matrix

from ..device import resolve_device
from ..exception import ScoreException
from ..ops.cosine_topk import co_support_cosine, cosine_topk_sparse
from ..utils import get_rng
from .recommender import Recommender, pad_to_catalog

EPS = 1e-8

SIMILARITIES = ["cosine", "pearson"]
WEIGHTING_OPTIONS = ["idf", "bm25"]


def _amplify_dense(s, alpha):
    """Sign-preserving power: s**alpha for s > 0, -(-s)**alpha otherwise
    (so 0 becomes -0.0, as in the JAX package)."""
    return np.where(s > 0, s**alpha, -((-s) ** alpha))


def _mean_centered(ui_mat):
    """Subtract per-row means; exact zeros after centering become EPS so the
    'rated' support is preserved."""
    ui_mat = ui_mat.copy()
    mean_arr = np.zeros(ui_mat.shape[0])
    counts = np.diff(ui_mat.indptr)
    sums = np.add.reduceat(
        ui_mat.data, ui_mat.indptr[:-1][counts > 0]
    ) if ui_mat.nnz else np.array([])
    nz = counts > 0
    mean_arr[nz] = sums / counts[nz]
    ui_mat.data = ui_mat.data - np.repeat(mean_arr, counts)
    ui_mat.data[ui_mat.data == 0] = EPS
    return ui_mat, mean_arr


def _amplify(mat, alpha=1.0):
    if alpha == 1.0:
        return mat
    mat.data = _amplify_dense(mat.data, alpha)
    return mat


def _idf_weight(ui_mat):
    X = coo_matrix(ui_mat)
    N = float(X.shape[0])
    idf = np.log(N / np.bincount(X.col))
    return idf[ui_mat.indices] + EPS


def _bm25_weight(ui_mat):
    K1, B = 1.2, 0.8
    X = coo_matrix(ui_mat)
    X.data = np.ones_like(X.data)
    N = float(X.shape[0])
    idf = np.log(N / np.bincount(X.col))
    row_sums = np.ravel(X.sum(axis=1))
    length_norm = (1.0 - B) + B * row_sums / row_sums.mean()
    return (K1 + 1.0) / (K1 * length_norm[X.row] + X.data) * idf[X.col] + EPS


def dense_f32(mat, device):
    """``np.asarray(mat.todense(), np.float32)`` as a tensor, built on
    ``device`` from the sparse entries (the same values, without a dense
    float64 copy on the host)."""
    coo = coo_matrix(mat)
    coo.sum_duplicates()
    out = torch.zeros(coo.shape, dtype=torch.float32, device=device)
    if coo.nnz:
        rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
        cols = torch.as_tensor(coo.col.astype(np.int64), device=device)
        out[rows, cols] = torch.as_tensor(coo.data, device=device).to(torch.float32)
    return out


def compute_similarity(data_mat, k=20, verbose=False, chunk=2048, device=None):
    """All-pairs co-support cosine similarity of the rows of ``data_mat``,
    on ``device`` (default: the card), row-blocked by ``chunk`` rows when
    there are more. Returns a dense float64 numpy array; ``k`` is applied
    at scoring time, as in the JAX package."""
    dev = resolve_device(device)
    W = dense_f32(data_mat, dev)
    n = W.shape[0]
    if n <= chunk:
        return co_support_cosine(W, W).cpu().numpy().astype(np.float64)
    Bm = (W != 0).to(W.dtype)
    W2 = W * W
    out = np.empty((n, n), dtype=np.float64)
    for s in range(0, n, chunk):
        out[s : s + chunk] = co_support_cosine(W[s : s + chunk], W, Bm, W2).cpu().numpy()
    return out


def _topk_lower_index(w, k):
    """``torch.topk(w, k)`` over the last axis in ``jax.lax.top_k``'s
    order, which ``torch.topk`` does not keep: best first, equal values
    lower index first, -0.0 below +0.0 (amplified similarities hold -0.0).
    Each float32 becomes a unique int64 key: order-preserving float bits
    above the complemented index. Returns (values, indices)."""
    v = w.contiguous().view(torch.int32).to(torch.int64)
    v = torch.where(v < 0, v ^ 0x7FFFFFFF, v)
    low = 0xFFFFFFFF - torch.arange(w.shape[-1], device=w.device, dtype=torch.int64)
    idx = torch.topk((v << 32) + low, k, dim=-1).indices
    return w.gather(-1, idx), idx


def _knn_scores(sim_rows, RT, ratedT, k):
    """(B, n_items) weighted-vote scores for a chunk of query entities.

    sim_rows: (B, n_neighbors) similarities of the chunk's entities to all
    neighbours; RT: (n_items, n_neighbors) ratings; ratedT: RT != 0. For
    every item: take the k largest-similarity neighbours among raters,
    score = sum(sim * rating) / (sum |sim| + 1e-8).
    """
    eligible = ratedT[None, :, :] & (sim_rows[:, None, :] != 0)
    w = torch.where(eligible, sim_rows[:, None, :], -torch.inf)
    top_w, top_idx = _topk_lower_index(w, k)  # by signed similarity
    valid = torch.isfinite(top_w)
    top_w = torch.where(valid, top_w, 0.0)
    top_r = torch.gather(RT.expand(sim_rows.shape[0], -1, -1), 2, top_idx)
    top_r = torch.where(valid, top_r, 0.0)
    num = torch.sum(top_w * top_r, dim=2)
    denom = torch.sum(torch.abs(top_w), dim=2)
    return num / (denom + EPS)


def _item_knn_scores(user_rows, simT, k):
    """(B, n_items) item-based weighted votes: for target item i, the
    neighbours are items j the user rated, ranked by sim[j, i]
    (``simT`` = sim.T); neighbours of similarity 0 take a slot but add
    nothing."""
    rated = user_rows != 0  # (B, n_j)
    w = torch.where(rated[:, None, :], simT[None, :, :], -torch.inf)
    top_w, top_idx = _topk_lower_index(w, k)
    valid = torch.isfinite(top_w) & (top_w != 0)
    top_w = torch.where(valid, top_w, 0.0)
    top_r = torch.gather(user_rows[:, None, :].expand(-1, simT.shape[0], -1), 2, top_idx)
    top_r = torch.where(valid, top_r, 0.0)
    num = torch.sum(top_w * top_r, dim=2)
    denom = torch.sum(torch.abs(top_w), dim=2)
    return num / (denom + EPS)


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _ratings_by_item(R, device):
    """(R.T, R.T != 0) as float32 / bool tensors on ``device``."""
    RT = _f32(R.T, device).contiguous()
    return RT, RT != 0


class _KNNBase(Recommender):
    def __init__(
        self,
        name,
        k=20,
        similarity="cosine",
        mean_centered=False,
        weighting=None,
        amplify=1.0,
        num_threads=0,
        trainable=True,
        verbose=True,
        seed=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.device = device
        self.num_threads = num_threads  # reference OpenMP knob, no-op here
        self.k = k
        self.similarity = similarity
        self.mean_centered = mean_centered
        self.weighting = weighting
        self.amplify = amplify
        self.seed = seed
        self.rng = get_rng(seed)
        self.ignored_attrs.append("_resident_d")

        if self.similarity not in SIMILARITIES:
            raise ValueError(
                "Invalid similarity choice, supported {}".format(SIMILARITIES)
            )
        if self.weighting is not None and self.weighting not in WEIGHTING_OPTIONS:
            raise ValueError(
                "Invalid weighting choice, supported {}".format(WEIGHTING_OPTIONS)
            )

    def _fitted(self, ui_mat, weight_mat):
        """Store what ``fit`` computed: ``ui_centered``, the weight matrix
        (rows = neighbour entities), ``sim_mat`` (amplified); drop every
        table and device copy of an earlier fit."""
        self.ui_centered = np.asarray(ui_mat.todense())
        self._weight_mat = weight_mat
        self.sim_mat = compute_similarity(
            weight_mat, k=self.k, verbose=self.verbose, device=self._device()
        )
        if self.amplify != 1.0:
            self.sim_mat = _amplify_dense(self.sim_mat, self.amplify)
        self._nn_ids = self._nn_sims = self._resident_d = None
        return self

    def _resident(self, source, build):
        """Device tensors built by ``build(source, device)``, kept until
        the model's device or ``source`` (the numpy array they copy)
        changes."""
        dev = self._device()
        cached = getattr(self, "_resident_d", None)
        if cached is None or cached[0] != dev or cached[1] is not source:
            cached = self._resident_d = (dev, source, build(source, dev))
        return cached[2]

    def _build_neighbor_index(self, num_neighbors, force=None):
        """Precompute the (n, k) neighbour table with the fused similarity
        top-k over the weight matrix's entries (``ops.cosine_topk_sparse``):
        on the card, the hand-written kernel, which builds neither the
        dense weights nor the (n, n) similarity matrix."""
        sims, ids = cosine_topk_sparse(
            self._weight_mat, num_neighbors, exclude_self=True, force=force,
            device=self._device())
        sims = sims.cpu().numpy().astype(np.float64)
        if self.amplify != 1.0:  # monotone per sign: order is unchanged
            sims = _amplify_dense(sims, self.amplify)
        self._nn_k = int(min(num_neighbors, self._weight_mat.shape[0] - 1))
        self._nn_sims, self._nn_ids = sims, ids.cpu().numpy()

    def neighbors(self, indices=None, num_neighbors=None, force=None):
        """Top-``num_neighbors`` most similar entities per entity, under
        the model's own (weighted/centred/amplified) co-support cosine —
        the related-users / related-items serving surface.

        Returns (neighbor_ids (n, k), similarities (n, k)); with
        ``indices`` only those rows. The table is computed once and cached.
        ``force``: None, ``"kernel"`` or ``"torch"`` (``ops.cosine_topk_sparse``).
        """
        kk = int(num_neighbors if num_neighbors is not None else self.k)
        if (
            getattr(self, "_nn_ids", None) is None
            or self._nn_k < kk
            or force is not None
        ):
            self._build_neighbor_index(kk, force=force)
        kk = min(kk, self._nn_ids.shape[1])
        ids, sims = self._nn_ids[:, :kk], self._nn_sims[:, :kk]
        if indices is None:
            return ids, sims
        idx = np.asarray(indices)
        return ids[idx], sims[idx]

    def _padded(self, scores, known):
        """Unknown users get ``default_score()``; items past the train set
        the row's minimum, as in the JAX package."""
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)


class UserKNN(_KNNBase):
    """User-based KNN: neighbours are co-rating users."""

    def __init__(
        self,
        name="UserKNN",
        k=20,
        similarity="cosine",
        mean_centered=False,
        weighting=None,
        amplify=1.0,
        num_threads=0,
        trainable=True,
        verbose=True,
        seed=None,
        device=None,
    ):
        super().__init__(
            name=name,
            k=k,
            similarity=similarity,
            mean_centered=mean_centered,
            weighting=weighting,
            amplify=amplify,
            num_threads=num_threads,
            trainable=trainable,
            verbose=verbose,
            seed=seed,
            device=device,
        )

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)

        ui_mat = train_set.matrix.copy()
        self.mean_arr = np.zeros(ui_mat.shape[0])
        if self.min_rating != self.max_rating:  # explicit feedback
            ui_mat, self.mean_arr = _mean_centered(ui_mat)

        if self.mean_centered or self.similarity == "pearson":
            weight_mat = ui_mat.copy()
        else:
            weight_mat = train_set.matrix.copy()

        if self.weighting == "idf":
            weight_mat.data *= np.sqrt(_idf_weight(train_set.matrix))
        elif self.weighting == "bm25":
            weight_mat.data *= np.sqrt(_bm25_weight(train_set.matrix))

        return self._fitted(ui_mat, weight_mat)  # rows = users

    def nearest_users(self, user_indices=None, num_neighbors=None, force=None):
        """Related-users serving API; see :meth:`_KNNBase.neighbors`."""
        return self.neighbors(user_indices, num_neighbors, force=force)

    def _chunked_scores(self, sim_rows, chunk=16):
        """(B, n_items) float32 votes for the users whose similarity rows
        are ``sim_rows``, ``chunk`` users per device call."""
        RT, ratedT = self._resident(self.ui_centered, _ratings_by_item)
        k = min(self.k, RT.shape[1])
        outs = [np.empty((0, RT.shape[0]), dtype=np.float32)]
        for s in range(0, sim_rows.shape[0], chunk):
            block = _f32(sim_rows[s : s + chunk], RT.device)
            outs.append(_knn_scores(block, RT, ratedT, k).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def score(self, user_idx, item_idx=None):
        if not self.knows_user(user_idx):
            raise ScoreException(
                "Can't make score prediction for (user_id=%d)" % user_idx
            )
        if item_idx is not None and not self.knows_item(item_idx):
            raise ScoreException(
                "Can't make score prediction for (item_id=%d)" % item_idx
            )
        row = self._chunked_scores(self.sim_mat[user_idx : user_idx + 1])[0]
        scores = self.mean_arr[user_idx] + row
        return scores if item_idx is None else scores[item_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        safe = np.where(known, users, 0)
        rows = self._chunked_scores(self.sim_mat[safe])
        return self._padded(self.mean_arr[safe][:, None] + rows, known)


class ItemKNN(_KNNBase):
    """Item-based KNN: neighbours are items co-rated by the same users."""

    def __init__(
        self,
        name="ItemKNN",
        k=20,
        similarity="cosine",
        mean_centered=False,
        weighting=None,
        amplify=1.0,
        num_threads=0,
        trainable=True,
        verbose=True,
        seed=None,
        device=None,
    ):
        super().__init__(
            name=name,
            k=k,
            similarity=similarity,
            mean_centered=mean_centered,
            weighting=weighting,
            amplify=amplify,
            num_threads=num_threads,
            trainable=trainable,
            verbose=verbose,
            seed=seed,
            device=device,
        )

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)

        ui_mat = train_set.matrix.copy()
        self.mean_arr = np.zeros(ui_mat.shape[0])
        if self.min_rating != self.max_rating:  # explicit feedback
            ui_mat, self.mean_arr = _mean_centered(ui_mat)

        if self.mean_centered:
            weight_mat = ui_mat.copy()
        else:
            weight_mat = train_set.matrix.copy()

        if self.similarity == "pearson":  # center by item columns
            weight_mat, _ = _mean_centered(weight_mat.T.tocsr())
            weight_mat = weight_mat.T.tocsr()

        if self.weighting == "idf":
            weight_mat.data *= np.sqrt(_idf_weight(train_set.matrix))
        elif self.weighting == "bm25":
            weight_mat.data *= np.sqrt(_bm25_weight(train_set.matrix))

        # item-item similarity: rows are items
        return self._fitted(ui_mat, weight_mat.T.tocsr())

    def nearest_items(self, item_indices=None, num_neighbors=None, force=None):
        """Related-items serving API; see :meth:`_KNNBase.neighbors`."""
        return self.neighbors(item_indices, num_neighbors, force=force)

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        scores = self.score_batch(np.asarray([user_idx]))[0, : self.num_items]
        return scores if item_idx is None else scores[item_idx]

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        safe = np.where(known, users, 0)
        # neighbours are items: for target item i, the items j the user
        # rated, weighted by sim[j, i]
        simT = self._resident(self.sim_mat, lambda s, dev: _f32(s.T, dev).contiguous())
        R = self.ui_centered[safe]  # (B, n_items) user ratings
        k = min(self.k, self.sim_mat.shape[0])
        out = np.empty((len(users), self.sim_mat.shape[0]))
        chunk = 16
        for s in range(0, len(users), chunk):
            block = _f32(R[s : s + chunk], simT.device)
            out[s : s + chunk] = _item_knn_scores(block, simT, k).cpu().numpy()
        return self._padded(self.mean_arr[safe][:, None] + out, known)
