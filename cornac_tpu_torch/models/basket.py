"""Next-basket models: GPTop, TIFUKNN, UPCF.

Port of ``cornac_tpu/models/basket.py``.

- GPTop (global and personal item frequencies) is host numpy, as in the
  JAX package.
- TIFUKNN builds its time-decayed user vectors on the host, as the JAX
  package does, and keeps them on the model's device from ``fit``. Its
  neighbour search is there: squared Euclidean distances, then the top-k of
  ``-d2`` in ``jax.lax.top_k``'s order (equal distances to the lower user
  index, through ``knn._topk_lower_index``'s int64 keys; ``torch.topk``
  promises no order among ties). The JAX package averages the neighbours
  per item, as the paper does.
- UPCF keeps the user-item matrix and the users' recency popularity dense
  on the model's device from ``fit`` (the JAX package densifies both on the
  host on every call: 2.5 GB each at the Ta Feng counts) and computes the
  asymmetric cosine ``<q, x> / (|q|^(2a) |x|^(2(1-a)))`` and ``sim · P``
  there in float32.

The products run in full float32 (``ops.dispatch.full_f32``), as XLA and
numpy compute them.
"""

import itertools
from collections import Counter

import numpy as np
import torch
from scipy.sparse import csr_matrix, vstack

from ..ops.dispatch import full_f32
from .knn import _topk_lower_index, dense_f32
from .recommender import NextBasketRecommender

# bytes of the (rows, neighbours, items) block TIFUKNN gathers at once
_GATHER_BYTES = 1 << 28


class GPTop(NextBasketRecommender):
    """Global + personalized top-frequency baseline (Li et al., TOIS 2023)."""

    def __init__(
        self,
        name="GPTop",
        use_global_popularity=True,
        use_personalized_popularity=True,
        use_quantity=False,
    ):
        super().__init__(name=name, trainable=False)
        self.use_global_popularity = use_global_popularity
        self.use_personalized_popularity = use_personalized_popularity
        self.use_quantity = use_quantity
        self.item_freq = Counter()

    def fit(self, train_set, val_set=None):
        super().fit(train_set=train_set, val_set=val_set)
        self._global_row = np.zeros(self.total_items, dtype=np.float64)
        if self.use_global_popularity:
            if self.use_quantity:
                self.item_freq = Counter()
                for idx, iid in enumerate(self.train_set.uir_tuple[1]):
                    self.item_freq[iid] += self.train_set.extra_data[idx].get("quantity", 0)
            else:
                self.item_freq = Counter(self.train_set.uir_tuple[1])
            max_freq = max(self.item_freq.values()) if self.item_freq else 1
            for iid, freq in self.item_freq.items():
                self._global_row[iid] = freq / max_freq
        return self

    def score(self, user_idx, history_baskets, **kwargs):
        item_scores = self._global_row.copy()
        if self.use_personalized_popularity:
            if self.use_quantity:
                history_bids = kwargs.get("history_bids")
                baskets = kwargs.get("baskets")
                extra_data = kwargs.get("extra_data")
                p_freq = Counter()
                for bid, iids in zip(history_bids, history_baskets):
                    for idx, iid in zip(baskets[bid], iids):
                        p_freq[iid] += extra_data[idx].get("quantity", 0)
            else:
                p_freq = Counter([iid for iids in history_baskets for iid in iids])
            for iid, cnt in p_freq.items():
                item_scores[iid] += cnt
        return item_scores

    def score_baskets_batch(self, user_indices, histories):
        out = np.tile(self._global_row[: self.num_items], (len(user_indices), 1))
        if self.use_personalized_popularity:
            for b, h in enumerate(histories):
                for iid, cnt in Counter([iid for iids in h for iid in iids]).items():
                    if iid < self.num_items:
                        out[b, iid] += cnt
        return out


class TIFUKNN(NextBasketRecommender):
    """Temporal-Item-Frequency user KNN (Hu et al., SIGIR 2020).
    ``device``: where the neighbour search runs (default: the card;
    ``"cpu"`` asks for the CPU)."""

    def __init__(
        self,
        name="TIFUKNN",
        n_neighbors=300,
        within_decay_rate=0.9,
        group_decay_rate=0.7,
        alpha=0.7,
        n_groups=7,
        device=None,
        verbose=False,
    ):
        super().__init__(name=name, trainable=False, verbose=verbose)
        assert 0 <= within_decay_rate <= 1
        assert 0 <= group_decay_rate <= 1
        self.n_neighbors = n_neighbors
        self.within_decay_rate = within_decay_rate
        self.group_decay_rate = group_decay_rate
        self.alpha = alpha
        self.n_groups = n_groups
        self.device = device
        self.ignored_attrs.append("_X")

    def fit(self, train_set, val_set=None):
        super().fit(train_set=train_set, val_set=val_set)
        vectors = []
        for _, _, [basket_items] in train_set.ubi_iter(batch_size=1, shuffle=False):
            vectors.append(self._compute_user_vector(basket_items[:-1]))
        self.user_vectors = np.asarray(vectors, dtype=np.float32)
        self.n_neighbors = min(self.n_neighbors, len(self.user_vectors))
        self._X = None
        return self

    def _compute_user_vector(self, history_baskets):
        """Time-decayed grouped item-frequency vector (paper eq. 1-3).

        The JAX package's arithmetic on the columns of the history's items
        only (every other column stays 0 through it): the same float32
        operations in the same order on each column, so the same bits,
        without a vector of every item per basket."""
        n_baskets = len(history_baskets)
        vec = np.zeros(self.total_items, dtype=np.float32)
        if n_baskets == 0:
            return vec
        cols, where = np.unique(np.concatenate([np.asarray(b, dtype=np.int64).ravel()
                                                for b in history_baskets]), return_inverse=True)
        basket_vecs = np.zeros((n_baskets, len(cols)), dtype=np.float32)
        start = 0
        for inc, iids in enumerate(history_baskets):
            stop = start + len(iids)
            basket_vecs[inc, where[start:stop]] = np.power(self.within_decay_rate,
                                                           n_baskets - inc - 1)
            start = stop

        groups = self._group(list(basket_vecs))
        if not groups:
            return vec
        acc = np.zeros(len(cols), dtype=np.float32)
        for idx, g in enumerate(groups):
            acc += g * np.power(self.group_decay_rate, self.n_groups - idx - 1)
        vec[cols] = acc / len(groups)
        return vec

    def _group(self, basket_vecs):
        """Partition basket vectors into up to n_groups contiguous blocks
        and average within each block."""
        m = len(basket_vecs)
        if m == 0:
            return []
        if m < self.n_groups:
            return basket_vecs
        bounds = np.linspace(0, m, self.n_groups + 1).round().astype(int)
        return [
            np.mean(basket_vecs[s:e], axis=0)
            for s, e in zip(bounds[:-1], bounds[1:])
            if e > s
        ]

    def _table(self):
        """(X, its rows' squared norms (1, U)) on the model's device,
        uploaded once a fit."""
        if getattr(self, "_X", None) is None:
            X = torch.as_tensor(self.user_vectors, device=self._device())
            self._X = (X, torch.sum(X**2, dim=1)[None, :])
        return self._X

    def neighbors(self, queries):
        """(B, n_neighbors) int64 indices of the nearest user vectors to
        ``queries`` (B, total_items) float32 by Euclidean distance, nearest
        first, equal distances to the lower index (``jax.lax.top_k`` of
        ``-d2``'s order)."""
        X, x2 = self._table()
        q = torch.as_tensor(queries, device=X.device)
        with full_f32():
            d2 = torch.sum(q**2, dim=1, keepdim=True) - 2 * q @ X.T + x2
        return _topk_lower_index(-d2, self.n_neighbors)[1]

    def score(self, user_idx, history_baskets, **kwargs):
        return self.score_baskets_batch([user_idx], [history_baskets])[0]

    def score_baskets_batch(self, user_indices, histories):
        queries = np.stack([self._compute_user_vector(h) for h in histories]).astype(np.float32)
        idx = self.neighbors(queries)
        X = self._table()[0]
        q = torch.as_tensor(queries, device=X.device)
        # the neighbours' mean, a few rows at a time: B x k x items floats
        # at once would be gigabytes at Ta Feng's widths
        rows = max(1, _GATHER_BYTES // (4 * self.n_neighbors * X.shape[1]))
        neighbor_mean = torch.cat([X[idx[s:s + rows]].mean(dim=1)
                                   for s in range(0, idx.shape[0], rows)])
        scores = self.alpha * q + (1 - self.alpha) * neighbor_mean
        return scores[:, : self.num_items].cpu().numpy().astype(np.float64)


class UPCF(NextBasketRecommender):
    """Recency-aware user-popularity CF (Faggioli et al., UMAP 2020).
    ``device``: where the tables live and the scores are computed (default:
    the card; ``"cpu"`` asks for the CPU)."""

    def __init__(self, name="UPCF", recency=1, locality=1, asymmetry=0.25, device=None,
                 verbose=False):
        super().__init__(name=name, trainable=False, verbose=verbose)
        self.recency = recency
        self.locality = locality
        self.asymmetry = asymmetry
        self.device = device
        self.ignored_attrs.append("_tables")

    def fit(self, train_set, val_set=None):
        super().fit(train_set=train_set, val_set=val_set)
        self.user_wise_popularity = vstack(
            [
                self._user_wise_popularity(basket_items)
                for _, _, [basket_items] in train_set.ubi_iter(batch_size=1, shuffle=False)
            ]
        )
        u, i, r = train_set.uir_tuple
        self.user_item_matrix = csr_matrix(
            (r, (u, i)), shape=(train_set.num_users, self.total_items), dtype="float32"
        )
        self._tables = None
        return self

    def _user_wise_popularity(self, basket_items):
        recent = basket_items[-self.recency :] if self.recency > 0 else basket_items
        denom = min(self.recency, len(recent)) if self.recency > 0 else max(len(recent), 1)
        items, scores = [], []
        for iid in set(itertools.chain.from_iterable(recent)):
            items.append(iid)
            scores.append(sum(1 for b in recent if iid in b) / denom)
        return csr_matrix(
            (scores, (np.zeros(len(items)), items)),
            shape=(1, self.total_items),
            dtype="float32",
        )

    def tables(self):
        """(X, P, |x|^(2(1-a))) on the model's device: the user-item matrix
        (U, items), the users' recency popularity (U, items) and each user
        row's norm term (1, U); built once a fit."""
        if getattr(self, "_tables", None) is None:
            dev = self._device()
            X = dense_f32(self.user_item_matrix, dev)
            P = dense_f32(self.user_wise_popularity, dev)
            xn = torch.linalg.vector_norm(X, dim=1, keepdim=True).T ** (2 * (1 - self.asymmetry))
            self._tables = (X, P, xn)
        return self._tables

    def score(self, user_idx, history_baskets, **kwargs):
        return self.score_baskets_batch([user_idx], [history_baskets])[0]

    def score_baskets_batch(self, user_indices, histories):
        # query rows: binary item sets + recency-weighted popularity
        Q = np.zeros((len(histories), self.total_items), dtype=np.float32)
        q_pops = np.zeros_like(Q)
        for b, h in enumerate(histories):
            Q[b, list(set(itertools.chain.from_iterable(h)))] = 1.0
            pop = self._user_wise_popularity(h)
            q_pops[b, pop.indices] = pop.data
        X, P, xn = self.tables()
        Q = torch.as_tensor(Q, device=X.device)
        a = self.asymmetry
        qn = torch.linalg.vector_norm(Q, dim=1, keepdim=True) ** (2 * a)
        with full_f32():
            sim = (Q @ X.T) / torch.clamp(qn * xn, min=1e-12)
            sim = sim**self.locality
            # the query user's own recency popularity, with self-similarity 1
            scores = sim @ P + torch.as_tensor(q_pops, device=X.device)
        return scores[:, : self.num_items].cpu().numpy().astype(np.float64)
