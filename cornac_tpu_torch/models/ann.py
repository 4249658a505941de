"""ANN retrieval wrappers over ANN-capable fitted models.

Port of ``cornac_tpu/models/ann.py::BaseANN`` and ``TPUExactANN``: exact
top-k retrieval on the device, one fused score + top-k over the whole
catalog, recall 1.0 by construction. With ``mesh`` the item table is
row-sharded over the mesh's model axis and queries go through
``parallel.sharded.sharded_topk``. The Annoy/Faiss/HNSWLib/ScaNN wrappers
need packages of their own and are not ported.
"""

import copy
import warnings

import numpy as np
import torch

from ..ops.fused_topk import fused_topk
from ..parallel.mesh import (
    MODEL_AXIS,
    axis_size,
    check_mesh,
    pad_rows_to_multiple,
    shard_tables,
)
from ..parallel.sharded import sharded_topk
from .recommender import (
    MEASURE_COSINE,
    MEASURE_DOT,
    MEASURE_L2,
    Recommender,
    is_ann_supported,
)


class BaseANN(Recommender):
    """Wrap a fitted ANN-capable model; answer top-k queries from its
    user/item vectors."""

    def __init__(self, model, name="BaseANN", verbose=False):
        super().__init__(name=name, verbose=verbose, trainable=False)

        if not is_ann_supported(model):
            raise ValueError(f"{model.name} doesn't support ANN search")

        self.model = model
        self.ignored_attrs.append("model")  # don't persist the base model

        if model.is_fitted:
            Recommender.fit(self, model.train_set, model.val_set)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.model.is_fitted:
            if self.verbose:
                print(f"Fitting base recommender model {self.model.name}...")
            self.model.fit(train_set, val_set)
        self.build_index()
        return self

    def build_index(self):
        """Snapshot vectors from the base model and build the index."""
        if not self.model.is_fitted:
            warnings.warn(f"Base recommender model {self.model.name} is not fitted!")

        self.measure = copy.deepcopy(self.model.get_vector_measure())
        self.user_vectors = copy.deepcopy(self.model.get_user_vectors())
        self.item_vectors = copy.deepcopy(self.model.get_item_vectors())
        self.higher_is_better = self.measure in {MEASURE_DOT, MEASURE_COSINE}

    def knn_query(self, query, k):
        """(neighbors, distances) for query vectors; smaller distance =
        better."""
        raise NotImplementedError()

    def rank(self, user_idx, item_indices=None, k=-1, **kwargs):
        query = self.user_vectors[[user_idx]]
        k_eff = k if k > 0 else self.item_vectors.shape[0]
        knn_items, distances = self.knn_query(query, k=k_eff)

        top_k_items = knn_items[0]
        top_k_scores = -distances[0]

        item_scores = np.full(self.total_items, -np.inf)
        item_scores[top_k_items] = top_k_scores

        all_items = np.arange(self.total_items)
        ranked_items = np.concatenate(
            [
                top_k_items,
                all_items[~np.isin(all_items, top_k_items, assume_unique=True)],
            ]
        )

        if item_indices is None:
            item_scores = item_scores[: self.num_items]
            ranked_items = ranked_items[: self.num_items]
        else:
            item_scores = item_scores[item_indices]
            ranked_items = ranked_items[
                np.isin(ranked_items, item_indices, assume_unique=True)
            ]
        return ranked_items, item_scores

    def recommend(self, user_id, k=-1, remove_seen=False, train_set=None):
        if not isinstance(user_id, str):
            raise TypeError(f"user_id must be a raw string id, got {type(user_id).__name__}")
        return self.recommend_batch(
            batch_users=[user_id], k=k, remove_seen=remove_seen, train_set=train_set
        )[0]

    def recommend_batch(self, batch_users, k=-1, remove_seen=False, train_set=None):
        """Batched raw-ID top-k through the index."""
        user_idx = np.array([self.uid_map.get(uid, -1) for uid in batch_users])
        if (user_idx == -1).any():
            unknown = [u for u, i in zip(batch_users, user_idx) if i == -1]
            raise ValueError(f"user ids {unknown} were never seen during training")

        k_eff = k if k > 0 else self.item_vectors.shape[0]
        # over-fetch when removing seen items so k survives filtering
        fetch = k_eff
        if remove_seen and train_set is not None and k > 0:
            max_seen = int(np.diff(train_set.csr_matrix.indptr).max(initial=0))
            fetch = min(k_eff + max_seen, self.item_vectors.shape[0])

        knn_items, _ = self.knn_query(self.user_vectors[user_idx], k=fetch)

        recommendations = []
        csr = train_set.csr_matrix if train_set is not None else None
        for uidx, row in zip(user_idx, knn_items):
            if remove_seen:
                if csr is None:
                    raise ValueError("remove_seen=True requires a train_set")
                seen = set(csr.getrow(uidx).indices) if uidx < csr.shape[0] else set()
                row = [i for i in row if i not in seen]
            row = row[:k] if k > 0 else row
            recommendations.append([self.item_ids[i] for i in row])
        return recommendations


class TPUExactANN(BaseANN):
    """Exact retrieval on the card (the name is the JAX package's, so that
    ``MODEL_CLASS`` strings map one to one): the hand-written fused score +
    top-k kernel over the whole catalog, recall 1.0 by construction.

    ``device``: where the index lives (default: the base model's device,
    else the card). ``recall_target`` selects the JAX package's approximate
    mode; the port answers it with the same exact lists (recall 1.0, which
    meets every target; ``ops.fused_topk.fused_topk``).

    ``mesh`` (``parallel.make_mesh``; every rank builds the index and asks
    the same queries): the item table is padded to the model-axis size and
    row-sharded over it, the padded rows with a bias of -3.0e38 so that
    they never win, and a query of k up to a shard's rows goes through
    ``sharded_topk``: each rank scores its rows with the fused kernel, and
    the candidates are merged over the model axis.
    """

    def __init__(self, model, name="TPUExactANN", verbose=False, mesh=None,
                 recall_target=None, device=None):
        self.recall_target = recall_target
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device if device is not None else getattr(model, "device", None)
        super().__init__(model=model, name=name, verbose=verbose)
        # device-resident index tensors: process-local, rebuilt on demand
        # after load() from the persisted item_vectors snapshot
        self.ignored_attrs += ["_items_d", "_item_sq", "_items_sharded", "_bias_sharded",
                               "_l2_bias_sharded"]

    def build_index(self):
        super().build_index()
        self._build_device_index()

    def _build_device_index(self):
        dev = self._device()
        items = torch.as_tensor(np.asarray(self.item_vectors, np.float32), device=dev)
        if self.measure == MEASURE_COSINE:
            items = items / items.norm(dim=1, keepdim=True).clamp(min=1e-12)
        self._items_d = items.contiguous()
        self._item_sq = (items**2).sum(1)
        if self.mesh is not None:
            shards = axis_size(self.mesh, MODEL_AXIS)
            n = items.shape[0]
            items_p = pad_rows_to_multiple(self._items_d, shards)
            # padded rows must never win: their bias is -3.0e38
            pad_bias = torch.zeros(items_p.shape[0], dtype=torch.float32, device=dev)
            pad_bias[n:] = -3.0e38
            l2_bias = pad_bias.clone()
            l2_bias[:n] = -self._item_sq
            self._items_sharded, self._bias_sharded, self._l2_bias_sharded = shard_tables(
                self.mesh, items_p, pad_bias, l2_bias)
            self._rows_per_shard = items_p.shape[0] // shards

    def knn_query(self, query, k):
        # fused score + top-k (ops/fused_topk.py): the CUDA kernel on the
        # card, its plain version for tensors on the CPU
        if getattr(self, "_items_d", None) is None:
            self._build_device_index()
        q = torch.as_tensor(np.asarray(query, np.float32), device=self._items_d.device)
        k = min(k, self._items_d.shape[0])
        if self.measure == MEASURE_COSINE:
            q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
        if self.mesh is not None and k <= self._rows_per_shard:
            return self._knn_query_sharded(q, k)
        if self.measure == MEASURE_L2:
            # -|q - v|^2 = (2q)·v - |v|^2 - |q|^2; the |q|^2 term is
            # constant per query so top-k on (2q)·v - |v|^2 is exact, and
            # the returned distances add it back
            top_scores, top_idx = fused_topk(
                2.0 * q, self._items_d, k, bias=-self._item_sq,
                recall_target=self.recall_target,
            )
            top_scores = top_scores - (q**2).sum(1, keepdim=True)
        else:  # dot or cosine
            top_scores, top_idx = fused_topk(
                q, self._items_d, k, recall_target=self.recall_target
            )
        return top_idx.cpu().numpy(), -top_scores.cpu().numpy()

    def _knn_query_sharded(self, q, k):
        """Retrieval over the sharded table: each rank scores its rows and
        keeps a top-k, and the candidates are merged over the model axis
        (``sharded_topk``). ``q`` is already normalised for the cosine."""
        if self.measure == MEASURE_L2:
            # -|q - v|^2 ranking via (2q)·v - |v|^2 (see knn_query)
            s, i = sharded_topk(self.mesh, 2.0 * q, self._items_sharded, k,
                                item_bias=self._l2_bias_sharded)
            s = s - (q**2).sum(1, keepdim=True)
        else:
            s, i = sharded_topk(self.mesh, q, self._items_sharded, k,
                                item_bias=self._bias_sharded)
        return i.cpu().numpy(), -s.cpu().numpy()
