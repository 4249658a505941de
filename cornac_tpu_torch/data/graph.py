"""Graph modality: adjacency triplets aligned to dense entity indices.

A copy of ``cornac_tpu/data/graph.py`` (host numpy / scipy): the CSR
``matrix`` over every node of the global ID map, the train triplets, node
degrees, and ``from_feature``'s k-nearest-neighbour graph by a blocked
``X @ X.T`` and ``argpartition``.
"""

import numpy as np
import scipy.sparse as sp

from .modality import FeatureModality


class GraphModality(FeatureModality):
    """User/user or item/item relations as sparse triplets
    ``(raw_id_i, raw_id_j, value)``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.raw_data = kwargs.get("data", None)
        self._csr_cache = None
        self._n_nodes = None

    @property
    def matrix(self):
        """Adjacency matrix in CSR format over dense indices."""
        if getattr(self, "_csr_cache", None) is None:
            # getattr/.get: pickles from before the r5 rename carry the old
            # name-mangled cache/size keys
            n = getattr(self, "_n_nodes", None)
            if n is None:
                n = self.__dict__.get("_GraphModality__matrix_size")
            if n is None:
                raise ValueError("build() the modality before reading .matrix")
            self._csr_cache = sp.csr_matrix(
                (self.val, (self.map_rid, self.map_cid)), shape=(n, n)
            )
        return self._csr_cache

    def _build_triplet(self, id_map):
        # edges with either endpoint outside the id map are dropped
        kept = [
            (id_map[i], id_map[j], v)
            for i, j, v in self.raw_data
            if i in id_map and j in id_map
        ]
        rid, cid, val = zip(*kept) if kept else ((), (), ())
        self.map_rid = np.asarray(rid, dtype="int")
        self.map_cid = np.asarray(cid, dtype="int")
        self.val = np.asarray(val, dtype="float")

    def build(self, id_map=None, **kwargs):
        super().build(id_map=id_map)
        self._csr_cache = None
        if id_map is not None:
            self._n_nodes = int(max(id_map.values()) + 1)
            self._build_triplet(id_map)
        return self

    def get_train_triplet(self, train_row_ids, train_col_ids):
        """Subset of relations whose endpoints are both in the given
        (training) index sets, as (rows, cols, vals)."""
        train_row_ids = np.asarray(list(train_row_ids))
        train_col_ids = np.asarray(list(train_col_ids))
        mask = np.isin(self.map_rid, train_row_ids) & np.isin(
            self.map_cid, train_col_ids
        )
        return self.map_rid[mask], self.map_cid[mask], self.val[mask]

    def get_node_degree(self, in_ids=None, out_ids=None):
        """Dict: node index -> [in_degree, out_degree] over the subgraph
        induced by (in_ids, out_ids). Degrees come from two bincounts over
        the filtered edge list rather than a per-edge Python loop."""
        sources = self.map_rid if out_ids is None else np.asarray(list(out_ids))
        sinks = self.map_cid if in_ids is None else np.asarray(list(in_ids))
        mask = np.isin(self.map_rid, sources) & np.isin(self.map_cid, sinks)
        rows, cols = self.map_rid[mask], self.map_cid[mask]

        width = int(max(rows.max(initial=-1), cols.max(initial=-1))) + 1
        outs = np.bincount(rows, minlength=width)
        ins = np.bincount(cols, minlength=width)
        return {
            int(node): np.asarray([ins[node], outs[node]])
            for node in np.union1d(rows, cols)
        }

    def batch(self, batch_ids):
        """Adjacency rows for a batch of node indices."""
        return self.matrix[batch_ids]

    @staticmethod
    def _build_knn(features, k=5, similarity="cosine", verbose=True, block_size=1024):
        """k nearest neighbours per row by cosine similarity: a blocked
        ``X @ X.T`` in float32 on the host, each row's own entry set to
        -inf, then ``argpartition``. Where the k-th and (k+1)-th
        similarities of a row differ, the set is the k most similar rows;
        within a tied group at that boundary ``argpartition`` keeps an
        arbitrary member (numpy's introselect, the JAX package's choice
        too: the same call on the same float32 array), so only tie-free
        data fixes the set. The order inside a row's k is unspecified."""
        if similarity != "cosine":
            raise ValueError("Only cosine similarity is supported")
        feats = np.asarray(features, dtype=np.float32)
        norms = np.linalg.norm(feats, axis=1, keepdims=True)
        feats = feats / (norms + 1e-20)
        n = len(feats)
        neighbors = np.zeros((n, k), dtype=np.int64)
        for start in range(0, n, block_size):
            stop = min(start + block_size, n)
            sim = feats[start:stop] @ feats.T  # (block, n)
            rows = np.arange(start, stop)
            sim[np.arange(stop - start), rows] = -np.inf  # exclude self
            neighbors[start:stop] = np.argpartition(sim, -k, axis=1)[:, -k:]
        return neighbors

    @staticmethod
    def _to_triplet(mat, ids=None):
        label = (lambda x: x) if ids is None else (lambda x: ids[x])
        return {
            (label(row), label(int(col)), 1.0)
            for row in range(mat.shape[0])
            for col in mat[row]
        }

    @staticmethod
    def _to_symmetric(triplets):
        reversed_edges = {(j, i, v) for (i, j, v) in triplets}
        return triplets | reversed_edges

    @classmethod
    def from_feature(
        cls, features, k=5, ids=None, similarity="cosine", symmetric=False, verbose=True
    ):
        """Build a kNN graph from feature vectors."""
        knn = cls._build_knn(features, k, similarity, verbose=verbose)
        triplets = cls._to_triplet(knn, ids=ids)
        if symmetric:
            triplets = cls._to_symmetric(triplets)
        return cls(data=triplets)
