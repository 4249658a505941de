"""Base modality classes: auxiliary data aligned to the global ID maps.

A copy of ``cornac_tpu/data/modality.py`` (host numpy): ``Modality``,
``FeatureModality`` (dense or CSR features whose rows ``build`` realigns
to the dense index order of a global ID map, with optional min-max
normalisation) and the ``fallback_feature`` decorator.
"""

import numpy as np


class Modality:
    """Generic auxiliary-data modality."""

    def __init__(self, **kwargs):
        pass


def fallback_feature(func):
    """Decorator: when raw ``features`` exist, serve them via
    ``FeatureModality.batch_feature`` instead of the wrapped batch method."""

    def from_feature_matrix_if_present(self, *args, **kwargs):
        if self.features is None:
            return func(self, *args, **kwargs)
        ids = args[0] if args else kwargs["batch_ids"]
        return FeatureModality.batch_feature(self, batch_ids=ids)

    return from_feature_matrix_if_present


class FeatureModality(Modality):
    """Dense (or CSR) feature matrix whose rows align with entity indices.

    Parameters
    ----------
    features: 2d array or csr_matrix, optional
        Row ``k`` is the feature vector of the entity whose raw ID is
        ``ids[k]``.
    ids: list, optional
        Raw IDs aligned with feature rows; if None, row order is assumed to
        already match the dense index order.
    normalized: bool, default: False
        Min-max normalize features at build time.
    """

    def __init__(self, features=None, ids=None, normalized=False, **kwargs):
        super().__init__(**kwargs)
        self.features = features
        self.ids = ids
        self.normalized = normalized

    @property
    def features(self):
        if "_feat_matrix" not in self.__dict__:
            # pickles saved before the r5 rename stored the name-mangled key
            self._feat_matrix = self.__dict__.get("_FeatureModality__features")
        return self._feat_matrix

    @features.setter
    def features(self, matrix):
        if matrix is not None and len(matrix.shape) != 2:
            raise ValueError(
                f"features must be 2D (rows = entities), got shape {matrix.shape}"
            )
        self._feat_matrix = matrix

    @property
    def feature_dim(self):
        return self.features.shape[1]

    def _realign(self, id_map):
        """Reorder feature rows so row ``idx`` corresponds to the entity the
        global map assigns dense index ``idx`` (vectorized permutation
        instead of the reference's per-row loop, ``modality.py:80-91``)."""
        new_feats = np.copy(self.features)
        new_ids = list(self.ids)
        old_idx, new_idx = [], []
        for o, raw_id in enumerate(self.ids):
            n = id_map.get(raw_id, None)
            if n is None:
                continue
            assert n < new_feats.shape[0]
            old_idx.append(o)
            new_idx.append(n)
        if old_idx:
            old_idx = np.asarray(old_idx)
            new_idx = np.asarray(new_idx)
            new_feats[new_idx] = np.asarray(self.features)[old_idx]
            for o, n in zip(old_idx, new_idx):
                new_ids[n] = self.ids[o]
        self.features = new_feats
        self.ids = new_ids

    def build(self, id_map=None, **kwargs):
        """Align features with the global dense index order; optionally
        min-max normalize."""
        if self.features is None:
            return self

        if self.ids is not None and id_map is not None:
            self._realign(id_map)

        if self.normalized:
            shifted = self.features - np.min(self.features)
            self.features = shifted / (np.max(shifted) + 1e-10)

        return self

    def batch_feature(self, batch_ids):
        """Feature rows for a batch of entity indices."""
        if self.features is None:
            raise ValueError("no feature matrix: build() the modality first")
        return self.features[batch_ids]
