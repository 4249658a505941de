"""Interaction data with dense user/item indices (host-side numpy).

A copy of ``cornac_tpu/data/dataset.py::Dataset`` with the same ID-mapping
invariant: raw IDs map to dense indices through shared global maps,
train-set entities occupy the prefix ``[0, num_users)`` and entities first
seen in a later split take the tail indices. Every model and the eval loop
rely on this to detect cold-start entities. The CSR, CSC and DOK views and
the modality slots are the JAX package's; the per-entity views
(``user_data``, ...), the batch iterators and the basket, sequential and
purchase-view datasets come with the models that use them.
"""

import copy
import os
import pickle
import warnings
from collections import OrderedDict

import numpy as np
from scipy.sparse import csc_matrix, csr_matrix

from ..utils import get_rng, validate_format


class Dataset:
    """Preference data with dense user/item indices.

    Parameters
    ----------
    num_users, num_items: int
        Entity counts (including tail/unknown entities when built with
        global maps).
    uid_map, iid_map: OrderedDict
        Raw ID -> dense index maps.
    uir_tuple: tuple of 3 numpy arrays
        (user_indices, item_indices, rating_values).
    timestamps: numpy array, optional
        Per-observation timestamps (UIRT input).
    seed: int, optional
        Seed for the iterator RNG.
    """

    def __init__(
        self, num_users, num_items, uid_map, iid_map, uir_tuple,
        timestamps=None, seed=None,
    ):
        self.num_users, self.num_items = num_users, num_items
        self.uid_map, self.iid_map = uid_map, iid_map
        self.uir_tuple, self.timestamps = uir_tuple, timestamps
        self.seed, self.rng = seed, get_rng(seed)

        r_values = uir_tuple[2]
        self.num_ratings = len(r_values)
        self.max_rating = float(np.max(r_values))
        self.min_rating = float(np.min(r_values))
        self.global_mean = float(np.mean(r_values))

        self._cache = {}
        # attributes dropped when deep-copying / pickling (lazy caches)
        self.ignored_attrs = ["_cache"]

    def _cached(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def user_ids(self):
        """Raw user IDs ordered by dense index."""
        return self._cached("user_ids", lambda: list(self.uid_map.keys()))

    @property
    def item_ids(self):
        """Raw item IDs ordered by dense index."""
        return self._cached("item_ids", lambda: list(self.iid_map.keys()))

    @property
    def matrix(self):
        return self.csr_matrix

    @property
    def csr_matrix(self):
        def build():
            u, i, r = self.uir_tuple
            return csr_matrix((r, (u, i)), shape=(self.num_users, self.num_items))

        return self._cached("csr", build)

    @property
    def csc_matrix(self):
        def build():
            u, i, r = self.uir_tuple
            return csc_matrix((r, (u, i)), shape=(self.num_users, self.num_items))

        return self._cached("csc", build)

    @property
    def dok_matrix(self):
        # cheapest DOK construction: convert the (deduplicated) CSR view
        return self._cached("dok", lambda: self.csr_matrix.todok())

    @classmethod
    def build(
        cls, data, fmt="UIR", global_uid_map=None, global_iid_map=None,
        seed=None, exclude_unknowns=False,
    ):
        """Construct a Dataset, extending the shared global ID maps.

        Train-first build order guarantees the prefix-index invariant:
        entities first seen here get the next free dense index in the
        global maps.
        """
        fmt = validate_format(fmt, ["UIR", "UIRT"])

        global_uid_map = OrderedDict() if global_uid_map is None else global_uid_map
        global_iid_map = OrderedDict() if global_iid_map is None else global_iid_map

        users, items, ratings, kept_rows = [], [], [], []
        seen_pairs, n_dupes = set(), 0

        for row, (uid, iid, rating, *_rest) in enumerate(data):
            if exclude_unknowns and (
                uid not in global_uid_map or iid not in global_iid_map
            ):
                continue
            if (uid, iid) in seen_pairs:
                n_dupes += 1
                continue
            seen_pairs.add((uid, iid))

            users.append(global_uid_map.setdefault(uid, len(global_uid_map)))
            items.append(global_iid_map.setdefault(iid, len(global_iid_map)))
            ratings.append(float(rating))
            kept_rows.append(row)

        if n_dupes:
            warnings.warn(
                f"dropped {n_dupes} duplicate (user, item) observations"
            )
        if not seen_pairs:
            raise ValueError("no observations left after filtering")

        uir = (
            np.asarray(users, dtype="int"),
            np.asarray(items, dtype="int"),
            np.asarray(ratings, dtype="float"),
        )
        timestamps = (
            np.fromiter((int(data[i][3]) for i in kept_rows), dtype="int")
            if fmt == "UIRT"
            else None
        )

        return cls(
            num_users=len(global_uid_map),
            num_items=len(global_iid_map),
            uid_map=global_uid_map,
            iid_map=global_iid_map,
            uir_tuple=uir,
            timestamps=timestamps,
            seed=seed,
        )

    @classmethod
    def from_uir(cls, data, seed=None):
        """Build from (user, item, rating) triplets."""
        return cls.build(data, "UIR", seed=seed)

    def reset(self):
        """Re-seed the iterator RNG for reproducible epochs."""
        self.rng = get_rng(self.seed)
        return self

    _MODALITY_ATTRS = (
        "user_feature", "item_feature", "user_text", "item_text",
        "user_image", "item_image", "user_graph", "item_graph",
        "sentiment", "review_text",
    )

    def add_modalities(self, **kwargs):
        """Attach modalities by slot name; a slot not given is set to None."""
        for attr in self._MODALITY_ATTRS:
            setattr(self, attr, kwargs.get(attr, None))

    def __deepcopy__(self, memo):
        cls = self.__class__
        result = cls.__new__(cls)
        ignored = set(self.ignored_attrs)
        for k, v in self.__dict__.items():
            if k in ignored:
                continue
            setattr(result, k, copy.deepcopy(v))
        result._cache = {}
        return result

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k not in self.ignored_attrs}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cache = {}

    def save(self, fpath):
        """Pickle this dataset to ``fpath``."""
        dirname = os.path.dirname(fpath)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        with open(fpath, "wb") as f:
            pickle.dump(self, f, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(fpath):
        """Load a pickled dataset."""
        with open(fpath, "rb") as f:
            dataset = pickle.load(f)
        dataset.load_from = fpath
        return dataset
