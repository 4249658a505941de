"""Interaction data with dense user/item indices (host-side numpy).

A copy of ``cornac_tpu/data/dataset.py::Dataset`` with the same ID-mapping
invariant: raw IDs map to dense indices through shared global maps,
train-set entities occupy the prefix ``[0, num_users)`` and entities first
seen in a later split take the tail indices. Every model and the eval loop
rely on this to detect cold-start entities. The CSR, CSC and DOK views and
the modality slots, the per-entity views (``user_data``, ...), the
vectorised lookups (``lookup_ratings``, ``is_observed``) and the batch
iterators are the JAX package's: they draw from the dataset's numpy ``rng``
in the same order, so a seed gives byte-identical batches in both packages.
``PurchaseViewDataset`` (purchases with an aligned view matrix, for
VEBPR) and ``SequentialDataset`` (sessions, for the next-item models) are
the JAX package's too; the basket dataset comes with the next-basket
models (ROADMAP.md A10).
"""

import copy
import os
import pickle
import warnings
from collections import Counter, OrderedDict, defaultdict

import numpy as np
from scipy.sparse import csc_matrix, csr_matrix

from ..utils import estimate_batches, get_rng, validate_format


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

    def _group_by(self, key_arr, with_time=False):
        """Group (items|users, ratings[, ts]) lists by the entities in
        ``key_arr`` with one stable argsort (no Python loop per row)."""
        u, i, r = self.uir_tuple
        val_arr = i if key_arr is u else u
        out = defaultdict()
        order = np.argsort(key_arr, kind="stable")
        keys_sorted = key_arr[order]
        boundaries = np.flatnonzero(np.diff(keys_sorted)) + 1
        starts = np.concatenate(([0], boundaries))
        ends = np.concatenate((boundaries, [len(keys_sorted)]))
        for s, e in zip(starts, ends):
            idx = order[s:e]
            if with_time:
                idx = idx[np.argsort(self.timestamps[idx], kind="stable")]
                out[keys_sorted[s]] = (
                    list(val_arr[idx]), list(r[idx]), list(self.timestamps[idx]))
            else:
                out[keys_sorted[s]] = (list(val_arr[idx]), list(r[idx]))
        return out

    @property
    def user_data(self):
        """Dict: user index -> ([items], [ratings])."""
        return self._cached("user_data", lambda: self._group_by(self.uir_tuple[0]))

    @property
    def item_data(self):
        """Dict: item index -> ([users], [ratings])."""
        return self._cached("item_data", lambda: self._group_by(self.uir_tuple[1]))

    def _chrono(self, key, axis):
        if self.timestamps is None:
            raise ValueError("this view needs timestamps, but the data has none")
        return self._cached(key, lambda: self._group_by(self.uir_tuple[axis], with_time=True))

    @property
    def chrono_user_data(self):
        """Dict: user -> ([items], [ratings], [timestamps]) sorted by time."""
        return self._chrono("chrono_user_data", 0)

    @property
    def chrono_item_data(self):
        """Dict: item -> ([users], [ratings], [timestamps]) sorted by time."""
        return self._chrono("chrono_item_data", 1)

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

    @property
    def _sorted_keys(self):
        """The interactions' keys ``u * num_items + i``, sorted, and the
        order that sorts them: host lookups by binary search."""
        def build():
            u, i, _ = self.uir_tuple
            keys = u.astype(np.int64) * self.num_items + i.astype(np.int64)
            order = np.argsort(keys)
            return keys[order], order

        return self._cached("sorted_keys", build)

    def _find(self, users, items):
        """(position in the sorted keys, found) of each (user, item) pair."""
        sorted_keys, _ = self._sorted_keys
        keys = (np.asarray(users, dtype=np.int64) * self.num_items
                + np.asarray(items, dtype=np.int64))
        pos = np.minimum(np.searchsorted(sorted_keys, keys), len(sorted_keys) - 1)
        return pos, sorted_keys[pos] == keys

    def lookup_ratings(self, users, items):
        """Vectorized rating lookup; 0.0 for unobserved pairs."""
        pos, found = self._find(users, items)
        out = np.zeros(len(found), dtype=np.float64)
        out[found] = self.uir_tuple[2][self._sorted_keys[1][pos[found]]]
        return out

    def is_observed(self, users, items):
        """Vectorized membership test for (user, item) pairs."""
        return self._find(users, items)[1]

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

    @classmethod
    def from_uirt(cls, data, seed=None):
        """Build from (user, item, rating, timestamp) quadruplets."""
        return cls.build(data, "UIRT", seed=seed)

    def reset(self):
        """Re-seed the iterator RNG for reproducible epochs."""
        self.rng = get_rng(self.seed)
        return self

    def num_batches(self, batch_size):
        return estimate_batches(len(self.uir_tuple[0]), batch_size)

    def num_user_batches(self, batch_size):
        return estimate_batches(self.num_users, batch_size)

    def num_item_batches(self, batch_size):
        return estimate_batches(self.num_items, batch_size)

    def idx_iter(self, idx_range, batch_size=1, shuffle=False):
        """Yield batches of indices over ``range(idx_range)``."""
        order = np.arange(idx_range)
        if shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            yield order[start : start + batch_size]

    def _sample_negatives(self, users, reject_fn, population=None, max_rounds=100):
        """Vectorized rejection sampling of negative items: draw one per
        user, then redraw only the entries ``reject_fn(users, items)``
        rejects, for at most ``max_rounds`` rounds."""
        def draw(size):
            if population is None:
                return self.rng.randint(0, self.num_items, size=size)
            return population[self.rng.randint(0, len(population), size=size)]

        neg = draw(len(users))
        bad = reject_fn(users, neg)
        rounds = 0
        while bad.any() and rounds < max_rounds:
            neg[bad] = draw(int(bad.sum()))
            bad = reject_fn(users, neg) & bad
            rounds += 1
        return neg

    def uir_iter(self, batch_size=1, shuffle=False, binary=False, num_zeros=0):
        """Yield (users, items, ratings) batches, optionally with sampled
        unobserved (zero-rating) pairs appended."""
        u_arr, i_arr, r_arr = self.uir_tuple
        for batch_ids in self.idx_iter(len(u_arr), batch_size, shuffle):
            batch_users = u_arr[batch_ids]
            batch_items = i_arr[batch_ids]
            batch_ratings = np.ones_like(batch_items) if binary else r_arr[batch_ids]
            if num_zeros > 0:
                repeated_users = batch_users.repeat(num_zeros)
                neg_items = self._sample_negatives(
                    repeated_users, reject_fn=lambda us, its: self.lookup_ratings(us, its) > 0)
                batch_users = np.concatenate((batch_users, repeated_users))
                batch_items = np.concatenate((batch_items, neg_items))
                batch_ratings = np.concatenate((batch_ratings, np.zeros_like(neg_items)))
            yield batch_users, batch_items, batch_ratings

    def uij_iter(self, batch_size=1, shuffle=False, neg_sampling="uniform"):
        """Yield (users, pos_items, neg_items) BPR triplets. A negative j is
        redrawn while the user rated it at least as high as the positive.
        ``neg_sampling='popularity'`` draws negatives in proportion to item
        frequency (from the interaction item array)."""
        if neg_sampling.lower() == "uniform":
            population = None
        elif neg_sampling.lower() == "popularity":
            population = self.uir_tuple[1]
        else:
            raise ValueError("Unsupported negative sampling option: {}".format(neg_sampling))

        u_arr, i_arr, r_arr = self.uir_tuple
        for batch_ids in self.idx_iter(len(u_arr), batch_size, shuffle):
            batch_users = u_arr[batch_ids]
            pos_ratings = r_arr[batch_ids]
            batch_neg = self._sample_negatives(
                batch_users,
                reject_fn=lambda us, its, pr=pos_ratings: (
                    (self.lookup_ratings(us, its) >= pr) & self.is_observed(us, its)),
                population=population,
            )
            yield batch_users, i_arr[batch_ids], batch_neg

    def _entity_iter(self, axis, batch_size, shuffle):
        """Batches of the distinct entity ids on one side of the data."""
        distinct = np.unique(self.uir_tuple[axis])
        for batch_ids in self.idx_iter(len(distinct), batch_size, shuffle):
            yield distinct[batch_ids]

    def user_iter(self, batch_size=1, shuffle=False):
        """Yield batches of distinct user indices present in the data."""
        return self._entity_iter(0, batch_size, shuffle)

    def item_iter(self, batch_size=1, shuffle=False):
        """Yield batches of distinct item indices present in the data."""
        return self._entity_iter(1, batch_size, shuffle)

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


def _id_map_kwargs(global_uid_map, global_iid_map):
    """Constructor kwargs shared by the dataset builders: the global id maps
    plus the entity counts they imply."""
    return dict(
        num_users=len(global_uid_map),
        num_items=len(global_iid_map),
        uid_map=global_uid_map,
        iid_map=global_iid_map,
    )


class SequentialDataset(Dataset):
    """Interaction data grouped into sessions (SIT / USIT / ±Json input).

    A copy of ``cornac_tpu/data/dataset.py::SequentialDataset``: the session
    map and its dense indices, ``sessions`` (session -> row positions in
    input order, the ground-truth sequence), the per-user and chronological
    views, the session-size statistics and the batch iterators.
    """

    def __init__(
        self, num_users, num_sessions, num_items, uid_map, sid_map,
        iid_map, uir_tuple, session_indices=None, timestamps=None,
        extra_data=None, seed=None,
    ):
        super().__init__(
            num_users, num_items, uid_map, iid_map, uir_tuple,
            timestamps=timestamps, seed=seed,
        )
        self.num_sessions, self.sid_map = num_sessions, sid_map
        self.session_indices, self.extra_data = session_indices, extra_data
        session_sizes = list(Counter(session_indices).values())
        self.max_session_size = int(np.max(session_sizes))
        self.min_session_size = int(np.min(session_sizes))
        self.avg_session_size = float(np.mean(session_sizes))

    @property
    def session_ids(self):
        """Raw session IDs ordered by dense index."""
        return self._cached("session_ids", lambda: list(self.sid_map.keys()))

    @property
    def sessions(self):
        """Ordered dict: session index -> observation row positions."""

        def build():
            out = OrderedDict()
            for idx, sid in enumerate(self.session_indices):
                out.setdefault(sid, []).append(idx)
            return out

        return self._cached("sessions", build)

    @property
    def user_session_data(self):
        """Dict: user index -> list of session indices."""

        def build():
            out = defaultdict(list)
            for sid, ids in self.sessions.items():
                out[self.uir_tuple[0][ids[0]]].append(sid)
            return out

        return self._cached("user_session_data", build)

    @property
    def chrono_user_session_data(self):
        """Dict: user -> ([session ids], [timestamps]) sorted by time."""

        def build():
            assert self.timestamps is not None
            out = defaultdict(lambda: ([], []))
            for sid, ids in self.sessions.items():
                u = self.uir_tuple[0][ids[0]]
                out[u][0].append(sid)
                out[u][1].append(self.timestamps[ids[0]])
            for user, (sessions, ts) in out.items():
                order = np.argsort(ts)
                out[user] = (
                    [sessions[i] for i in order],
                    [ts[i] for i in order],
                )
            return out

        return self._cached("chrono_user_session_data", build)

    @classmethod
    def build(
        cls, data, fmt="SIT", global_uid_map=None, global_sid_map=None,
        global_iid_map=None, seed=None, exclude_unknowns=False,
    ):
        """Construct from session tuples; user column optional depending on
        format. Row order within a session is the ground-truth sequence."""
        fmt = validate_format(fmt, ["SIT", "USIT", "SITJson", "USITJson"])

        global_uid_map = OrderedDict() if global_uid_map is None else global_uid_map
        global_sid_map = OrderedDict() if global_sid_map is None else global_sid_map
        global_iid_map = OrderedDict() if global_iid_map is None else global_iid_map

        has_user = fmt in ("USIT", "USITJson")
        u_indices, s_indices, i_indices, valid_idx = [], [], [], []
        for idx, tup in enumerate(data):
            if has_user:
                uid, sid, iid = tup[0], tup[1], tup[2]
            else:
                uid, sid, iid = None, tup[0], tup[1]
            if exclude_unknowns and (iid not in global_iid_map):
                continue
            u_indices.append(global_uid_map.setdefault(uid, len(global_uid_map)))
            s_indices.append(global_sid_map.setdefault(sid, len(global_sid_map)))
            i_indices.append(global_iid_map.setdefault(iid, len(global_iid_map)))
            valid_idx.append(idx)

        uir_tuple = (
            np.asarray(u_indices, dtype="int"),
            np.asarray(i_indices, dtype="int"),
            np.ones(len(u_indices), dtype="float"),
        )
        session_indices = np.asarray(s_indices, dtype="int")

        ts_pos = 3 if has_user else 2
        timestamps = np.fromiter(
            (int(data[i][ts_pos]) for i in valid_idx), dtype="int"
        )
        extra_data = (
            [data[i][ts_pos + 1] for i in valid_idx]
            if fmt in ("SITJson", "USITJson")
            else None
        )

        return cls(
            num_sessions=len(set(s_indices)),
            sid_map=global_sid_map,
            **_id_map_kwargs(global_uid_map, global_iid_map),
            uir_tuple=uir_tuple,
            session_indices=session_indices,
            timestamps=timestamps,
            extra_data=extra_data,
            seed=seed,
        )

    @classmethod
    def from_sit(cls, data, seed=None):
        return cls.build(data, "SIT", seed=seed)

    @classmethod
    def from_usit(cls, data, seed=None):
        return cls.build(data, "USIT", seed=seed)

    @classmethod
    def from_sitjson(cls, data, seed=None):
        return cls.build(data, "SITJson", seed=seed)

    @classmethod
    def from_usitjson(cls, data, seed=None):
        return cls.build(data, "USITJson", seed=seed)

    def num_batches(self, batch_size):
        return estimate_batches(len(self.sessions), batch_size)

    def session_iter(self, batch_size=1, shuffle=False):
        """Yield batches of session indices."""
        session_indices = np.array(list(self.sessions.keys()))
        for batch_ids in self.idx_iter(len(session_indices), batch_size, shuffle):
            yield session_indices[batch_ids]

    def s_iter(self, batch_size=1, shuffle=False):
        """Yield (session ids, their observation row positions)."""
        for batch_session_ids in self.session_iter(batch_size, shuffle):
            batch_mapped_ids = [self.sessions[sid] for sid in batch_session_ids]
            yield batch_session_ids, batch_mapped_ids

    def si_iter(self, batch_size=1, shuffle=False):
        """Yield (session ids, row positions, per-session item lists)."""
        item_arr = self.uir_tuple[1]
        for batch_session_ids, batch_mapped_ids in self.s_iter(batch_size, shuffle):
            batch_session_items = [
                [item_arr[i] for i in ids] for ids in batch_mapped_ids
            ]
            yield batch_session_ids, batch_mapped_ids, batch_session_items

    def usi_iter(self, batch_size=1, shuffle=False):
        """Yield (users, session ids, row positions, item lists) grouped by user."""
        item_arr = self.uir_tuple[1]
        for user_indices in self.user_iter(batch_size, shuffle):
            batch_sids = [list(self.user_session_data[uid]) for uid in user_indices]
            batch_mapped_ids = [
                [self.sessions[sid] for sid in sids] for sids in batch_sids
            ]
            batch_session_items = [
                [[item_arr[i] for i in ids] for ids in mapped]
                for mapped in batch_mapped_ids
            ]
            yield user_indices, batch_sids, batch_mapped_ids, batch_session_items


class PurchaseViewDataset(Dataset):
    """Purchase (primary) interactions plus an aligned 'view' matrix for
    multi-behaviour models (VEBPR), as the JAX package builds it: view
    entries that are also purchases are dropped, so the matrix holds what
    was viewed but not purchased.
    """

    def __init__(self, dataset, view_matrix):
        super().__init__(
            num_users=dataset.num_users,
            num_items=dataset.num_items,
            uid_map=dataset.uid_map,
            iid_map=dataset.iid_map,
            uir_tuple=dataset.uir_tuple,
            timestamps=getattr(dataset, "timestamps", None),
            seed=getattr(dataset, "seed", None),
        )
        view_matrix = view_matrix - view_matrix.multiply(self.matrix > 0)
        view_matrix.eliminate_zeros()
        view_matrix.sort_indices()
        self.view_matrix = view_matrix

    @classmethod
    def build(cls, purchase_data, view_data, seed=None):
        """Build from two raw UIR streams sharing one ID space; entities from
        either stream are retained."""
        global_uid_map = OrderedDict()
        global_iid_map = OrderedDict()

        purchase_set = Dataset.build(
            purchase_data,
            fmt="UIR",
            global_uid_map=global_uid_map,
            global_iid_map=global_iid_map,
            seed=seed,
        )
        view_set = Dataset.build(
            view_data,
            fmt="UIR",
            global_uid_map=global_uid_map,
            global_iid_map=global_iid_map,
            seed=seed,
        )

        full_purchase = Dataset(
            uir_tuple=purchase_set.uir_tuple,
            seed=seed,
            **_id_map_kwargs(global_uid_map, global_iid_map),
        )
        return cls(full_purchase, view_set.matrix)

    @classmethod
    def attach_view(cls, dataset, view_data):
        """Attach a raw view stream to an existing purchase dataset; unknown
        entities in the view stream are dropped."""
        view_set = Dataset.build(
            view_data,
            fmt="UIR",
            global_uid_map=dataset.uid_map,
            global_iid_map=dataset.iid_map,
            exclude_unknowns=True,
        )
        return cls(dataset, view_set.matrix)
