"""Recommender base classes.

Port of ``cornac_tpu/models/recommender.py``: ``ANNMixin`` and
``Recommender`` with the same contract, including the two vectorized hooks
the batched eval harness uses:

- ``score_batch(user_indices) -> (B, total_items)``: dense score matrix for
  a batch of users. Factor models override this with one device matmul;
  the default loops ``score`` (slow but correct for any model).
- ``score_pairs(users, items) -> (n,)`` / ``rate_batch``: vectorized
  pointwise prediction for rating metrics.

Device tensors live in process-local attributes listed in
``ignored_attrs``: they are never pickled and are rebuilt on demand.
``NextItemRecommender`` is the base of the session models: ``score`` takes
a history of items, and ``score_history_batch`` is the hook of the batched
next-item eval. ``NextBasketRecommender`` is the base of the basket models:
``score`` takes a history of baskets, and ``score_baskets_batch`` is the
hook of the batched next-basket eval.
"""

import copy
import inspect
import json
import os
import pickle
import warnings
from datetime import datetime
from glob import glob

import numpy as np
import torch

from ..device import resolve_device
from ..exception import ScoreException
from ..ops.fused_topk import fused_topk
from ..utils.common import clip

MEASURE_L2 = "l2 distance aka. Euclidean distance"
MEASURE_DOT = "dot product aka. inner product"
MEASURE_COSINE = "cosine similarity"


def is_ann_supported(recom):
    """True if the recommender exposes vectors for ANN indexing."""
    return getattr(recom, "_ann_supported", False)


class ANNMixin:
    """Mixin advertising vector representations for ANN search."""

    _ann_supported = True

    def get_vector_measure(self):
        """One of MEASURE_L2 / MEASURE_DOT / MEASURE_COSINE."""
        raise NotImplementedError("ANN-capable models declare their measure")

    def get_user_vectors(self):
        """Query vectors, one row per user."""
        raise NotImplementedError("ANN-capable models expose user vectors")

    def get_item_vectors(self):
        """Index vectors, one row per item."""
        raise NotImplementedError("ANN-capable models expose item vectors")


def pad_to_catalog(scores, total):
    """(B, total) host scores: the columns past the trained items (entities
    first seen in a later split) take each row's minimum, as the JAX
    package's factor models' ``score_batch`` gives them."""
    if scores.shape[1] >= total:
        return scores
    out = np.broadcast_to(scores.min(axis=1, keepdims=True), (scores.shape[0], total)).copy()
    out[:, : scores.shape[1]] = scores
    return out


class Recommender:
    """Generic recommender. Subclasses implement ``fit`` and ``score`` (and
    ideally ``score_batch``/``score_pairs`` for fast device evaluation)."""

    def __init__(self, name, trainable=True, verbose=False):
        self.name = name
        self.trainable = trainable
        self.verbose = verbose
        self.is_fitted = False

        # attributes excluded from saving (bulky data handles)
        self.ignored_attrs = ["train_set", "val_set", "test_set"]

        # train-set statistics captured at fit time (one tuple drives
        # both the None-init here and the snapshot in fit())
        for attr in self._DATASET_SNAPSHOT:
            setattr(self, attr, None)

        self._raw_user_ids = None
        self._raw_item_ids = None

    # ------------------------------------------------------------------ #
    # bookkeeping
    # ------------------------------------------------------------------ #
    @property
    def total_users(self):
        """User count including unknown test/val users."""
        return len(self.uid_map) if self.uid_map is not None else self.num_users

    @property
    def total_items(self):
        """Item count including unknown test/val items."""
        return len(self.iid_map) if self.iid_map is not None else self.num_items

    @property
    def user_ids(self):
        if self._raw_user_ids is None:
            self._raw_user_ids = list(self.uid_map.keys())
        return self._raw_user_ids

    @property
    def item_ids(self):
        if self._raw_item_ids is None:
            self._raw_item_ids = list(self.iid_map.keys())
        return self._raw_item_ids

    def reset_info(self):
        self.best_value = float("-inf")
        self.best_epoch = 0
        self.current_epoch = 0
        self.stopped_epoch = 0
        self.wait = 0

    def _device(self):
        """The ``torch.device`` this model computes on: this rank's device
        of its ``mesh`` when it has one, else its ``device`` attribute when
        one was given, else the process default (the card)."""
        if getattr(self, "mesh", None) is not None:
            from ..parallel.mesh import mesh_device

            return mesh_device(self.mesh)
        return resolve_device(getattr(self, "device", None))

    #: attributes holding process-local handles (a ``DeviceMesh`` names
    #: this process's group and ranks): never copied or persisted
    _process_local_attrs = ("mesh",)

    def __deepcopy__(self, memo):
        cls = self.__class__
        result = cls.__new__(cls)
        ignored = set(self.ignored_attrs)
        for k, v in self.__dict__.items():
            if k in ignored:
                continue
            if k in self._process_local_attrs:
                setattr(result, k, None)
                continue
            setattr(result, k, copy.deepcopy(v))
        return result

    @classmethod
    def _get_init_params(cls):
        """Constructor parameter names — this introspected signature doubles
        as the config schema for clone()/hyperopt."""
        params = inspect.signature(cls.__init__).parameters
        return sorted(n for n in params if n != "self")

    def clone(self, new_params=None):
        """Fresh instance with (optionally overridden) constructor params."""
        overrides = new_params or {}

        def current(name):
            if name in self._process_local_attrs:  # share, don't copy
                return getattr(self, name, None)
            return copy.deepcopy(getattr(self, name))

        return self.__class__(
            **{n: overrides.get(n, current(n)) for n in self._get_init_params()}
        )

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def save(self, save_dir=None, save_trainset=False, metadata=None):
        """Pickle the model (minus data handles and the mesh) plus a
        ``.meta`` JSON. Under a mesh every rank holds the same model: rank 0
        writes it while the others wait, and every rank returns its path."""
        if save_dir is None:
            return
        if getattr(self, "mesh", None) is not None:
            from ..parallel.mesh import on_rank_zero

            return on_rank_zero(lambda: self._save(save_dir, save_trainset, metadata))
        return self._save(save_dir, save_trainset, metadata)

    def _save(self, save_dir, save_trainset, metadata):
        def dump(obj, path):
            with open(path, "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)

        model_dir = os.path.join(save_dir, self.name)
        os.makedirs(model_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S-%f")
        model_file = os.path.join(model_dir, f"{stamp}.pkl")

        snapshot = copy.deepcopy(self)  # __deepcopy__ strips data handles
        dump(snapshot, model_file)
        if self.verbose:
            print(f"{self.name} model is saved to {model_file}")

        meta = dict(metadata or {})
        meta["model_classname"] = type(snapshot).__name__
        meta["model_file"] = os.path.basename(model_file)

        if save_trainset:
            dump(self.train_set, model_file + ".trainset")
            meta["trainset_file"] = meta["model_file"] + ".trainset"

        with open(model_file + ".meta", "w", encoding="utf-8") as f:
            json.dump(meta, f, ensure_ascii=False, indent=4)

        return model_file

    @staticmethod
    def load(model_path, trainable=False):
        """Load the newest ``.pkl`` in a directory, or an exact file path."""
        model_file = (
            sorted(glob(f"{model_path}/*.pkl"))[-1]
            if os.path.isdir(model_path)
            else model_path
        )
        with open(model_file, "rb") as f:
            model = pickle.load(f)
        model.trainable = trainable
        model.load_from = model_file
        return model

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    def enable_checkpointing(self, directory, every=10, resume=True, max_to_keep=3):
        """Turn on periodic training checkpoints and mid-training resume.

        Trainers built on :func:`cornac_tpu_torch.utils.checkpoint.epoch_loop`
        save their training carry (tables, parameters, optimizer state) to
        ``directory`` every ``every`` epochs and, when ``resume`` is true,
        continue from the newest checkpoint there. Each epoch's draws are
        keyed on the global epoch index, so a resumed seeded fit is the
        uninterrupted one, bit for bit. The format is the port's own
        (``utils/checkpoint.py``). Returns ``self`` for chaining.
        """
        self._ckpt_cfg = {
            "dir": str(directory),
            "every": max(1, int(every)),
            "resume": bool(resume),
            "max_to_keep": int(max_to_keep),
        }
        return self

    def disable_checkpointing(self):
        self._ckpt_cfg = None
        return self

    _DATASET_SNAPSHOT = (
        "num_users", "num_items", "uid_map", "iid_map",
        "min_rating", "max_rating", "global_mean",
    )

    def fit(self, train_set, val_set=None):
        """Capture train-set statistics; subclasses call super().fit() first
        and then run their training loop."""
        if self.is_fitted:
            warnings.warn("re-fitting an already-fitted model overwrites it")

        self.reset_info()
        train_set.reset()
        if val_set is not None:
            val_set.reset()

        for attr in self._DATASET_SNAPSHOT:
            setattr(self, attr, getattr(train_set, attr))
        self.train_set = train_set
        self.val_set = val_set
        self.is_fitted = True
        return self

    def knows_user(self, user_idx):
        """True if the user index is within the training prefix."""
        return user_idx is not None and 0 <= user_idx < self.num_users

    def knows_item(self, item_idx):
        """True if the item index is within the training prefix."""
        return item_idx is not None and 0 <= item_idx < self.num_items

    def is_unknown_user(self, user_idx):
        return not self.knows_user(user_idx)

    def is_unknown_item(self, item_idx):
        return not self.knows_item(item_idx)

    def transform(self, test_set):
        """Optional pre-eval hook to cache expensive test-time computations."""
        pass

    # ------------------------------------------------------------------ #
    # scoring
    # ------------------------------------------------------------------ #
    def score(self, user_idx, item_idx=None):
        """Score one (user, item) pair, or all known items when
        ``item_idx`` is None."""
        raise NotImplementedError("this model does not implement score prediction")

    def default_score(self):
        """Cold-start fallback score."""
        return self.global_mean

    def score_batch(self, user_indices):
        """(B, total_items) dense score matrix for a batch of users.

        Default: per-user ``score`` loop with the same unknown-item /
        exception fallbacks as ``rank`` (reference ``recommender.py:499-511``).
        Factor models override this with a single device matmul.
        """
        total = self.total_items
        out = np.empty((len(user_indices), total), dtype=np.float64)
        for b, user_idx in enumerate(user_indices):
            try:
                known = np.asarray(self.score(user_idx), dtype=np.float64)
            except ScoreException:
                known = np.full(total, self.default_score(), dtype=np.float64)
            if len(known) == total:
                out[b] = known
            else:
                out[b] = known.min()
                out[b, : len(known)] = known
        return out

    def _known_scores_device(self, safe_users, known):
        """Device (B, width) scores for the index-clamped user batch, or
        None when the model has no single-program batch scorer.
        ``safe_users`` has out-of-range indices clamped to 0; ``known``
        marks which rows were in range — the wrapper overwrites unknown
        rows with ``default_score()``, mirroring ``score_batch``."""
        return None

    def score_batch_device(self, user_indices):
        """Device-resident (B, >=num_items) score array for a batch of
        users, or None when the model has no single-program batch scorer.
        The fused eval path consumes this directly: ranking metrics are
        computed on device in the same dispatch stream, so only per-user
        metric values ever cross back to the host."""
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        dev = self._known_scores_device(np.where(known, users, 0), known)
        if dev is None or known.all():
            return dev
        known_d = torch.as_tensor(known, device=dev.device)[:, None]
        return torch.where(known_d, dev, float(self.default_score()))

    def score_pairs(self, user_indices, item_indices):
        """(n,) scores for aligned (user, item) index arrays. Default loops
        ``score``; vectorized in factor models."""
        out = np.empty(len(user_indices), dtype=np.float64)
        for i, (u, it) in enumerate(zip(user_indices, item_indices)):
            try:
                out[i] = self.score(u, it)
            except ScoreException:
                out[i] = self.default_score()
        return out

    def _score_pairs_from_rows(self, user_indices, item_indices, transform=None):
        """``score_pairs`` through ``score_batch`` of the unique users: one
        batch of rows instead of a call per pair. Only for models whose
        pointwise ``score(u, i)`` equals ``score(u)[i]`` (``transform``
        applies a pointwise-only mapping afterwards, e.g. BiVAECF's scaling
        to the rating range)."""
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        uniq, inv = np.unique(users, return_inverse=True)
        rows = np.asarray(self.score_batch(uniq), dtype=np.float64)
        out = rows[inv, np.minimum(items, rows.shape[1] - 1)]
        if transform is not None:
            out = transform(out)
        # unknown users/items fall back to the same (untransformed) default
        # as the score() loop's ScoreException path
        unknown = (items < 0) | (items >= self.num_items) | (users < 0) | (users >= self.num_users)
        if unknown.any():
            out = np.where(unknown, self.default_score(), out)
        return out

    def rate(self, user_idx, item_idx, clipping=True):
        """Pointwise rating prediction with optional clipping."""
        try:
            pred = self.score(user_idx, item_idx)
        except ScoreException:
            pred = self.default_score()
        return clip(pred, self.min_rating, self.max_rating) if clipping else pred

    def rate_batch(self, user_indices, item_indices, clipping=True):
        """Vectorized ``rate`` over aligned index arrays."""
        preds = np.asarray(self.score_pairs(user_indices, item_indices))
        if clipping:
            preds = clip(preds, self.min_rating, self.max_rating)
        return preds

    def rank(self, user_idx, item_indices=None, k=-1, **kwargs):
        """Rank candidate items for one user; returns (ranked_items, scores
        aligned with ``item_indices``)."""
        try:
            known = np.asarray(self.score(user_idx, **kwargs), dtype=np.float64)
        except ScoreException:
            known = np.full(self.total_items, self.default_score())

        # unknown items (beyond what score() covers) get the minimum score
        if len(known) == self.total_items:
            full = known
        else:
            full = np.full(self.total_items, known.min())
            full[: self.num_items] = known

        if item_indices is None:
            item_indices = np.arange(self.num_items)
        else:
            item_indices = np.asarray(item_indices)
        item_scores = full[item_indices]

        if k != -1:  # partial selection: O(n + k log k), best-first head
            head = np.argpartition(-item_scores, k - 1)[:k]
            head = head[np.argsort(-item_scores[head], kind="stable")]
            tail = np.delete(np.arange(len(item_scores)), np.sort(head))
            ranked_items = item_indices[np.concatenate([head, tail])]
        else:
            ranked_items = item_indices[np.argsort(-item_scores)]

        return ranked_items, item_scores

    def recommend(self, user_id, k=-1, remove_seen=False, train_set=None):
        """Top-k recommendation by raw user ID, returning raw item IDs."""
        user_idx = self.uid_map.get(user_id, -1)
        if user_idx == -1:
            raise ValueError(f"user id {user_id!r} was never seen during training")

        if k < -1 or k > self.total_items:
            raise ValueError(
                f"k={k} is out of range for a catalog of {self.total_items} items"
            )

        candidates = np.arange(self.total_items)
        if remove_seen:
            if train_set is None:
                raise ValueError("remove_seen=True requires a train_set")
            csr = train_set.csr_matrix
            if user_idx < csr.shape[0]:
                keep = np.ones(len(candidates), dtype=bool)
                keep[csr.getrow(user_idx).indices] = False
                candidates = candidates[keep]

        ranked, _ = self.rank(user_idx, candidates)
        return [self.item_ids[i] for i in (ranked if k == -1 else ranked[:k])]

    def recommend_batch(self, user_ids, k=-1, remove_seen=False, train_set=None):
        """Batch top-k recommendation by raw user IDs (device-batched when
        the model overrides ``score_batch``; dot-measure factor models take
        the fused device top-k path and never materialize the full score
        matrix on the host)."""
        user_idx = np.array([self.uid_map.get(uid, -1) for uid in user_ids])
        if (user_idx == -1).any():
            unknown = [uid for uid, i in zip(user_ids, user_idx) if i == -1]
            raise ValueError(f"user ids {unknown} were never seen during training")

        if k > 0:
            recs = self._topk_recommend_device(user_idx, k, remove_seen, train_set)
            if recs is not None:
                return recs

        scores = np.asarray(self.score_batch(user_idx), dtype=np.float64)
        if remove_seen:
            if train_set is None:
                raise ValueError("remove_seen=True requires a train_set")
            csr = train_set.csr_matrix
            for b, u in enumerate(user_idx):
                if u < csr.shape[0]:
                    scores[b, csr.getrow(u).indices] = -np.inf

        order = np.argsort(-scores, axis=1, kind="stable")
        if k != -1:
            order = order[:, :k]
        return [[self.item_ids[i] for i in row] for row in order]

    def _topk_recommend_device(self, user_idx, k, remove_seen, train_set):
        """Fused device top-k for dot-measure ANN-capable models, or None.

        Runs ``ops.fused_topk.fused_topk`` on the model's device (the CUDA
        kernel on the card): the (B, n_items) score matrix is never
        written out; only (B, k') ids come back. Seen items are handled by
        over-fetching ``k + max_seen`` then filtering — same ordering as
        the host path (ties broken by lower item index)."""
        if not is_ann_supported(self):
            return None
        try:
            if self.get_vector_measure() != MEASURE_DOT:
                return None
            U = np.asarray(self.get_user_vectors(), dtype=np.float32)
            V = np.asarray(self.get_item_vectors(), dtype=np.float32)
        except (NotImplementedError, AttributeError, TypeError, ValueError):
            return None
        if V.shape[0] != self.total_items or (user_idx >= U.shape[0]).any():
            return None

        csr = None
        fetch = k
        if remove_seen:
            if train_set is None:
                raise ValueError("remove_seen=True requires a train_set")
            csr = train_set.csr_matrix
            max_seen = int(np.diff(csr.indptr).max(initial=0))
            fetch = min(k + max_seen, V.shape[0])

        dev = self._device()
        _, top_idx = fused_topk(
            torch.as_tensor(U[user_idx], device=dev), torch.as_tensor(V, device=dev), fetch
        )
        top_idx = top_idx.cpu().numpy()

        recs = []
        for b, u in enumerate(user_idx):
            row = top_idx[b]
            if csr is not None and u < csr.shape[0]:
                seen = set(csr.getrow(u).indices)
                row = [i for i in row if i not in seen]
            recs.append([self.item_ids[i] for i in row[:k]])
        return recs

    # ------------------------------------------------------------------ #
    # early stopping
    # ------------------------------------------------------------------ #
    def monitor_value(self, train_set, val_set):
        """Value watched by ``early_stop``; override per model."""
        raise NotImplementedError("early-stopping models define what to watch")

    def early_stop(self, train_set, val_set, min_delta=0.0, patience=0):
        """Return True when training should stop (no improvement on the
        monitored validation value)."""
        self.current_epoch += 1
        current_value = self.monitor_value(train_set, val_set)
        if current_value is None:
            return False

        if np.greater_equal(current_value - self.best_value, min_delta):
            self.best_value = current_value
            self.best_epoch = self.current_epoch
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= patience:
                self.stopped_epoch = self.current_epoch

        if self.stopped_epoch > 0:
            print("Early stopping:")
            print(f"- best epoch = {self.best_epoch}, "
                  f"stopped epoch = {self.stopped_epoch}")
            print(f"- best monitored value = {self.best_value:.6f} "
                  f"(delta = {current_value - self.best_value:.6f})")
            return True
        return False


def _score_rows(model, user_indices, histories):
    """(B, total_items) float64 rows of ``model.score(u, h)`` for each
    (user, history) pair: ``default_score()`` on a ``ScoreException``, a
    short row filled with its minimum (eval-time unknown items)."""
    total = max(model.total_items, model.num_items)
    out = np.empty((len(user_indices), total), dtype=np.float64)
    for b, (u, h) in enumerate(zip(user_indices, histories)):
        try:
            row = np.asarray(model.score(u, h), dtype=np.float64)
        except ScoreException:
            row = np.full(total, model.default_score())
        if len(row) < total:
            fill = row.min() if len(row) else model.default_score()
            row = np.concatenate([row, np.full(total - len(row), fill)])
        out[b] = row[:total]
    return out


class NextBasketRecommender(Recommender):
    """Base for next-basket models: ``score`` takes history baskets."""

    def __init__(self, name, trainable=True, verbose=False):
        super().__init__(name=name, trainable=trainable, verbose=verbose)

    def score(self, user_idx, history_baskets, **kwargs):
        raise NotImplementedError("this model does not implement score prediction")

    def score_baskets_batch(self, user_indices, histories):
        """(B, total_items) float64 scores for a batch of (user, history
        baskets) pairs, the hook the batched next-basket eval calls. The
        default loops ``score``; the width covers eval-time unknown items
        (filled with the row's minimum)."""
        return _score_rows(self, user_indices, histories)


class NextItemRecommender(Recommender):
    """Base for next-item models: ``score`` takes history items."""

    def __init__(self, name, trainable=True, verbose=False):
        super().__init__(name=name, trainable=trainable, verbose=verbose)

    def score(self, user_idx, history_items, **kwargs):
        raise NotImplementedError("this model does not implement score prediction")

    def score_history_batch(self, user_indices, histories):
        """(B, total_items) float64 scores for a batch of (user, history)
        pairs, the hook the batched next-item eval calls. Sequence models
        override it with one padded forward on their device; the default
        loops ``score``. The width covers eval-time unknown items (filled
        with the row's minimum) so the eval can slice to its candidates."""
        return _score_rows(self, user_indices, histories)
