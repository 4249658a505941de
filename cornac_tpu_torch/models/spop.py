"""SPop — session popularity baseline (Hidasi et al., ICLR 2016).

Port of ``cornac_tpu/models/spop.py``: global popularity (normalised by the
largest count), plus the frequency of each item in the session's history.
Host numpy, deterministic: its scores equal the JAX package's exactly.
"""

from collections import Counter

import numpy as np

from .recommender import NextItemRecommender


class SPop(NextItemRecommender):
    """Global popularity plus (optionally) frequency within the current
    session history."""

    def __init__(self, name="SPop", use_session_popularity=True):
        super().__init__(name=name, trainable=False)
        self.use_session_popularity = use_session_popularity
        self.item_freq = Counter()

    def fit(self, train_set, val_set=None):
        super().fit(train_set=train_set, val_set=val_set)
        counts = np.bincount(
            np.asarray(self.train_set.uir_tuple[1]), minlength=self.total_items
        )
        self.item_freq = Counter({i: int(c) for i, c in enumerate(counts) if c})
        self._pop_row = counts / np.float64(max(counts.max(initial=0), 1))
        return self

    def score(self, user_idx, history_items, **kwargs):
        item_scores = self._pop_row.copy()
        if self.use_session_popularity:
            recent = np.asarray(list(history_items), dtype=np.int64)
            if recent.size:
                item_scores += np.bincount(recent, minlength=item_scores.size)
        return item_scores

    def score_history_batch(self, user_indices, histories):
        out = np.tile(self._pop_row[: self.num_items], (len(user_indices), 1))
        if self.use_session_popularity:
            for b, h in enumerate(histories):
                recent = np.asarray(list(h), dtype=np.int64)
                recent = recent[recent < self.num_items]
                if recent.size:
                    out[b] += np.bincount(recent, minlength=self.num_items)
        return out
