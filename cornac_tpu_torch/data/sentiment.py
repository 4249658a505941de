"""Sentiment (aspect/opinion) modality.

A copy of ``cornac_tpu/data/sentiment.py``: lexicon entries
``(user, item, [(aspect, opinion, polarity), ...])`` restricted to the
observed train pairs, with dense aspect/opinion ID maps in first-appearance
order.
"""

from collections import OrderedDict

from .modality import Modality


class SentimentModality(Modality):
    """Aspect-opinion-polarity lexicon keyed by (user, item) pairs.

    After :meth:`build`, ``user_sentiment[u][i]`` (and the transposed
    ``item_sentiment``) point at the lexicon row for that pair, and
    ``sentiment[row]`` holds its triples with aspects/opinions re-indexed
    into dense ids (first-appearance order).
    """

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.raw_data = kwargs.get("data", OrderedDict())

    @property
    def num_aspects(self):
        return len(self.aspect_id_map)

    @property
    def num_opinions(self):
        return len(self.opinion_id_map)

    def _index_lexicon(self, uid_map, iid_map, dok_matrix):
        by_user, by_item = OrderedDict(), OrderedDict()
        aspects, opinions = OrderedDict(), OrderedDict()
        kept = OrderedDict()

        for row, (raw_uid, raw_iid, triples) in enumerate(self.raw_data):
            u, i = uid_map.get(raw_uid), iid_map.get(raw_iid)
            if u is None or i is None or dok_matrix[u, i] == 0:
                # lexicon rows outside the observed train pairs are dropped
                continue
            by_user.setdefault(u, OrderedDict())[i] = row
            by_item.setdefault(i, OrderedDict())[u] = row
            kept[row] = [
                (
                    aspects.setdefault(t[0], len(aspects)),
                    opinions.setdefault(t[1], len(opinions)),
                    float(t[2]),
                )
                for t in triples
            ]

        self.user_sentiment, self.item_sentiment = by_user, by_item
        self.sentiment = kept
        self.aspect_id_map, self.opinion_id_map = aspects, opinions

    def build(self, uid_map=None, iid_map=None, dok_matrix=None, **kwargs):
        """Index the lexicon against the train set's observed pairs."""
        if uid_map is not None and iid_map is not None and dok_matrix is not None:
            self._index_lexicon(uid_map, iid_map, dok_matrix)
        return self
