"""Text modality and its small NLP stack (host numpy / scipy).

A copy of ``cornac_tpu/data/text.py``: ``BaseTokenizer``, ``Vocabulary``,
``CountVectorizer``, ``TfidfVectorizer``, ``TextModality`` and
``ReviewModality``. The vocabulary order, the sparse matrices and
``batch_seq`` / ``batch_bow`` / ``batch_tfidf`` are the JAX package's, byte
for byte; models move the dense batches to their device themselves.
"""

import pickle
import re
import string
from collections import Counter, OrderedDict, defaultdict

import numpy as np
import scipy.sparse as sp

from ..utils import normalize
from .modality import FeatureModality, fallback_feature

SPECIAL_TOKENS = ["<PAD>", "<UNK>", "<BOS>", "<EOS>"]

# The classic Glasgow IR stop-word list (as used by scikit-learn).
ENGLISH_STOPWORDS = frozenset(
    "a about above across after afterwards again against all almost alone along "
    "already also although always am among amongst amoungst amount an and another "
    "any anyhow anyone anything anyway anywhere are around as at back be became "
    "because become becomes becoming been before beforehand behind being below "
    "beside besides between beyond bill both bottom but by call can cannot cant "
    "co con could couldnt cry de describe detail do done down due during each eg "
    "eight either eleven else elsewhere empty enough etc even ever every everyone "
    "everything everywhere except few fifteen fifty fill find fire first five for "
    "former formerly forty found four from front full further get give go had has "
    "hasnt have he hence her here hereafter hereby herein hereupon hers herself "
    "him himself his how however hundred i ie if in inc indeed interest into is "
    "it its itself keep last latter latterly least less ltd made many may me "
    "meanwhile might mill mine more moreover most mostly move much must my myself "
    "name namely neither never nevertheless next nine no nobody none noone nor "
    "not nothing now nowhere of off often on once one only onto or other others "
    "otherwise our ours ourselves out over own part per perhaps please put rather "
    "re same see seem seemed seeming seems serious several she should show side "
    "since sincere six sixty so some somehow someone something sometime sometimes "
    "somewhere still such system take ten than that the their them themselves "
    "then thence there thereafter thereby therefore therein thereupon these they "
    "thick thin third this those though three through throughout thru thus to "
    "together too top toward towards twelve twenty two un under until up upon us "
    "very via was we well were what whatever when whence whenever where "
    "whereafter whereas whereby wherein whereupon wherever whether which while "
    "whither who whoever whole whom whose why will with within without would yet "
    "you your yours yourself yourselves".split()
)


def _validate_stopwords(stop_words):
    if stop_words == "english":
        return ENGLISH_STOPWORDS
    if isinstance(stop_words, str):
        raise ValueError(f"unknown built-in stop-words list: {stop_words}")
    return None if stop_words is None else frozenset(stop_words)


def rm_tags(t):
    """Strip HTML tags."""
    return re.sub("<([^>]+)>", "", t)


def rm_numeric(t):
    """Replace digit runs with a space."""
    return re.sub("[0-9]+", " ", t)


def rm_punctuation(t):
    """Remove ASCII punctuation."""
    return t.translate(str.maketrans("", "", string.punctuation))


def rm_dup_spaces(t):
    """Collapse repeated spaces."""
    return re.sub(" {2,}", " ", t)


DEFAULT_PRE_RULES = [
    lambda t: t.lower(),
    rm_tags,
    rm_numeric,
    rm_punctuation,
    rm_dup_spaces,
]


class Tokenizer:
    """Abstract text -> token list splitter."""

    def tokenize(self, t):
        raise NotImplementedError

    def batch_tokenize(self, texts):
        raise NotImplementedError


class BaseTokenizer(Tokenizer):
    """Separator-based tokenizer with pre-processing rules and stop-words."""

    def __init__(self, sep=" ", pre_rules=None, stop_words=None):
        self.sep = sep
        self.pre_rules = pre_rules if pre_rules is not None else DEFAULT_PRE_RULES
        self.stop_words = _validate_stopwords(stop_words)

    def tokenize(self, t):
        for rule in self.pre_rules:
            t = rule(t)
        toks = t.split(self.sep)
        if self.stop_words is not None:
            toks = [tok for tok in toks if tok not in self.stop_words]
        return toks

    def batch_tokenize(self, texts):
        return [self.tokenize(t) for t in texts]


class Vocabulary:
    """Token <-> integer index mapping, optionally with special tokens
    (<PAD>:0, <UNK>:1, <BOS>:2, <EOS>:3)."""

    def __init__(self, idx2tok, use_special_tokens=False):
        self.use_special_tokens = use_special_tokens
        self.idx2tok = (
            self._add_special_tokens(idx2tok) if use_special_tokens else idx2tok
        )
        self.build_tok2idx()

    def build_tok2idx(self):
        self.tok2idx = defaultdict(
            int, {tok: idx for idx, tok in enumerate(self.idx2tok)}
        )

    @staticmethod
    def _add_special_tokens(idx2tok):
        # specials claim the lowest indices; duplicates in the input drop out
        return SPECIAL_TOKENS + [t for t in idx2tok if t not in SPECIAL_TOKENS]

    @property
    def size(self):
        return len(self.idx2tok)

    def to_idx(self, tokens):
        """Tokens -> indices (unknown tokens map to <UNK> = 1)."""
        return [self.tok2idx.get(tok, 1) for tok in tokens]

    def to_text(self, indices, sep=" "):
        """Indices -> text (joined by ``sep``) or token list if sep is None."""
        toks = [self.idx2tok[i] for i in indices]
        return sep.join(toks) if sep is not None else toks

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(self.idx2tok, f)

    @classmethod
    def load(cls, path):
        with open(path, "rb") as f:
            return cls(pickle.load(f))

    @classmethod
    def from_tokens(cls, tokens, max_vocab=None, min_freq=1, use_special_tokens=False):
        """Build from a flat token list, ranked by count."""
        freq = Counter(tokens)
        idx2tok = [tok for tok, cnt in freq.most_common(max_vocab) if cnt >= min_freq]
        return cls(idx2tok, use_special_tokens)

    @classmethod
    def from_sequences(
        cls, sequences, max_vocab=None, min_freq=1, use_special_tokens=False
    ):
        """Build from a list of token lists."""
        return cls.from_tokens(
            [tok for seq in sequences for tok in seq],
            max_vocab,
            min_freq,
            use_special_tokens,
        )


class CountVectorizer:
    """Corpus -> CSR matrix of token counts (scikit-learn-style API)."""

    def __init__(
        self, tokenizer=None, vocab=None, max_doc_freq=1.0, min_doc_freq=1,
        max_features=None, binary=False,
    ):
        if max_doc_freq < 0 or min_doc_freq < 0:
            raise ValueError("doc-frequency bounds must be non-negative")
        if max_features is not None and max_features <= 0:
            raise ValueError(f"max_features={max_features!r} must be positive or None")
        self.tokenizer = tokenizer if tokenizer is not None else BaseTokenizer()
        self.vocab, self.binary = vocab, binary
        self.max_doc_freq, self.min_doc_freq = max_doc_freq, min_doc_freq
        self.max_features = max_features

    def _limit_features(self, X, max_doc_count, min_doc_count):
        """Prune vocabulary terms by document frequency / max_features."""
        if (
            max_doc_count >= X.shape[0]
            and min_doc_count <= 1
            and self.max_features is None
        ):
            return X

        df = np.bincount(X.indices, minlength=X.shape[1])
        keep = np.full(df.size, True)
        if max_doc_count < X.shape[0]:
            keep &= df <= max_doc_count
        if min_doc_count > 1:
            keep &= df >= min_doc_count

        if self.max_features is not None and keep.sum() > self.max_features:
            # terms are already ordered by corpus frequency via Vocabulary
            head = np.flatnonzero(keep)[: self.max_features]
            keep = np.full(df.size, False)
            keep[head] = True

        if not keep.any():
            raise ValueError(
                "After pruning, no terms remain. Try a lower min_freq or a "
                "higher max_doc_freq."
            )
        self.vocab.idx2tok = [
            tok for tok, kept_tok in zip(self.vocab.idx2tok, keep) if kept_tok
        ]
        self.vocab.build_tok2idx()
        return X[:, np.flatnonzero(keep)]

    def _count(self, sequences):
        """Counts matrix over vocabulary terms (special tokens excluded)."""
        n_special = len(SPECIAL_TOKENS) if self.vocab.use_special_tokens else 0
        data, indices, indptr = [], [], [0]
        for sequence in sequences:
            counter = Counter(
                self.vocab.tok2idx[tok] - n_special
                for tok in sequence
                if tok in self.vocab.tok2idx
            )
            indices.extend(counter.keys())
            data.extend(counter.values())
            indptr.append(len(indices))

        X = sp.csr_matrix(
            (data, indices, indptr),
            shape=(len(sequences), self.vocab.size - n_special),
            dtype=np.int64,
        )
        X.sort_indices()
        return X

    def fit(self, raw_documents):
        self.fit_transform(raw_documents)
        return self

    def fit_transform(self, raw_documents):
        """Tokenize, build the vocabulary, and return (sequences, counts)."""
        sequences = self.tokenizer.batch_tokenize(raw_documents)

        fixed_vocab = self.vocab is not None
        if self.vocab is None:
            self.vocab = Vocabulary.from_sequences(sequences)

        X = self._count(sequences)
        if self.binary:
            X.data.fill(1)

        if not fixed_vocab:
            n_docs = X.shape[0]
            max_doc_count = (
                self.max_doc_freq
                if isinstance(self.max_doc_freq, int)
                else int(self.max_doc_freq * n_docs)
            )
            min_doc_count = (
                self.min_doc_freq
                if isinstance(self.min_doc_freq, int)
                else int(self.min_doc_freq * n_docs)
            )
            X = self._limit_features(X, max_doc_count, min_doc_count)

        return sequences, X

    def transform(self, raw_documents):
        """Tokenize with the fitted vocabulary; return (sequences, counts)."""
        sequences = self.tokenizer.batch_tokenize(raw_documents)
        X = self._count(sequences)
        if self.binary:
            X.data.fill(1)
        return sequences, X


class TfidfVectorizer(CountVectorizer):
    """Corpus -> TF-IDF CSR matrix (smooth idf, optional sublinear tf)."""

    def __init__(
        self, tokenizer=None, vocab=None, max_doc_freq=1.0, min_doc_freq=1,
        max_features=None, binary=False, norm="l2", use_idf=True,
        smooth_idf=True, sublinear_tf=False,
    ):
        super().__init__(
            tokenizer=tokenizer, vocab=vocab, max_doc_freq=max_doc_freq,
            min_doc_freq=min_doc_freq, max_features=max_features, binary=binary,
        )
        self.norm, self.use_idf = norm, use_idf
        self.smooth_idf, self.sublinear_tf = smooth_idf, sublinear_tf

    def _build_idf(self, X):
        n_docs, n_terms = X.shape
        doc_freq = np.bincount(X.indices, minlength=n_terms) + int(self.smooth_idf)
        idf = 1.0 + np.log((n_docs + int(self.smooth_idf)) / doc_freq)
        self.idf = sp.diags(idf, offsets=0, shape=(n_terms, n_terms), format="csr")

    def _tfidf(self, X):
        X = (
            X.tocsr().astype(np.float64)
            if sp.issparse(X)
            else sp.csr_matrix(X, dtype=np.float64)
        )
        if self.sublinear_tf:
            X.data = 1.0 + np.log(X.data)
        if self.use_idf:
            X = X * self.idf
        if self.norm:
            X = normalize(X, norm=self.norm, copy=False)
        return X

    def fit(self, raw_documents):
        self.fit_transform(raw_documents)
        return self

    def fit_transform(self, raw_documents):
        _, X = super().fit_transform(raw_documents)
        if self.use_idf:
            self._build_idf(X)
        return self._tfidf(X)

    def transform(self, raw_documents):
        _, X = super().transform(raw_documents)
        return self._tfidf(X)


class TextModality(FeatureModality):
    """Per-entity text corpus aligned with dense indices.

    Provides: ``batch_seq`` (zero-padded token-id sequences), ``batch_bow``
    (counts), ``batch_tfidf`` — the three input representations consumed by
    the text-aware models.
    """

    def __init__(
        self, corpus=None, ids=None, tokenizer=None, vocab=None,
        max_vocab=None, max_doc_freq=1.0, min_doc_freq=1, tfidf_params=None,
        **kwargs,
    ):
        super().__init__(ids=ids, **kwargs)
        self.corpus, self.vocab, self.max_vocab = corpus, vocab, max_vocab
        self.tokenizer = tokenizer if tokenizer is not None else BaseTokenizer()
        self.max_doc_freq, self.min_doc_freq = max_doc_freq, min_doc_freq
        self.tfidf_params = tfidf_params
        self.sequences, self.count_matrix = None, None
        self._tfidf_matrix = None

    @property
    def tfidf_matrix(self):
        """Lazy TF-IDF matrix over the (aligned) corpus."""
        if self._tfidf_matrix is None:
            params = {
                "tokenizer": self.tokenizer,
                "vocab": self.vocab,
                "max_doc_freq": self.max_doc_freq,
                "min_doc_freq": self.min_doc_freq,
                "max_features": self.max_vocab,
            }
            self.tfidf_params = (
                params
                if self.tfidf_params is None
                else {**self.tfidf_params, **params}
            )
            vectorizer = TfidfVectorizer(**self.tfidf_params)
            self._tfidf_matrix = vectorizer.fit_transform(self.corpus)
        return self._tfidf_matrix

    def _realign_corpus(self, id_map):
        # entities in the split without a document get an empty doc: the
        # corpus may cover only a subset (e.g. users with trust edges)
        n = max(len(self.corpus), 1 + max(id_map.values(), default=-1))
        new_corpus = self.corpus.copy() + [""] * (n - len(self.corpus))
        new_ids = self.ids.copy() + [None] * (n - len(self.ids))
        for old_idx, raw_id in enumerate(self.ids):
            new_idx = id_map.get(raw_id, None)
            if new_idx is None:
                continue
            new_corpus[new_idx] = self.corpus[old_idx]
            new_ids[new_idx] = raw_id
        self.corpus = new_corpus
        self.ids = new_ids

    def _build_text(self, id_map):
        if self.corpus is None:
            return

        if self.ids is not None and id_map is not None:
            self._realign_corpus(id_map)

        vectorizer = CountVectorizer(
            tokenizer=self.tokenizer,
            vocab=self.vocab,
            max_doc_freq=self.max_doc_freq,
            min_doc_freq=self.min_doc_freq,
            max_features=self.max_vocab,
            binary=False,
        )
        self.sequences, self.count_matrix = vectorizer.fit_transform(self.corpus)
        self.vocab = Vocabulary(vectorizer.vocab.idx2tok, use_special_tokens=True)
        self.sequences = [self.vocab.to_idx(seq) for seq in self.sequences]
        self._tfidf_matrix = None

    def build(self, id_map=None, **kwargs):
        """Align the corpus with the global index order and vectorize it."""
        super().build(id_map=id_map)
        self._build_text(id_map)
        return self

    def batch_seq(self, batch_ids, max_length=None):
        """Zero-padded (batch, max_length) matrix of token-id sequences —
        static-width output ready for device transfer."""
        if self.sequences is None:
            raise ValueError("sequences have not been built yet")

        rows = [self.sequences[mapped_id] for mapped_id in batch_ids]
        if max_length is None:
            max_length = max(len(row) for row in rows)

        seq_mat = np.zeros((len(rows), max_length), dtype="int")
        for out, row in zip(seq_mat, rows):
            out[: min(len(row), max_length)] = row[:max_length]
        return seq_mat

    @fallback_feature
    def batch_bow(self, batch_ids, binary=False, keep_sparse=False):
        """Bag-of-words rows for a batch of entity indices."""
        if self.count_matrix is None:
            raise ValueError("count_matrix has not been built yet")
        bow_mat = self.count_matrix[batch_ids]
        if binary:
            bow_mat.data.fill(1)
        return bow_mat if keep_sparse else bow_mat.toarray()

    def batch_tfidf(self, batch_ids, keep_sparse=False):
        """TF-IDF rows for a batch of entity indices."""
        tfidf_mat = self.tfidf_matrix[batch_ids]
        return tfidf_mat if keep_sparse else tfidf_mat.toarray()


class ReviewModality(TextModality):
    """(user, item, review) triplets filtered by observed train pairs,
    optionally grouped into one document per user or per item."""

    def __init__(
        self, data=None, group_by=None, tokenizer=None, vocab=None,
        max_vocab=None, max_doc_freq=1.0, min_doc_freq=1, tfidf_params=None,
        **kwargs,
    ):
        super().__init__(
            tokenizer=tokenizer, vocab=vocab, max_vocab=max_vocab,
            max_doc_freq=max_doc_freq, min_doc_freq=min_doc_freq,
            tfidf_params=tfidf_params, **kwargs,
        )
        if group_by not in ("user", "item", None):
            raise ValueError("group_by must be one of 'user', 'item', or None")
        self.raw_data, self.group_by = data, group_by

    def _observed_triples(self, uid_map, iid_map, dok_matrix):
        """(user_idx, item_idx, review) for pairs present in the train
        matrix; everything else in the raw lexicon is dropped. ``get``
        reads the same entry as ``dok_matrix[u, i]`` without its index
        checks, some 30 times faster a review."""
        for raw_uid, raw_iid, review in self.raw_data:
            u, i = uid_map.get(raw_uid), iid_map.get(raw_iid)
            if u is not None and i is not None and dok_matrix.get((u, i), 0) != 0:
                yield u, i, review

    def _build_corpus(self, uid_map, iid_map, dok_matrix):
        triples = self._observed_triples(uid_map, iid_map, dok_matrix)

        if self.group_by is None:
            # one document per (user, item) review, indexed both ways
            self.user_review, self.item_review = OrderedDict(), OrderedDict()
            self.reviews = OrderedDict()
            corpus = []
            for u, i, review in triples:
                row = len(corpus)
                self.reviews[row] = review
                self.user_review.setdefault(u, OrderedDict())[i] = row
                self.item_review.setdefault(i, OrderedDict())[u] = row
                corpus.append(review)
            return corpus, None

        # grouped: concatenate each entity's reviews into one document
        id_map = uid_map if self.group_by == "user" else iid_map
        corpus = ["" for _ in range(len(id_map))]
        for u, i, review in triples:
            row = u if self.group_by == "user" else i
            corpus[row] = " ".join([corpus[row], review.strip()])
        return corpus, id_map

    def build(self, uid_map=None, iid_map=None, dok_matrix=None, **kwargs):
        if uid_map is None or iid_map is None or dok_matrix is None:
            raise ValueError("uid_map, iid_map, and dok_matrix are required")
        self.corpus, id_map = self._build_corpus(uid_map, iid_map, dok_matrix)
        TextModality.build(self, id_map=id_map)
        return self
