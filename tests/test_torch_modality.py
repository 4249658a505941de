"""The port's modality layer and readers against the JAX package's, on the
CPU, byte for byte (host code, the same inputs):

- ``FeatureModality`` realignment and normalisation, ``fallback_feature``,
  ``ImageModality``, ``SentimentModality`` (lexicon, aspect and opinion
  maps), ``GraphModality`` (CSR matrix, train triplets, node degrees,
  batches, ``from_feature`` on tie-free features and its symmetric form);
- the NLP stack: tokenizer, vocabulary order, count and TF-IDF matrices,
  ``TextModality``'s and ``ReviewModality``'s (grouped and not)
  ``batch_seq`` / ``batch_bow`` / ``batch_tfidf``;
- every ``Reader`` line format on fixture files this test writes, with
  the basket and sequence filters, and ``read_text``;
- ``BaseMethod``'s typed slots (a wrong class raises) and the build on the
  global maps (user slots on the user map, item slots on the item map, the
  others on the train set's pairs), attached to every split, and
  ``Dataset.add_modalities`` / deep copies.
"""

import copy
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

import cornac_tpu.data as J
import cornac_tpu.data.reader as jreader
import cornac_tpu.data.text as jtext
from cornac_tpu.eval_methods import RatioSplit as JRatioSplit

import cornac_tpu_torch
import cornac_tpu_torch.data as P
import cornac_tpu_torch.data.reader as preader
import cornac_tpu_torch.data.text as ptext
from cornac_tpu_torch.eval_methods import BaseMethod, RatioSplit

import golden_models as g

cornac_tpu_torch.set_default_device("cpu")


def same(a, b):
    """Equal, byte for byte: numpy and scipy arrays of the same dtype and
    bytes, containers element by element."""
    if sp.issparse(a) or sp.issparse(b):
        a, b = sp.csr_matrix(a), sp.csr_matrix(b)
        return (a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.indices, b.indices) and a.data.tobytes() == b.data.tobytes())
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if isinstance(a, dict):
        return list(a.keys()) == list(b.keys()) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


# ------------------------------------------------------------------ features


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_feature_modality_build(sparse, normalized):
    rng = np.random.RandomState(0)
    feats = rng.rand(6, 4).astype(np.float32)
    feats = sp.csr_matrix(feats) if sparse else feats
    # the JAX package realigns dense rows only: CSR features come in index order
    ids = None if sparse else ["c", "a", "x", "b", "d", "e"]
    id_map = {"a": 0, "b": 1, "c": 2, "d": 3, "zz": 4}
    if sparse and normalized:  # min-max over a CSR matrix: both packages refuse it
        with pytest.raises(Exception) as jax_error:
            J.FeatureModality(features=feats, normalized=True).build(id_map)
        with pytest.raises(jax_error.type):
            P.FeatureModality(features=feats, normalized=True).build(id_map)
        return
    jm = J.FeatureModality(features=feats, ids=ids, normalized=normalized).build(id_map)
    pm = P.FeatureModality(features=feats, ids=ids, normalized=normalized).build(id_map)
    assert same(pm.features, jm.features) and pm.ids == jm.ids
    assert pm.feature_dim == jm.feature_dim == 4
    assert same(pm.batch_feature([0, 2, 3]), jm.batch_feature([0, 2, 3]))
    with pytest.raises(ValueError, match="2D"):
        P.FeatureModality(features=np.zeros(3))
    with pytest.raises(ValueError, match="build"):
        P.FeatureModality().batch_feature([0])


def test_image_and_sentiment_modalities():
    feats, ids = g.item_images()
    id_map = {f"i{i}": (7 * i) % 60 for i in range(60)}
    jm = J.ImageModality(features=feats, ids=ids, paths=["p"] * 60).build(id_map)
    pm = P.ImageModality(features=feats, ids=ids, paths=["p"] * 60).build(id_map)
    assert same(pm.features, jm.features) and pm.paths == jm.paths
    with pytest.raises(NotImplementedError):
        pm.batch_image([0])

    split = JRatioSplit(data=g.rating_data(), test_size=0.2, rating_threshold=3.5, seed=g.SEED)
    t = split.train_set
    kw = dict(uid_map=t.uid_map, iid_map=t.iid_map, dok_matrix=t.dok_matrix)
    js = J.SentimentModality(data=g.sentiment_data()).build(**kw)
    ps = P.SentimentModality(data=g.sentiment_data()).build(**kw)
    for attr in ("user_sentiment", "item_sentiment", "sentiment", "aspect_id_map",
                 "opinion_id_map"):
        assert same(getattr(ps, attr), getattr(js, attr)), attr
    assert ps.num_aspects == js.num_aspects and ps.num_opinions == js.num_opinions


# --------------------------------------------------------------------- graph


def _graph_inputs():
    edges = g.user_graph() + [("u1", "u1", 2.0), ("u3", "nobody", 1.0), ("u5", "u7", 0.0)]
    id_map = {f"u{u}": (3 * u) % 40 for u in range(40)}
    return edges, id_map


def test_graph_modality_build_and_views():
    edges, id_map = _graph_inputs()
    jm = J.GraphModality(data=edges).build(id_map)
    pm = P.GraphModality(data=edges).build(id_map)
    for attr in ("map_rid", "map_cid", "val"):
        assert same(getattr(pm, attr), getattr(jm, attr)), attr
    assert same(pm.matrix, jm.matrix) and pm.matrix.shape == (40, 40)
    assert same(pm.batch([0, 5, 9]), jm.batch([0, 5, 9]))
    train = range(0, 40, 2)
    assert same(pm.get_train_triplet(train, train), jm.get_train_triplet(train, train))
    for kw in ({}, {"in_ids": range(20)}, {"out_ids": range(10, 40)}):
        a, b = pm.get_node_degree(**kw), jm.get_node_degree(**kw)
        assert list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="build"):
        P.GraphModality(data=edges).matrix


@pytest.mark.parametrize("symmetric", [False, True])
def test_graph_from_feature_on_tie_free_data(symmetric):
    rng = np.random.RandomState(4)
    feats = rng.normal(size=(300, 12)).astype(np.float32)  # no ties among cosines
    ids = [f"i{i}" for i in range(300)]
    for k in (1, 5):
        jm = J.GraphModality.from_feature(feats, k=k, ids=ids, symmetric=symmetric)
        pm = P.GraphModality.from_feature(feats, k=k, ids=ids, symmetric=symmetric)
        assert pm.raw_data == jm.raw_data
        jn = J.GraphModality._build_knn(feats, k=k, block_size=64)
        pn = P.GraphModality._build_knn(feats, k=k, block_size=64)
        assert [set(r) for r in pn] == [set(r) for r in jn]
        # the k most similar rows, self excluded
        unit = feats / np.linalg.norm(feats, axis=1, keepdims=True)
        sim = unit @ unit.T
        np.fill_diagonal(sim, -np.inf)
        want = np.argsort(-sim, axis=1, kind="stable")[:, :k]
        assert [set(r) for r in pn] == [set(r) for r in want]
    built = pm.build({i: n for n, i in enumerate(ids)})
    assert built.matrix.nnz == len(pm.raw_data)
    with pytest.raises(ValueError, match="cosine"):
        P.GraphModality.from_feature(feats, similarity="dot")


# ---------------------------------------------------------------------- text


DOCS = [
    "The quick brown fox jumps over the lazy dog!",
    "A lazy dog sleeps; the fox runs away.",
    "Brown bread, brown sugar and a quick cup of tea",
    "tea or coffee? coffee, always coffee.",
    "",
    "dogs and foxes are not friends",
]


@pytest.mark.parametrize("options", [
    dict(),
    dict(max_features=5),
    dict(max_doc_freq=0.5, min_doc_freq=2),
    dict(binary=True, stop_words="english", lower_case=True),
])
def test_vectorizers_match(options):
    kw = dict(options)
    tok_kw = {}
    if "stop_words" in kw:
        tok_kw["stop_words"] = kw.pop("stop_words")
    kw.pop("lower_case", None)
    jv = jtext.CountVectorizer(tokenizer=jtext.BaseTokenizer(**tok_kw), **kw)
    pv = ptext.CountVectorizer(tokenizer=ptext.BaseTokenizer(**tok_kw), **kw)
    js, jx = jv.fit_transform(DOCS)
    ps, px = pv.fit_transform(DOCS)
    assert ps == js and pv.vocab.idx2tok == jv.vocab.idx2tok and same(px, jx)
    assert same(pv.transform(DOCS[:3])[1], jv.transform(DOCS[:3])[1])
    for params in (dict(), dict(norm="l1", sublinear_tf=True), dict(use_idf=False),
                   dict(smooth_idf=False)):
        jt = jtext.TfidfVectorizer(tokenizer=jtext.BaseTokenizer(**tok_kw), **params)
        pt = ptext.TfidfVectorizer(tokenizer=ptext.BaseTokenizer(**tok_kw), **params)
        assert same(pt.fit_transform(DOCS), jt.fit_transform(DOCS))


def test_tokenizer_and_vocabulary(tmp_path):
    jt, pt = jtext.BaseTokenizer(stop_words="english"), ptext.BaseTokenizer(stop_words="english")
    assert pt.batch_tokenize(DOCS) == jt.batch_tokenize(DOCS)
    tokens = [t for doc in pt.batch_tokenize(DOCS) for t in doc]
    for kw in (dict(), dict(max_vocab=4), dict(min_freq=2, use_special_tokens=True)):
        jv, pv = jtext.Vocabulary.from_tokens(tokens, **kw), ptext.Vocabulary.from_tokens(tokens, **kw)
        assert pv.idx2tok == jv.idx2tok and pv.tok2idx == jv.tok2idx
        assert pv.to_idx(tokens[:5]) == jv.to_idx(tokens[:5])
        assert pv.to_text([0, 1, 2]) == jv.to_text([0, 1, 2])
    pv.save(tmp_path / "vocab.pkl")
    assert ptext.Vocabulary.load(tmp_path / "vocab.pkl").idx2tok == pv.idx2tok


def test_text_modality_in_a_split():
    docs, ids = g.item_corpus()
    j = JRatioSplit(data=g.rating_data(), test_size=0.2, rating_threshold=3.5, seed=g.SEED,
                    item_text=J.TextModality(corpus=docs, ids=ids, max_vocab=40))
    p = RatioSplit(data=g.rating_data(), test_size=0.2, rating_threshold=3.5, seed=g.SEED,
                   item_text=P.TextModality(corpus=docs, ids=ids, max_vocab=40))
    jm, pm = j.train_set.item_text, p.train_set.item_text
    assert pm is p.item_text is p.test_set.item_text
    assert pm.corpus == jm.corpus and pm.ids == jm.ids
    assert pm.vocab.idx2tok == jm.vocab.idx2tok and pm.sequences == jm.sequences
    assert same(pm.count_matrix, jm.count_matrix)
    batch = [0, 3, 7, 11]
    assert same(pm.batch_seq(batch), jm.batch_seq(batch))
    assert same(pm.batch_seq(batch, max_length=4), jm.batch_seq(batch, max_length=4))
    assert same(pm.batch_bow(batch), jm.batch_bow(batch))
    assert same(pm.batch_bow(batch, binary=True, keep_sparse=True),
                jm.batch_bow(batch, binary=True, keep_sparse=True))
    assert same(pm.batch_tfidf(batch), jm.batch_tfidf(batch))


@pytest.mark.parametrize("group_by", [None, "user", "item"])
def test_review_modality(group_by):
    data = g.review_data()
    j = JRatioSplit(data=g.rating_data(), test_size=0.2, rating_threshold=3.5, seed=g.SEED,
                    review_text=J.ReviewModality(data=data, group_by=group_by, max_vocab=60))
    p = RatioSplit(data=g.rating_data(), test_size=0.2, rating_threshold=3.5, seed=g.SEED,
                   review_text=P.ReviewModality(data=data, group_by=group_by, max_vocab=60))
    jm, pm = j.review_text, p.review_text
    assert pm.corpus == jm.corpus and pm.vocab.idx2tok == jm.vocab.idx2tok
    assert same(pm.count_matrix, jm.count_matrix)
    if group_by is None:
        for attr in ("user_review", "item_review", "reviews"):
            assert same(getattr(pm, attr), getattr(jm, attr))
    batch = [0, 1, 2, 5]
    assert same(pm.batch_seq(batch), jm.batch_seq(batch))
    assert same(pm.batch_tfidf(batch), jm.batch_tfidf(batch))
    with pytest.raises(ValueError, match="group_by"):
        P.ReviewModality(data=data, group_by="both")


# ------------------------------------------------------------------- readers


LINES = {
    "UI": "u1 i1 i2 i3\nu2 i2\nu3 i1 i4\n",
    "UIR": "u1\ti1\t4.0\nu1\ti2\t2.5\nu2\ti1\t5\nu3\ti3\t1\nu3\ti1\t3\n",
    "UIRT": "u1\ti1\t4.0\t100\nu2\ti1\t5\t90\nu2\ti2\t2\t95\nu3\ti2\t1\t80\n",
    "UITup": "u1\ti1\ta,b\tc,d\nu2\ti2\te,f\n",
    "UIReview": "u1\ti1\tgreat stuff\nu2\ti1\tpoor\n",
    "UBI": "u1\tb1\ti1\nu1\tb1\ti2\nu1\tb2\ti3\nu2\tb3\ti1\nu2\tb3\ti2\nu2\tb3\ti4\n",
    "UBIT": "u1\tb1\ti1\t1\nu1\tb1\ti2\t1\nu1\tb2\ti3\t5\nu2\tb3\ti1\t3\n",
    "UBITJson": "u1\tb1\ti1\t1\t{'q': 1}\nu2\tb2\ti2\t2\t{'q': 2}\n",
    "SIT": "s1\ti1\t1\ns1\ti2\t2\ns2\ti1\t3\ns2\ti3\t4\ns2\ti4\t5\n",
    "SITJson": "s1\ti1\t1\t{'a': [1]}\ns2\ti2\t2\t{}\n",
    "USIT": "u1\ts1\ti1\t1\nu1\ts1\ti2\t2\nu2\ts2\ti3\t3\n",
    "USITJson": "u1\ts1\ti1\t1\t{'x': 0}\nu2\ts2\ti2\t2\t{'x': 1}\n",
}


@pytest.mark.parametrize("fmt", sorted(LINES))
def test_reader_formats(tmp_path, fmt):
    path = tmp_path / f"{fmt}.txt"
    path.write_text(LINES[fmt])
    sep = " " if fmt == "UI" else "\t"
    kw = dict(tup_sep=",") if fmt == "UITup" else {}
    for opts in (dict(), dict(min_user_freq=2), dict(item_set={"i1", "i2"}),
                 dict(min_basket_size=2, max_basket_size=2), dict(min_basket_sequence=2),
                 dict(min_sequence_size=2, max_sequence_size=2), dict(num_top_freq_item=2)):
        try:
            want = jreader.Reader(**opts).read(str(path), fmt=fmt, sep=sep, **kw)
        except Exception as e:  # a filter the format has no column for fails in both
            with pytest.raises(type(e)):
                preader.Reader(**opts).read(str(path), fmt=fmt, sep=sep, **kw)
            continue
        got = preader.Reader(**opts).read(str(path), fmt=fmt, sep=sep, **kw)
        assert got == want and [type(x) for t in got for x in t] == [
            type(x) for t in want for x in t]
    if fmt == "UI":
        assert (preader.Reader().read(str(path), fmt=fmt, sep=sep, id_inline=True)
                == jreader.Reader().read(str(path), fmt=fmt, sep=sep, id_inline=True))
    if fmt == "UIR":
        for opts in (dict(bin_threshold=3.0), dict(skip_lines=1)):
            reader_kw = {k: v for k, v in opts.items() if k == "bin_threshold"}
            read_kw = {k: v for k, v in opts.items() if k == "skip_lines"}
            assert (preader.Reader(**reader_kw).read(str(path), **read_kw)
                    == jreader.Reader(**reader_kw).read(str(path), **read_kw))
        with pytest.raises(ValueError, match="Invalid line format"):
            preader.Reader().read(str(path), fmt="XYZ")


def test_read_text(tmp_path):
    path = tmp_path / "docs.txt"
    path.write_text("i1\tfirst doc\ti1 tail\ni2\tsecond\n")
    assert preader.read_text(str(path)) == jreader.read_text(str(path))
    assert preader.read_text(str(path), sep="\t") == jreader.read_text(str(path), sep="\t")


# ------------------------------------------------------- slots and the build


def test_slots_take_their_classes_only():
    with pytest.raises(ValueError, match="user_graph modality must be a GraphModality"):
        BaseMethod(user_graph=P.FeatureModality())
    with pytest.raises(ValueError, match="item_text"):
        BaseMethod(item_text=P.GraphModality())
    with pytest.raises(ValueError, match="sentiment"):
        BaseMethod(sentiment=J.SentimentModality())  # the JAX package's class is not the port's
    method = BaseMethod()
    method.item_feature = P.ImageModality()  # an ImageModality is a FeatureModality
    method.user_graph = None
    for attr in BaseMethod._MODALITY_SLOTS:
        assert getattr(BaseMethod(), attr) is None


def test_build_on_the_global_maps():
    feats = np.random.RandomState(2).rand(60, 3).astype(np.float32)
    kw = dict(data=g.implicit_data(), test_size=0.2, rating_threshold=1.0, seed=g.SEED,
              exclude_unknowns=False)

    def slots(pkg):
        return dict(user_graph=pkg.GraphModality(data=g.user_graph()),
                    item_graph=pkg.GraphModality(data=g.item_graph()),
                    item_feature=pkg.FeatureModality(features=feats,
                                                     ids=[f"i{i}" for i in range(60)]),
                    sentiment=pkg.SentimentModality(data=g.sentiment_data()))

    j = JRatioSplit(**kw, **slots(J))
    p = RatioSplit(**kw, **slots(P))
    assert p.total_users == j.total_users
    for attr in ("user_graph", "item_graph"):
        jm, pm = getattr(j, attr), getattr(p, attr)
        assert same(pm.matrix, jm.matrix)
        assert pm.matrix.shape[0] == (p.total_users if attr == "user_graph" else p.total_items)
    assert same(p.item_feature.features, j.item_feature.features)
    assert same(p.sentiment.sentiment, j.sentiment.sentiment)
    for split in (p.train_set, p.test_set):
        for attr in ("user_graph", "item_graph", "item_feature", "sentiment"):
            assert getattr(split, attr) is getattr(p, attr)
        assert split.user_text is None
    # deep copies and pickles of a dataset keep its modalities, not its caches
    train = p.train_set
    _ = train.csr_matrix
    twin = copy.deepcopy(train)
    assert twin._cache == {} and same(twin.user_graph.matrix, train.user_graph.matrix)
    assert pickle.loads(pickle.dumps(train)).item_graph.raw_data == train.item_graph.raw_data
    train.add_modalities(user_graph=p.user_graph)
    assert train.user_graph is p.user_graph and train.item_graph is None


# ------------------------------------------------------------------ datasets

DATASETS = (
    "movielens netflix epinions filmtrust amazon_clothing amazon_office amazon_toy "
    "amazon_digital_music amazon_review citeulike tradesy cosmetics diginetica gowalla "
    "retailrocket tafeng yoochoose"
).split()


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_loader_surface(name):
    import importlib

    ours = importlib.import_module(f"cornac_tpu_torch.datasets.{name}")
    theirs = importlib.import_module(f"cornac_tpu.datasets.{name}")
    loads = sorted(f for f in dir(theirs) if f.startswith("load"))
    assert loads and sorted(f for f in dir(ours) if f.startswith("load")) == loads


def test_loaders_read_the_cache_and_fetch_nothing(tmp_path, monkeypatch):
    import zipfile

    import urllib.request

    from cornac_tpu.datasets import epinions as j_epinions
    from cornac_tpu_torch.datasets import epinions, movielens
    from cornac_tpu_torch.utils import download

    def no_fetch(*args, **kwargs):
        raise AssertionError("a loader tried to download")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_fetch)
    monkeypatch.setenv("CORNAC_TPU_CACHE", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        epinions.load_feedback()
    with pytest.raises(FileNotFoundError):
        movielens.load_feedback(variant="100K")
    with pytest.raises(ValueError):
        movielens.load_feedback(variant="999Z")
    assert sorted(p.name for p in tmp_path.iterdir()) == []  # nothing written

    # a file in the cache, and one inside an archive in the cache
    (tmp_path / "epinions").mkdir()
    (tmp_path / "epinions" / "ratings_data.txt").write_text("1 10 4\n1 11 5\n2 10 3\n")
    with zipfile.ZipFile(tmp_path / "trust_data.zip", "w") as zf:
        zf.writestr("epinions/trust_data.txt", "1 2 1\n2 1 1\n")
    assert epinions.load_feedback() == j_epinions.load_feedback()
    assert epinions.load_trust() == [("1", "2", 1.0), ("2", "1", 1.0)]
    assert epinions.load_trust(preader.Reader(user_set={"2"})) == [("2", "1", 1.0)]

    evil = tmp_path / "evil.zip"
    with zipfile.ZipFile(evil, "w") as zf:
        zf.writestr("../outside.txt", "x")
    with pytest.raises(RuntimeError, match="traversal"):
        download._extract_archive(str(evil), str(tmp_path / "out"))
