"""Seeded data of the next-item, next-basket, CVAECF and GCMC bench cells,
shared by ``tools/bpr_quality_band.py`` (the JAX package's bands) and
``chip_smoke.py`` (phases 12f, 12g and 17, the port's fits). Imports neither
package.

- ``gen_sessions``: a copy of ``benchmarks/head_to_head_seq.py::gen_sessions``
  (block-structured Markov sessions, 2,000 sessions over 500 items), and
  ``session_split`` its split (the first 85% of the sessions train).
- ``gen_baskets``: a copy of ``benchmarks/head_to_head_basket.py::gen_baskets``
  (each user buys 3-6 baskets of 2-4 distinct items from one of 4 blocks of
  the catalog), as UBI tuples; ``tafeng_like`` draws baskets by the same
  law at the Ta Feng grocery dataset's published counts, as UBIT tuples.
- ``session_features``: seeded content features of ``gen_sessions``' items
  for TIGER (a vector a block of the catalog, plus noise an item), and
  ``tfidf_like``: seeded TF-IDF-like rows (nonnegative, sparse,
  L2-normalised) standing in for the plot features of
  ``examples/tiger_example.py``, whose files are not in the repository.
- ``text_corpus``: a copy of ``benchmarks/head_to_head_tf.py::text_corpus``
  (a Zipf-like letter-only document of 50 words an item over a vocabulary
  of 400), and ``text_modalities`` the bench shape's item texts and
  per-rating reviews for the text and review models.
- ``seeded_trust``: a user graph for ``make_ml100k_like(7)``'s users (the
  FilmTrust trust network that ``examples/cvaecf_filmtrust.py`` reads is not
  in the repository): each user trusts a few users, drawn with a bias toward
  users of similar taste so that the graph carries some signal.
"""

import itertools

import numpy as np


def gen_sessions(n_sessions=2000, n_items=500, n_users=300, seed=7):
    """Markov-chain sessions with block structure (signal for next-item),
    as USIT tuples (user, session, item, time)."""
    rng = np.random.RandomState(seed)
    rows, t = [], 0
    n_blocks = 10
    per = n_items // n_blocks
    for s in range(n_sessions):
        u = rng.randint(n_users)
        block = rng.randint(n_blocks) * per
        x = rng.randint(per)
        for _ in range(rng.randint(4, 12)):
            rows.append((f"u{u}", str(s), f"i{block + x}", t))
            t += 1
            x = (x + 1) % per if rng.rand() < 0.8 else rng.randint(per)
    return rows


def session_features(n_items=500, n_blocks=10, dim=32, noise=0.5, seed=11):
    """(features (n_items, dim) float32, ids): ``gen_sessions``' items
    ``i0``.. each get their block's seeded vector plus seeded noise, so
    that items of a block lie near each other, as content would."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(n_blocks, dim)
    block = np.arange(n_items) // (n_items // n_blocks)
    feats = centres[block] + noise * rng.randn(n_items, dim)
    return feats.astype(np.float32), [f"i{k}" for k in range(n_items)]


def tfidf_like(n_items, dim=512, terms=(5, 40), seed=17):
    """(n_items, dim) float32 rows like ``TfidfVectorizer(max_features=dim)``
    over short texts: each row has 5-40 distinct terms drawn Zipf-like over
    the vocabulary, weighted by a count times an idf, then L2-normalised."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, dim + 1) ** 0.9
    p /= p.sum()
    idf = 1.0 + np.log((1.0 + n_items) / (1.0 + n_items * np.minimum(1.0, 8 * p)))
    out = np.zeros((n_items, dim), np.float32)
    for row in range(n_items):
        n = rng.randint(terms[0], terms[1] + 1)
        cols = rng.choice(dim, size=n, replace=False, p=p)
        out[row, cols] = (1 + rng.poisson(1.0, size=n)) * idf[cols]
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def gen_baskets(n_users=300, n_items=120, seed=7):
    """Markov-flavoured baskets: each user draws a preferred block of the
    catalog and samples baskets from it (so next-basket prediction has
    signal), as UBI tuples (user, basket, item)."""
    rng = np.random.RandomState(seed)
    rows = []
    bid = 0
    for u in range(n_users):
        block = rng.randint(0, 4)
        lo, hi = block * (n_items // 4), (block + 1) * (n_items // 4)
        for _ in range(rng.randint(3, 7)):
            bid += 1
            size = rng.randint(2, 5)
            items = rng.choice(np.arange(lo, hi), size=size, replace=False)
            rows.extend((f"u{u}", f"b{bid}", f"i{it}") for it in items)
    return rows


# the Ta Feng grocery dataset (November 2000 - February 2001) as Cornac's
# examples read it: customers, products, purchase lines
TAFENG_USERS, TAFENG_ITEMS, TAFENG_LINES = 32_266, 23_812, 817_741


def tafeng_like(seed, n_users=TAFENG_USERS, n_items=TAFENG_ITEMS, n_lines=TAFENG_LINES):
    """UBIT tuples (user, basket, item, time) at the Ta Feng counts by
    ``gen_baskets``' law: each user draws one of 4 blocks of the catalog and
    buys 3-6 baskets of distinct items from it. ``gen_baskets`` draws a
    basket's size from [2, 5); here the upper end is widened by w, just as
    far as the purchase lines' expectation reaches ``n_lines`` (w = 2 x
    (lines per basket - 3), its fraction drawn per basket), and the lines
    must land within 2% of it. Items no basket drew replace a line each
    (every item is bought at least once). A basket's time is its index."""
    rng = np.random.RandomState(seed)
    per = n_items // 4
    n_baskets = rng.randint(3, 7, size=n_users)
    block = rng.randint(0, 4, size=n_users)
    nb = int(n_baskets.sum())
    widen = 2 * (n_lines / (4.5 * n_users) - 3)
    high = 5 + int(widen) + (rng.rand(nb) < widen - int(widen))
    sizes = rng.randint(2, high)
    if abs(int(sizes.sum()) - n_lines) > 0.02 * n_lines:
        raise AssertionError(f"{int(sizes.sum())} purchase lines, not within 2% of {n_lines}")
    # distinct items within a basket: redraw the baskets that repeat one
    width = int(sizes.max())
    valid = np.arange(width)[None, :] < sizes[:, None]
    draw = rng.randint(per, size=(nb, width))
    while True:
        srt = np.sort(np.where(valid, draw, -1 - np.arange(width)[None, :]), axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        draw[dup] = rng.randint(per, size=(int(dup.sum()), width))
    owner = np.repeat(np.arange(n_users), n_baskets)
    items = (draw + (block[owner] * per)[:, None])[valid]
    basket = np.repeat(np.arange(nb), sizes)
    missing = np.setdiff1d(np.arange(n_items), items)
    items[rng.choice(items.size, missing.size, replace=False)] = missing
    user = owner[basket]
    return [(f"u{u}", f"b{b}", f"i{i}", b)
            for u, b, i in zip(user.tolist(), basket.tolist(), items.tolist())]


def session_split(rows):
    """(train, test) tuples: sessions up to the 85th percentile id train."""
    sids = sorted({int(t[1]) for t in rows})
    cut = sids[int(len(sids) * 0.85)]
    return ([t for t in rows if int(t[1]) <= cut], [t for t in rows if int(t[1]) > cut])


def seeded_trust(triples, per_user=8, seed=11):
    """(truster, trustee, 1.0) edges over the users of ``triples`` (user,
    item, rating): each user trusts ``per_user`` others, drawn with
    probability rising with the number of items the two both rated."""
    rng = np.random.RandomState(seed)
    users = sorted({u for u, _, _ in triples})
    items = sorted({i for _, i, _ in triples})
    u_of = {u: k for k, u in enumerate(users)}
    i_of = {i: k for k, i in enumerate(items)}
    R = np.zeros((len(users), len(items)), np.float32)
    for u, i, _ in triples:
        R[u_of[u], i_of[i]] = 1.0
    overlap = R @ R.T
    np.fill_diagonal(overlap, 0.0)
    edges = []
    for a in range(len(users)):
        w = overlap[a] + 1.0
        w[a] = 0.0
        for b in rng.choice(len(users), size=per_user, replace=False, p=w / w.sum()):
            edges.append((users[a], users[b], 1.0))
    return edges


def image_like(n_items, dim=64, rank=8, seed=19):
    """(n_items, dim) float32 non-negative rows like CNN activations: the
    ReLU of a seeded rank-``rank`` product plus seeded noise, so items share
    visual directions."""
    rng = np.random.RandomState(seed)
    low = rng.randn(n_items, rank) @ rng.randn(rank, dim) / np.sqrt(rank)
    return np.maximum(low + 0.3 * rng.randn(n_items, dim), 0.0).astype(np.float32)


def side_modalities(triples, data):
    """The bench shape's side information for the models of
    ``bpr_quality_band.SIDE_CONFIGS``, built with a package's ``data``
    module: ``seeded_trust`` as the user graph; over the items (sorted raw
    ids), ``image_like`` features as the image modality, the k = 10
    cosine graph of those features (``GraphModality.from_feature``,
    symmetric, its edges sorted) as the item graph, and ``tfidf_like`` rows
    (512 wide) as the text modality's features."""
    items = sorted({i for _, i, _ in triples})
    feats = image_like(len(items))
    # from_feature's edges come out of a set, in an order that the string
    # hash's per-process seed picks: sorted, MCF's item-graph stream visits
    # the same edges in every process
    graph = data.GraphModality.from_feature(feats, k=10, ids=items, symmetric=True,
                                            verbose=False)
    return dict(
        user_graph=data.GraphModality(data=seeded_trust(triples)),
        item_graph=data.GraphModality(data=sorted(graph.raw_data)),
        item_image=data.ImageModality(features=feats, ids=items),
        item_text=data.TextModality(features=tfidf_like(len(items)), ids=items))


def text_corpus(n_items, seed=31):
    """(documents, ids): a Zipf-like letter-only document of 50 words for
    each item ``i0``.. (the tokenizers strip digits)."""
    rng = np.random.RandomState(seed)
    syll = ["ba", "ce", "di", "fo", "gu", "ka", "le", "mi", "no", "pu"]
    vocab = np.array(["".join(w) for w in itertools.product(syll, syll, syll)][:400])
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    return ([" ".join(rng.choice(vocab, size=50, p=p)) for _ in range(n_items)],
            [f"i{i}" for i in range(n_items)])


def text_modalities(triples, data, n_items=1682):
    """The bench shape's text for the models of
    ``bpr_quality_band.TEXT_CONFIGS``, built with a package's ``data``
    module: ``text_corpus`` as the item texts (``TextModality``, 200 words
    at most) and, as in ``benchmarks/head_to_head_tf.py``, each rating's
    review the document of another seeded corpus that its item's number
    picks (``ReviewModality``, 200 words at most)."""
    docs, ids = text_corpus(n_items)
    reviews, _ = text_corpus(n_items, seed=101)
    return dict(
        item_text=data.TextModality(corpus=docs, ids=ids, max_vocab=200),
        review_text=data.ReviewModality(
            data=[(u, i, reviews[int(i[1:]) % len(reviews)]) for u, i, _ in triples],
            max_vocab=200))
