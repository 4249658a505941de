"""Seeded data of the next-item, CVAECF and GCMC bench cells, shared by
``tools/bpr_quality_band.py`` (the JAX package's bands) and
``chip_smoke.py`` (phase 12f, the port's fits). Imports neither package.

- ``gen_sessions``: a copy of ``benchmarks/head_to_head_seq.py::gen_sessions``
  (block-structured Markov sessions, 2,000 sessions over 500 items), and
  ``session_split`` its split (the first 85% of the sessions train).
- ``seeded_trust``: a user graph for ``make_ml100k_like(7)``'s users (the
  FilmTrust trust network that ``examples/cvaecf_filmtrust.py`` reads is not
  in the repository): each user trusts a few users, drawn with a bias toward
  users of similar taste so that the graph carries some signal.
"""

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
