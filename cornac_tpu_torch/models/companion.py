"""Companion — Comparative Aspects and Opinions Ranking for Recommendation
Explanations (Le & Lauw, 2024).

Port of ``cornac_tpu/models/companion.py``: Tucker tensors G1
(user-item-aspect) and stacked opinion tensors G2 / G3 of shape
(n_user_factors + n_item_factors, aspect, opinion), the positive and
negative opinion channels, each predicted as the sum of a user half and an
item half; trained with sampled element reconstruction, an overall-rating
BPR, aspect ranking (against a random aspect and against a random item) and
positive and negative opinion ranking, with MTER's AdaGrad-style step and
projection.

As in ``mter.py``, ``companion_draws`` makes a chunk of iterations' index
streams on the device (in the JAX package's order within an iteration) and
``companion_iteration`` runs one iteration on one iteration's draws, in
place. The nested lookups are the JAX package's chained compact CSR
lookups (``CsrLookup``): (user, item) -> the pair's position, (pair
position, aspect) -> score (``_PairAspectLookup``), (element row, opinion)
-> score. The core gradients (``einsum("s,sp,sq,sr->pqr")``) are plain
``torch.einsum``, as they are XLA in the JAX package; every table's row
gradient is one ``accumulate_rows`` call over its updates in the JAX
package's order.

``mesh`` (``parallel.make_mesh``): MTER's design (``mter.py``). The tables
and AdaGrad's sums are replicated, every rank draws the whole streams, the
four sample counts are rounded down to a multiple of the mesh's size (at
least its size) as in the JAX package, a rank computes the weights and
update rows of its samples (``data_parallel`` over every rank), and every rank sums
the core gradients over the whole stream from the gathered weights: every
layout gives the single-device fit's bits.
"""

import itertools

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.csr_lookup import CsrLookup
from ..parallel.sharded import data_parallel, round_batch
from ..utils.init_utils import uniform
from .mter import (
    MTER,
    NAMES,
    _core_grad,
    _pair_ratings,
    _row_grads,
    _tucker3,
    adagrad_project,
    run_iterations,
)
from .recommender import Recommender


class _PairAspectLookup:
    """Two-level lookup: (u, i) -> pair position, then (pair position,
    aspect) -> (found, score, entry position)."""

    def __init__(self, pair_lookup, aspect_lookup):
        self.pair = pair_lookup
        self.aspect = aspect_lookup

    def query_pair(self, u, i):
        found, _, pos = self.pair.query_position(u, i)
        return found, pos  # 0 where absent

    def query_aspect(self, pos, a):
        return self.aspect.query_position(pos, a)


class CompanionData:
    """Companion's device streams: the element arrays of X (user, item,
    aspect) and of the positive and negative opinion quadruples, the rating
    pairs and the four lookups."""

    def __init__(self, X, YP, YN, rat_users, rat_items, rating_lookup, uia_lookup,
                 pos_op_lookup, neg_op_lookup):
        self.X, self.YP, self.YN = X, YP, YN
        self.rat_users, self.rat_items = rat_users, rat_items
        self.rating_lookup, self.uia_lookup = rating_lookup, uia_lookup
        self.pos_op_lookup, self.neg_op_lookup = pos_op_lookup, neg_op_lookup


# the draws of one iteration, in the JAX package's order: (name, stream it
# indexes or "items" / "aspects" / "opinions", the sample count's option)
DRAW_ORDER = (("s1", "X", "n_el"), ("s2", "YP", "n_el"), ("s3", "YN", "n_el"),
              ("pos", "ratings", "n_bpr"), ("j", "items", "n_bpr"),
              ("sp", "X", "n_asp_rank"), ("a_j", "aspects", "n_asp_rank"),
              ("si", "X", "n_asp_rank"), ("i_j", "items", "n_asp_rank"),
              ("so_P", "YP", "n_op_rank"), ("oj_P", "opinions", "n_op_rank"),
              ("so_N", "YN", "n_op_rank"), ("oj_N", "opinions", "n_op_rank"))


def companion_draws(generator, n_iters, data, counts, sizes, device):
    """The index streams of ``n_iters`` iterations: a dict of (n_iters, n)
    int64 tensors in ``DRAW_ORDER``. ``counts``: (n_items, n_aspects,
    n_opinions); ``sizes``: {"n_el", "n_bpr", "n_asp_rank", "n_op_rank"}."""
    n_items, n_aspects, n_opinions = counts
    highs = {"X": data.X[0].shape[0], "YP": data.YP[0].shape[0], "YN": data.YN[0].shape[0],
             "ratings": data.rat_users.shape[0], "items": n_items, "aspects": n_aspects,
             "opinions": n_opinions}
    return {name: torch.randint(0, highs[what], (n_iters, sizes[size]), generator=generator,
                                device=device)
            for name, what, size in DRAW_ORDER}


def _stacked_rows(G, w, UI, Aa, Oo, nu):
    """A stacked opinion tensor stream's row gradients (U, I, A, O), each
    contraction over both halves at once (``UI``: the user and item rows
    side by side); ``Oo`` is the opinions' rows, or their difference from
    the negatives' for a ranking stream."""
    g_ui, g_a, g_o = _row_grads(G, UI, Aa, Oo, w)
    return g_ui[:, :nu].contiguous(), g_ui[:, nu:].contiguous(), g_a, g_o


def companion_iteration(params, sgrads, data, draws, nu, lr, ld_reg, ld_bpr, ld_p, ld_a, ld_y,
                        ld_z, mesh=None):
    """One iteration of the JAX package's ``_companion_fit`` on one
    iteration's ``draws``, in place on ``params`` and ``sgrads``. ``mesh``:
    each stream's samples split over every rank (module docstring). Each
    stream's table rows are gathered once, whole: the core gradients read
    them all, and a rank's split reads its slice."""
    G1, U, I, A, O = params["G1"], params["U"], params["I"], params["A"], params["O"]
    n_aspects = A.shape[0] - 1
    ids = {"U": [], "I": [], "A": [], "O": []}
    upd = {"U": [], "I": [], "A": [], "O": []}
    core = {"G1": [], "G2": [], "G3": []}

    def add(name, idx, g):
        ids[name].append(idx)
        upd[name].append(g)

    X, X_u, X_i, X_a = data.X

    # element reconstruction streams
    def element_rows(x, Uu, Ii, Aa):
        w = 2.0 * (_tucker3(G1, Uu, Ii, Aa) - x)
        return (w,) + _row_grads(G1, Uu, Ii, Aa, w)

    s1 = draws["s1"]
    u, i, a = X_u[s1], X_i[s1], X_a[s1]
    Uu, Ii, Aa = U[u], I[i], A[a]
    w, g_u, g_i, g_a = data_parallel(mesh, element_rows, u.shape[0], X[s1], Uu, Ii, Aa,
                                     axis=None)
    core["G1"].append(_core_grad(w, Uu, Ii, Aa))
    add("U", u, g_u), add("I", i, g_i), add("A", a, g_a)

    def stacked(gname, stream, s, rows, *extra, o_j=None):
        """A stacked opinion stream: ``rows(*extra, UI, Aa, Oo[, Oj, Oo -
        Oj])`` gives its weights and row gradients (the rank's slice on a
        mesh); its core gradient and update rows added."""
        _, Yu, Yi, Ya, Yo = stream
        u, i, a, o = Yu[s], Yi[s], Ya[s], Yo[s]
        UI, Aa, Oo = torch.cat([U[u], I[i]], 1), A[a], O[o]
        factors = (UI, Aa, Oo) if o_j is None else (UI, Aa, Oo, O[o_j])
        if o_j is not None:
            factors += (Oo - factors[3],)
        w, g_u, g_i, g_a, g_o = data_parallel(mesh, rows, u.shape[0], *extra, *factors,
                                              axis=None)
        core[gname].append(_core_grad(w, UI, Aa, factors[-1]))
        add("U", u, g_u), add("I", i, g_i), add("A", a, g_a), add("O", o, g_o)
        if o_j is not None:
            add("O", o_j, -g_o)

    for gname, stream, key in (("G2", data.YP, "s2"), ("G3", data.YN, "s3")):
        G = params[gname]

        def opinion_rows(y, UI, Aa, Oo, G=G):
            w = 2.0 * (_tucker3(G, UI, Aa, Oo) - y)
            return (w,) + _stacked_rows(G, w, UI, Aa, Oo, nu)

        s = draws[key]
        stacked(gname, stream, s, opinion_rows, stream[0][s])

    # overall-rating BPR
    def bpr_rows(u, i, j, Uu, Ii, Ij, i_ij):
        found, j_rating, i_rating = _pair_ratings(data.rating_lookup, u, i, j)
        s = torch.where(found & (i_rating < j_rating), -1.0, 1.0)
        valid = ~(found & (i_rating == j_rating))
        Aov = A[n_aspects].expand(u.shape[0], A.shape[1])
        pred = (_tucker3(G1, Uu, Ii, Aov) - _tucker3(G1, Uu, Ij, Aov)) * s
        del_bpr = ld_bpr * (1.0 / (1.0 + torch.exp(pred))) * s * valid
        return (del_bpr, -torch.einsum("s,sq,sr,pqr->sp", del_bpr, i_ij, Aov, G1),
                torch.einsum("s,sp,sr,pqr->sq", del_bpr, Uu, Aov, G1))

    pos, j = draws["pos"], draws["j"]
    u, i = data.rat_users[pos], data.rat_items[pos]
    Uu, Ii, Ij = U[u], I[i], I[j]
    i_ij = Ii - Ij
    del_bpr, g_u, g_i = data_parallel(mesh, bpr_rows, u.shape[0], u, i, j, Uu, Ii, Ij, i_ij,
                                       axis=None)
    Aov = A[n_aspects].expand(u.shape[0], A.shape[1])
    core["G1"].append(-torch.einsum("s,sp,sq,sr->pqr", del_bpr, Uu, i_ij, Aov))
    add("U", u, g_u)
    add("I", i, -g_i), add("I", j, g_i)
    add("A", torch.full((1,), n_aspects, dtype=torch.int64, device=A.device),
        -torch.einsum("s,sp,sq,pqr->r", del_bpr, Uu, i_ij, G1)[None, :])

    # the two aspect-ranking streams (against a random aspect, ld_p, and
    # against a random item, ld_a), their lookups one call over both
    def aspect_rows(u, i, a_j, u2, i_j, a2, x, x2, Uu, Ii, Aa, Aj, a_diff, Uu2, Ii2, Ij2, Aa2,
                    i_diff):
        n = u.shape[0]
        _, pos = data.uia_lookup.query_pair(torch.cat([u, u2]), torch.cat([i, i_j]))
        found_a, score_a, _ = data.uia_lookup.query_aspect(pos, torch.cat([a_j, a2]))

        found_j, j_score = found_a[:n], score_a[:n]
        s = torch.where(found_j & (x < j_score), -1.0, 1.0)
        valid = ~(found_j & (x == j_score))
        pred = (_tucker3(G1, Uu, Ii, Aa) - _tucker3(G1, Uu, Ii, Aj)) * s
        w = -ld_p * (1.0 / (1.0 + torch.exp(pred))) * s * valid

        found_ja, j_score = found_a[n:], score_a[n:]
        s = torch.where(found_ja & (x2 < j_score), -1.0, 1.0)
        valid = ~(found_ja & (x2 == j_score))
        pred = (_tucker3(G1, Uu2, Ii2, Aa2) - _tucker3(G1, Uu2, Ij2, Aa2)) * s
        w2 = -ld_a * (1.0 / (1.0 + torch.exp(pred))) * s * valid
        return ((w,) + _row_grads(G1, Uu, Ii, a_diff, w)
                + (w2,) + _row_grads(G1, Uu2, i_diff, Aa2, w2))

    sp_, a_j, si, i_j = draws["sp"], draws["a_j"], draws["si"], draws["i_j"]
    u, i, a = X_u[sp_], X_i[sp_], X_a[sp_]
    u2, i2, a2 = X_u[si], X_i[si], X_a[si]
    Uu, Ii, Aa, Aj = U[u], I[i], A[a], A[a_j]
    Uu2, Aa2, Ii2, Ij2 = U[u2], A[a2], I[i2], I[i_j]
    a_diff, i_diff = Aa - Aj, Ii2 - Ij2
    w, g_u, g_i, g_a, w2, g_u2, g_i2, g_a2 = data_parallel(
        mesh, aspect_rows, u.shape[0], u, i, a_j, u2, i_j, a2, X[sp_], X[si], Uu, Ii, Aa, Aj,
        a_diff, Uu2, Ii2, Ij2, Aa2, i_diff, axis=None)
    core["G1"].append(_core_grad(w, Uu, Ii, a_diff))
    add("U", u, g_u), add("I", i, g_i)
    add("A", a, g_a), add("A", a_j, -g_a)
    core["G1"].append(_core_grad(w2, Uu2, i_diff, Aa2))
    add("U", u2, g_u2)
    add("I", i2, g_i2), add("I", i_j, -g_i2)
    add("A", a2, g_a2)

    # opinion ranking streams (ld_y positive, ld_z negative)
    for gname, stream, lookup, ld, so_key, oj_key in (
            ("G2", data.YP, data.pos_op_lookup, ld_y, "so_P", "oj_P"),
            ("G3", data.YN, data.neg_op_lookup, ld_z, "so_N", "oj_N")):
        G = params[gname]

        def ranking_rows(so, o_j, y, UI, Aa, Oo, Oj, o_diff, G=G, lookup=lookup, ld=ld):
            found_o, j_score = lookup.query(so, o_j)
            s = torch.where(found_o & (y < j_score), -1.0, 1.0)
            valid = ~(found_o & (y == j_score))
            pred = (_tucker3(G, UI, Aa, Oo) - _tucker3(G, UI, Aa, Oj)) * s
            w = -ld * (1.0 / (1.0 + torch.exp(pred))) * s * valid
            return (w,) + _stacked_rows(G, w, UI, Aa, o_diff, nu)

        so, o_j = draws[so_key], draws[oj_key]
        stacked(gname, stream, so, ranking_rows, so, o_j, stream[0][so], o_j=o_j)

    grads = {}
    for name, parts in core.items():
        g = parts[0]
        for part in parts[1:]:
            g = g + part
        grads[name] = g
    for name in ("U", "I", "A", "O"):
        table = params[name]
        grads[name] = accumulate_rows(table.new_zeros(table.shape), torch.cat(ids[name]),
                                      torch.cat(upd[name]))
    adagrad_project(params, sgrads, {n: grads[n] for n in NAMES}, lr, ld_reg)
    return params, sgrads


class Companion(MTER):
    """Comparative aspect/opinion ranking Tucker model. Parameters mirror
    the JAX package's; ``device``: where the model fits and scores (default:
    the card); ``mesh``: a ``parallel.make_mesh`` mesh, every rank calling
    ``fit`` (module docstring)."""

    def __init__(
        self,
        name="Companion",
        rating_scale=5.0,
        n_user_factors=8,
        n_item_factors=8,
        n_aspect_factors=8,
        n_opinion_factors=8,
        n_element_samples=50,
        n_bpr_samples=1000,
        n_aspect_ranking_samples=1000,
        n_opinion_ranking_samples=1000,
        n_top_aspects=100,
        alpha=0.5,
        min_user_freq=2,
        min_pair_freq=1,
        min_common_freq=1,
        use_item_aspect_popularity=True,
        enum_window=None,
        lambda_reg=0.1,
        lambda_bpr=10,
        lambda_p=10,
        lambda_a=10,
        lambda_y=10,
        lambda_z=10,
        max_iter=200000,
        lr=0.5,
        n_threads=0,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        MTER.__init__(
            self,
            name=name,
            rating_scale=rating_scale,
            n_user_factors=n_user_factors,
            n_item_factors=n_item_factors,
            n_aspect_factors=n_aspect_factors,
            n_opinion_factors=n_opinion_factors,
            n_bpr_samples=n_bpr_samples,
            n_element_samples=n_element_samples,
            lambda_reg=lambda_reg,
            lambda_bpr=lambda_bpr,
            max_iter=max_iter,
            lr=lr,
            mesh=mesh,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            device=device,
        )
        self.n_aspect_ranking_samples = n_aspect_ranking_samples
        self.n_opinion_ranking_samples = n_opinion_ranking_samples
        self.n_top_aspects = n_top_aspects
        self.alpha = alpha
        # accepted and never read, as in the JAX package and its reference
        self.min_user_freq = min_user_freq
        self.min_pair_freq = min_pair_freq
        self.min_common_freq = min_common_freq
        self.use_item_aspect_popularity = use_item_aspect_popularity
        self.enum_window = enum_window
        self.lambda_p = lambda_p
        self.lambda_a = lambda_a
        self.lambda_y = lambda_y
        self.lambda_z = lambda_z
        self.n_threads = n_threads

    def _init(self, train_set):
        """Stacked G2/G3 shapes differ from MTER."""
        sentiment = train_set.sentiment
        self.num_aspects = sentiment.num_aspects
        self.num_opinions = sentiment.num_opinions
        rng = self.rng
        nu, ni = self.n_user_factors, self.n_item_factors
        if self.G1 is None:
            self.G1 = uniform(
                (nu, ni, self.n_aspect_factors), random_state=rng
            )
        if self.G2 is None:
            self.G2 = uniform(
                (nu + ni, self.n_aspect_factors, self.n_opinion_factors),
                random_state=rng,
            )
        if self.G3 is None:
            self.G3 = uniform(
                (nu + ni, self.n_aspect_factors, self.n_opinion_factors),
                random_state=rng,
            )
        if self.U is None:
            self.U = uniform((self.num_users, nu), random_state=rng)
        if self.I is None:
            self.I = uniform((self.num_items, ni), random_state=rng)
        if self.A is None:
            self.A = uniform(
                (self.num_aspects + 1, self.n_aspect_factors), random_state=rng
            )
        if self.O is None:
            self.O = uniform(
                (self.num_opinions, self.n_opinion_factors), random_state=rng
            )

    def _build_data(self, data_set):
        """uia scores and per-(u, i, a, o) positive / negative opinion
        counts."""
        sentiment = data_set.sentiment
        u_arr, i_arr, r_vals = data_set.uir_tuple
        rating_matrix = sp.csr_matrix(
            (r_vals, (u_arr, i_arr)), shape=(self.num_users, self.num_items)
        )

        uia = {}
        pos_op = {}
        neg_op = {}
        for u_idx, by_item in sentiment.user_sentiment.items():
            if u_idx >= self.num_users:
                continue
            for i_idx, tup_idx in by_item.items():
                uia[(u_idx, i_idx, sentiment.num_aspects)] = rating_matrix[
                    u_idx, i_idx
                ]
                for a_idx, o_idx, polarity in sentiment.sentiment[tup_idx]:
                    uia[(u_idx, i_idx, a_idx)] = (
                        uia.get((u_idx, i_idx, a_idx), 0) + polarity
                    )
                    pos_op.setdefault((u_idx, i_idx, a_idx, o_idx), 0)
                    neg_op.setdefault((u_idx, i_idx, a_idx, o_idx), 0)
                    if polarity > 0:
                        pos_op[(u_idx, i_idx, a_idx, o_idx)] += polarity
                    elif polarity < 0:
                        neg_op[(u_idx, i_idx, a_idx, o_idx)] += abs(polarity)

        for key in uia:
            if key[2] != sentiment.num_aspects:
                uia[key] = self._compute_quality_score(uia[key])
        for key in pos_op:
            pos_op[key] = self._compute_attention_score(pos_op[key])
        for key in neg_op:
            neg_op[key] = self._compute_attention_score(neg_op[key])
        return rating_matrix, uia, pos_op, neg_op

    def _host_streams(self, rating_matrix, uia, pos_op, neg_op):
        """The JAX fit's element arrays and the CSR matrices of its lookups:
        (X, YP, YN) tuples of arrays and (rating, uia, positive-opinion,
        negative-opinion) scipy CSR matrices, the same bytes as the JAX
        fit's list-by-list build, made with numpy over the dicts' entries."""
        def entries(d, width):
            keys = np.fromiter(itertools.chain.from_iterable(d.keys()), dtype=np.int64,
                               count=width * len(d)).reshape(-1, width)
            return keys, np.fromiter(d.values(), dtype=np.float64, count=len(d))

        def arrays(keys, vals):
            return (vals.astype(np.float32),) + tuple(
                keys[:, c].astype(np.int32) for c in range(keys.shape[1]))

        uia_keys, uia_vals = entries(uia, 3)
        pos_keys, pos_vals = entries(pos_op, 4)
        neg_keys, neg_vals = entries(neg_op, 4)

        # the (u, i) pair's nnz position in the rating CSR (its keys ascend)
        n_pairs = rating_matrix.nnz
        csr = rating_matrix if rating_matrix.has_sorted_indices else rating_matrix.sorted_indices()
        rows = np.repeat(np.arange(csr.shape[0], dtype=np.int64), np.diff(csr.indptr))
        pair_keys = rows * self.num_items + csr.indices
        aspect = uia_keys[:, 2] != self.num_aspects
        pos = np.searchsorted(pair_keys, uia_keys[aspect, 0] * self.num_items
                              + uia_keys[aspect, 1])
        uia_csr = sp.csr_matrix((uia_vals[aspect], (pos, uia_keys[aspect, 2])),
                                shape=(n_pairs, self.num_aspects))

        # opinion lookups keyed by the element row of YP / YN: the row of
        # the (u, i, a, o) element drawn, the columns the opinions of its
        # (u, i, a) group, each with its value
        def opinion_csr(keys, vals):
            n = keys.shape[0]
            stride = self.num_aspects + 1
            group = np.unique((keys[:, 0] * self.num_items + keys[:, 1]) * stride + keys[:, 2],
                              return_inverse=True)[1].ravel()
            counts = np.bincount(group)
            order = np.argsort(group, kind="stable")
            starts = np.cumsum(counts) - counts
            size = counts[group]
            offsets = np.arange(size.sum()) - np.repeat(np.cumsum(size) - size, size)
            siblings = order[np.repeat(starts[group], size) + offsets]
            m = sp.csr_matrix((vals[siblings], (np.repeat(np.arange(n), size),
                                                keys[siblings, 3])),
                              shape=(n, self.num_opinions))
            m.sum_duplicates()
            return m

        return ((arrays(uia_keys, uia_vals), arrays(pos_keys, pos_vals),
                 arrays(neg_keys, neg_vals)),
                (rating_matrix, uia_csr, opinion_csr(pos_keys, pos_vals),
                 opinion_csr(neg_keys, neg_vals)))

    def _device_data(self, train_set, streams, matrices, dev):
        """``CompanionData`` on ``dev``."""
        def arrays(t):
            return tuple(torch.as_tensor(np.asarray(a, np.int64 if a.dtype.kind == "i"
                                                    else np.float32), device=dev) for a in t)

        rid, cid, _ = train_set.uir_tuple
        rating, uia_csr, pos_csr, neg_csr = (CsrLookup.build(m, device=dev) for m in matrices)
        return CompanionData(*(arrays(s) for s in streams),
                             torch.as_tensor(np.asarray(rid, np.int64), device=dev),
                             torch.as_tensor(np.asarray(cid, np.int64), device=dev),
                             rating, _PairAspectLookup(rating, uia_csr), pos_csr, neg_csr)

    def _sizes(self):
        """The per-iteration sample counts, rounded on a mesh as the JAX
        package rounds them (``mter.py``)."""
        return {k: round_batch(self.mesh, n) for k, n in (
            ("n_el", self.n_element_samples), ("n_bpr", self.n_bpr_samples),
            ("n_asp_rank", self.n_aspect_ranking_samples),
            ("n_op_rank", self.n_opinion_ranking_samples))}

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        self._init(train_set)
        self._tables = None
        if not self.trainable:
            return self
        dev = self._device()
        streams, matrices = self._host_streams(*self._build_data(train_set))
        data = self._device_data(train_set, streams, matrices, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.rng.randint(2**31)))
        params, sgrads = self._device_params(dev)
        lams = tuple(float(np.float32(v)) for v in (
            self.lr, self.lambda_reg, self.lambda_bpr, self.lambda_p, self.lambda_a,
            self.lambda_y, self.lambda_z))
        counts = (self.num_items, self.num_aspects, self.num_opinions)
        with torch.no_grad():
            run_iterations(
                self.max_iter,
                lambda g, n: companion_draws(g, n, data, counts, self._sizes(), dev),
                lambda d: companion_iteration(params, sgrads, data, d, self.n_user_factors,
                                              *lams, self.mesh),
                gen)
        for name in NAMES:
            setattr(self, name, params[name].cpu().numpy().astype(np.float64))
        return self
