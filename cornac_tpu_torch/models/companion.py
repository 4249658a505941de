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
"""

import itertools

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.csr_lookup import CsrLookup
from ..utils.init_utils import uniform
from .mter import MTER, NAMES, _pair_ratings, _tucker3, adagrad_project, run_iterations
from .recommender import Recommender


def _split_pred(G, Uu, Ii, Aa, Oo):
    """Stacked-tensor prediction: user half + item half, as one contraction
    of the stacked tensor with the user and item rows side by side."""
    return _tucker3(G, torch.cat([Uu, Ii], 1), Aa, Oo)


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


def companion_iteration(params, sgrads, data, draws, nu, lr, ld_reg, ld_bpr, ld_p, ld_a, ld_y,
                        ld_z):
    """One iteration of the JAX package's ``_companion_fit`` on one
    iteration's ``draws``, in place on ``params`` and ``sgrads``."""
    G1, U, I, A, O = params["G1"], params["U"], params["I"], params["A"], params["O"]
    n_aspects = A.shape[0] - 1
    ids = {"U": [], "I": [], "A": [], "O": []}
    upd = {"U": [], "I": [], "A": [], "O": []}
    core = {"G1": [], "G2": [], "G3": []}

    def add(name, idx, g):
        ids[name].append(idx)
        upd[name].append(g)

    def g1_grads(w, u, i, a, Uu, Ii, Aa):
        """G1-stream gradient: d(pred)/dθ scaled by w."""
        core["G1"].append(torch.einsum("s,sp,sq,sr->pqr", w, Uu, Ii, Aa))
        add("U", u, torch.einsum("s,sq,sr,pqr->sp", w, Ii, Aa, G1))
        add("I", i, torch.einsum("s,sp,sr,pqr->sq", w, Uu, Aa, G1))
        add("A", a, torch.einsum("s,sp,sq,pqr->sr", w, Uu, Ii, G1))

    def stacked_grads(gname, w, u, i, a, o, Uu, Ii, Aa, Oo, o_j=None):
        """A stacked opinion tensor stream's gradients (G2 or G3), each
        contraction over both halves at once (the user and item rows side
        by side); ``Oo`` is the opinions' rows, or their difference from
        the negatives' (``o_j``) for a ranking stream."""
        G = params[gname]
        UI = torch.cat([Uu, Ii], 1)
        core[gname].append(torch.einsum("s,sp,sq,sr->pqr", w, UI, Aa, Oo))
        g_ui = torch.einsum("s,sq,sr,pqr->sp", w, Aa, Oo, G)
        add("U", u, g_ui[:, :nu].contiguous())
        add("I", i, g_ui[:, nu:].contiguous())
        add("A", a, torch.einsum("s,sp,sr,pqr->sq", w, UI, Oo, G))
        g_o = torch.einsum("s,sp,sq,pqr->sr", w, UI, Aa, G)
        add("O", o, g_o)
        if o_j is not None:
            add("O", o_j, -g_o)

    X, X_u, X_i, X_a = data.X
    # element reconstruction streams
    s1 = draws["s1"]
    u, i, a = X_u[s1], X_i[s1], X_a[s1]
    Uu, Ii, Aa = U[u], I[i], A[a]
    g1_grads(2.0 * (_tucker3(G1, Uu, Ii, Aa) - X[s1]), u, i, a, Uu, Ii, Aa)
    for gname, stream, key in (("G2", data.YP, "s2"), ("G3", data.YN, "s3")):
        Yv, Yu, Yi, Ya, Yo = stream
        s = draws[key]
        u, i, a, o = Yu[s], Yi[s], Ya[s], Yo[s]
        Uu, Ii, Aa, Oo = U[u], I[i], A[a], O[o]
        pred = _split_pred(params[gname], Uu, Ii, Aa, Oo)
        stacked_grads(gname, 2.0 * (pred - Yv[s]), u, i, a, o, Uu, Ii, Aa, Oo)

    # overall-rating BPR
    pos = draws["pos"]
    u, i, j = data.rat_users[pos], data.rat_items[pos], draws["j"]
    found, j_rating, i_rating = _pair_ratings(data.rating_lookup, u, i, j)
    s = torch.where(found & (i_rating < j_rating), -1.0, 1.0)
    valid = ~(found & (i_rating == j_rating))
    Uu, Ii, Ij = U[u], I[i], I[j]
    Aov = A[n_aspects].expand(u.shape[0], A.shape[1])
    pred = (_tucker3(G1, Uu, Ii, Aov) - _tucker3(G1, Uu, Ij, Aov)) * s
    del_bpr = ld_bpr * (1.0 / (1.0 + torch.exp(pred))) * s * valid
    i_ij = Ii - Ij
    core["G1"].append(-torch.einsum("s,sp,sq,sr->pqr", del_bpr, Uu, i_ij, Aov))
    add("U", u, -torch.einsum("s,sq,sr,pqr->sp", del_bpr, i_ij, Aov, G1))
    g_i = torch.einsum("s,sp,sr,pqr->sq", del_bpr, Uu, Aov, G1)
    add("I", i, -g_i), add("I", j, g_i)
    add("A", torch.full((1,), n_aspects, dtype=torch.int64, device=A.device),
        -torch.einsum("s,sp,sq,pqr->r", del_bpr, Uu, i_ij, G1)[None, :])

    # the two aspect-ranking streams' lookups, each one call over both
    sp_, si = draws["sp"], draws["si"]
    u, i, a = X_u[sp_], X_i[sp_], X_a[sp_]
    a_j = draws["a_j"]
    u2, i2, a2 = X_u[si], X_i[si], X_a[si]
    i_j = draws["i_j"]
    n = u.shape[0]
    _, pos = data.uia_lookup.query_pair(torch.cat([u, u2]), torch.cat([i, i_j]))
    found_a, score_a, _ = data.uia_lookup.query_aspect(pos, torch.cat([a_j, a2]))

    # aspect ranking against a random aspect (ld_p)
    found_j, j_score = found_a[:n], score_a[:n]
    i_score = X[sp_]
    s = torch.where(found_j & (i_score < j_score), -1.0, 1.0)
    valid = ~(found_j & (i_score == j_score))
    Uu, Ii, Aa, Aj = U[u], I[i], A[a], A[a_j]
    pred = (_tucker3(G1, Uu, Ii, Aa) - _tucker3(G1, Uu, Ii, Aj)) * s
    w = -ld_p * (1.0 / (1.0 + torch.exp(pred))) * s * valid
    a_diff = Aa - Aj
    core["G1"].append(torch.einsum("s,sp,sq,sr->pqr", w, Uu, Ii, a_diff))
    add("U", u, torch.einsum("s,sq,sr,pqr->sp", w, Ii, a_diff, G1))
    add("I", i, torch.einsum("s,sp,sr,pqr->sq", w, Uu, a_diff, G1))
    g_a = torch.einsum("s,sp,sq,pqr->sr", w, Uu, Ii, G1)
    add("A", a, g_a), add("A", a_j, -g_a)

    # aspect ranking against a random item (ld_a)
    u, i, a = u2, i2, a2
    found_ja, j_score = found_a[n:], score_a[n:]
    i_score = X[si]
    s = torch.where(found_ja & (i_score < j_score), -1.0, 1.0)
    valid = ~(found_ja & (i_score == j_score))
    Uu, Aa, Ii, Ij = U[u], A[a], I[i], I[i_j]
    pred = (_tucker3(G1, Uu, Ii, Aa) - _tucker3(G1, Uu, Ij, Aa)) * s
    w = -ld_a * (1.0 / (1.0 + torch.exp(pred))) * s * valid
    i_diff = Ii - Ij
    core["G1"].append(torch.einsum("s,sp,sq,sr->pqr", w, Uu, i_diff, Aa))
    add("U", u, torch.einsum("s,sq,sr,pqr->sp", w, i_diff, Aa, G1))
    g_i = torch.einsum("s,sp,sr,pqr->sq", w, Uu, Aa, G1)
    add("I", i, g_i), add("I", i_j, -g_i)
    add("A", a, torch.einsum("s,sp,sq,pqr->sr", w, Uu, i_diff, G1))

    # opinion ranking streams (ld_y positive, ld_z negative)
    for gname, stream, lookup, ld, so_key, oj_key in (
            ("G2", data.YP, data.pos_op_lookup, ld_y, "so_P", "oj_P"),
            ("G3", data.YN, data.neg_op_lookup, ld_z, "so_N", "oj_N")):
        Yv, Yu, Yi, Ya, Yo = stream
        so, o_j = draws[so_key], draws[oj_key]
        u, i, a, o = Yu[so], Yi[so], Ya[so], Yo[so]
        found_o, j_score = lookup.query(so, o_j)
        i_score = Yv[so]
        s = torch.where(found_o & (i_score < j_score), -1.0, 1.0)
        valid = ~(found_o & (i_score == j_score))
        G = params[gname]
        Uu, Ii, Aa, Oo, Oj = U[u], I[i], A[a], O[o], O[o_j]
        pred = (_split_pred(G, Uu, Ii, Aa, Oo) - _split_pred(G, Uu, Ii, Aa, Oj)) * s
        w = -ld * (1.0 / (1.0 + torch.exp(pred))) * s * valid
        stacked_grads(gname, w, u, i, a, o, Uu, Ii, Aa, Oo - Oj, o_j)

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
    the card); ``mesh`` is refused (ROADMAP.md A8)."""

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
        return {"n_el": self.n_element_samples, "n_bpr": self.n_bpr_samples,
                "n_asp_rank": self.n_aspect_ranking_samples,
                "n_op_rank": self.n_opinion_ranking_samples}

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
                                              *lams),
                gen)
        for name in NAMES:
            setattr(self, name, params[name].cpu().numpy().astype(np.float64))
        return self
