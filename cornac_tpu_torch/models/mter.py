"""MTER — Multi-Task Explainable Recommendation (Wang et al., SIGIR 2018).

Port of ``cornac_tpu/models/mter.py``: sampled Tucker-decomposition SGD
over three tensors (user-item-aspect X, user-aspect-opinion YU,
item-aspect-opinion YI) plus a BPR term on the overall-rating slice, with
AdaGrad-style steps, a regulariser on the touched entries and a
non-negativity projection.

The JAX package runs ``max_iter`` iterations as one ``lax.fori_loop`` and
draws each iteration's samples with ``jax.random`` inside it. The port
keeps the iteration and moves the draws out of it:

- ``mter_draws(generator, n_iters, ...)`` makes a chunk of iterations'
  index streams in one call a stream (element samples of X, YU and YI, the
  BPR positives and negatives, ComparERSub's pair samples, in the JAX
  package's order), on the device, from a ``torch.Generator`` seeded from
  the model's numpy generator where the JAX package draws its key;
- ``mter_iteration(params, sgrads, data, draws, ...)`` is one iteration on
  one iteration's draws, in place. The tests feed it the JAX key's own
  draws.

Every table's gradient is one ``accumulate_rows`` call over its streams'
updates, concatenated in the order of the JAX package's chained
``.at[].add`` (X, YU, YI, BPR, pairs): the same sums in the same order, so
the ``g != 0`` gate and the AdaGrad sums see the same bits on every run.
The BPR pair-order reversal reads ratings through ``CsrLookup``.

``mesh`` (``parallel.make_mesh``), as in the JAX package: the tables and
AdaGrad's sums are replicated, every rank draws the whole of each
iteration's streams, and each stream's samples are split over every rank.
Each per-iteration sample count is rounded down to a multiple of the
mesh's size, and to at least the mesh's size, as the JAX package rounds
it, so a mesh fit draws the JAX mesh fit's counts. A rank computes the
weights and the update rows of its samples; the slices are gathered back
in stream order (``data_parallel``) into the one ``accumulate_rows`` call a
table, and every rank sums the core tensors' gradients over the whole
stream from the gathered weights: every layout gives the single-device
fit's bits. Each stream's table rows are gathered once, whole, on every
rank (the core gradients read them all), and a rank reads its slice of
them.
"""

import itertools
from collections import namedtuple

import numpy as np
import scipy.sparse as sp
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.csr_lookup import CsrLookup
from ..parallel.mesh import check_mesh
from ..parallel.sharded import data_parallel, round_batch
from ..utils import get_rng
from ..utils.init_utils import uniform
from .recommender import Recommender, pad_to_catalog

EPS = 1e-9
DRAW_CHUNK = 256  # iterations whose draws one ``mter_draws`` call makes
NAMES = ("G1", "G2", "G3", "U", "I", "A", "O")

MterData = namedtuple("MterData", "X X_u X_i X_a YU YU_u YU_a YU_o YI YI_i YI_a YI_o "
                                  "rat_users rat_items lookup pairs")
MterData.__doc__ = """MTER's device streams: the three tensors' entries (values
float32, indices int64), the rating pairs (users, items), the rating
``CsrLookup`` and ComparERSub's pairs (user, early, late, aspect) or None."""


def _tucker3(G, u, i, a):
    """(S,p)(S,q)(S,r)(p,q,r) -> (S,)"""
    return torch.einsum("sp,sq,sr,pqr->s", u, i, a, G)


def _core_grad(w, t1, t2, t3):
    """A Tucker stream's core gradient: sum_s w_s t1_s x t2_s x t3_s."""
    return torch.einsum("s,sp,sq,sr->pqr", w, t1, t2, t3)


def _row_grads(G, t1, t2, t3, w):
    """A Tucker stream's row gradients (g1, g2, g3) of weights ``w``."""
    return (torch.einsum("s,sq,sr,pqr->sp", w, t2, t3, G),
            torch.einsum("s,sp,sr,pqr->sq", w, t1, t3, G),
            torch.einsum("s,sp,sq,pqr->sr", w, t1, t2, G))


def _pair_ratings(lookup, u, i, j):
    """(whether (u, j) is rated, its rating, the rating of (u, i)): the JAX
    package's two lookups as one over both batches."""
    n = u.shape[0]
    found, rating = lookup.query(torch.cat([u, u]), torch.cat([j, i]))
    return found[:n], rating[:n], rating[n:]


def mter_draws(generator, n_iters, data, n_el, n_bpr, n_pair, n_items, device):
    """The index streams of ``n_iters`` iterations: a dict of (n_iters, n)
    int64 tensors ``s1``, ``s2``, ``s3`` (element samples of X, YU, YI),
    ``pos``, ``j`` (BPR positives and negative items) and, when ``n_pair``,
    ``sp`` (pair samples), drawn in that order from ``generator``."""
    def draw(high, n):
        return torch.randint(0, high, (n_iters, n), generator=generator, device=device)

    draws = {"s1": draw(data.X.shape[0], n_el), "s2": draw(data.YU.shape[0], n_el),
             "s3": draw(data.YI.shape[0], n_el), "pos": draw(data.rat_users.shape[0], n_bpr),
             "j": draw(n_items, n_bpr)}
    if n_pair:
        draws["sp"] = draw(data.pairs[0].shape[0], n_pair)
    return draws


def adagrad_project(params, sgrads, grads, lr, ld_reg):
    """The JAX package's step, in place: a regulariser on the entries with
    a non-zero gradient, AdaGrad's sums, the step and the projection onto
    non-negative values. Every operation runs on all tables at once
    (``torch._foreach_*``: some fifteen launches, not ninety); the step is
    ``lr * (1 / sqrt(sg)) * g_reg``, within an ulp of the JAX package's
    ``(lr / sqrt(sg)) * g_reg``."""
    names = list(grads)
    g = [grads[n] for n in names]
    p = [params[n] for n in names]
    sg = [sgrads[n] for n in names]
    # |sign(g)| is 1 where g != 0 and 0 elsewhere: the gate, as a factor
    touched = torch._foreach_abs(torch._foreach_sign(g))
    g_reg = torch._foreach_add(g, torch._foreach_mul(torch._foreach_mul(p, ld_reg), touched))
    torch._foreach_add_(sg, EPS)
    torch._foreach_add_(sg, torch._foreach_mul(g_reg, g_reg))
    rate = torch._foreach_mul(torch._foreach_reciprocal(torch._foreach_sqrt(sg)), lr)
    torch._foreach_sub_(p, torch._foreach_mul(rate, g_reg))
    torch._foreach_clamp_min_(p, 0.0)


def mter_iteration(params, sgrads, data, draws, lr, ld_reg, ld_bpr, ld_d=0.0, mesh=None):
    """One iteration of the JAX package's ``_mter_fit`` on one iteration's
    ``draws`` (a dict of (n,) tensors as ``mter_draws`` makes them), in
    place on the dicts ``params`` and ``sgrads``. ``mesh``: each stream's
    samples split over every rank (module docstring)."""
    G1, G2, G3 = params["G1"], params["G2"], params["G3"]
    U, I, A, O = params["U"], params["I"], params["A"], params["O"]
    n_aspects = A.shape[0] - 1
    ids = {"U": [], "I": [], "A": [], "O": []}
    upd = {"U": [], "I": [], "A": [], "O": []}

    def add(name, idx, g):
        ids[name].append(idx)
        upd[name].append(g)

    def tensor_stream(G, values, index, names, s):
        """A sampled tensor-reconstruction stream on the tables ``names``:
        each table's ids and update rows added; returns its core
        gradient."""
        idx = [a[s] for a in index]
        t = [params[n][i] for n, i in zip(names, idx)]

        def rows(v, *t_):
            e = 2.0 * (_tucker3(G, *t_) - v)
            return (e,) + _row_grads(G, *t_, e)

        e, *grads = data_parallel(mesh, rows, t[0].shape[0], values[s], *t, axis=None)
        for name, i, g in zip(names, idx, grads):
            add(name, i, g)
        return _core_grad(e, *t)

    # three sampled tensor-reconstruction streams
    gG1 = tensor_stream(G1, data.X, (data.X_u, data.X_i, data.X_a), ("U", "I", "A"),
                        draws["s1"])
    gG2 = tensor_stream(G2, data.YU, (data.YU_u, data.YU_a, data.YU_o), ("U", "A", "O"),
                        draws["s2"])
    gG3 = tensor_stream(G3, data.YI, (data.YI_i, data.YI_a, data.YI_o), ("I", "A", "O"),
                        draws["s3"])

    # BPR stream on the overall-rating slice (aspect index n_aspects)
    def bpr_rows(u, i, j, Uu, Ii, Ij, i_ij):
        found, j_rating, i_rating = _pair_ratings(data.lookup, u, i, j)
        # unobserved j: s = +1; observed with a lower rating: s = -1; equal: skip
        s = torch.where(found & (i_rating < j_rating), -1.0, 1.0)
        valid = ~(found & (i_rating == j_rating))
        Aov = A[n_aspects].expand(u.shape[0], A.shape[1])
        pred = (_tucker3(G1, Uu, Ii, Aov) - _tucker3(G1, Uu, Ij, Aov)) * s
        z = 1.0 / (1.0 + torch.exp(pred))
        del_bpr = ld_bpr * z * s * valid
        return (del_bpr, -torch.einsum("s,sq,sr,pqr->sp", del_bpr, i_ij, Aov, G1),
                torch.einsum("s,sp,sr,pqr->sq", del_bpr, Uu, Aov, G1))

    pos, j = draws["pos"], draws["j"]
    u, i = data.rat_users[pos], data.rat_items[pos]
    Uu, Ii, Ij = U[u], I[i], I[j]
    i_ij = Ii - Ij
    del_bpr, g_u, g_i = data_parallel(mesh, bpr_rows, u.shape[0], u, i, j, Uu, Ii, Ij, i_ij,
                                       axis=None)
    Aov = A[n_aspects].expand(u.shape[0], A.shape[1])
    gG1 = gG1 - torch.einsum("s,sp,sq,sr->pqr", del_bpr, Uu, i_ij, Aov)
    add("U", u, g_u)
    add("I", i, -g_i), add("I", j, g_i)
    add("A", torch.full((1,), n_aspects, dtype=torch.int64, device=A.device),
        -torch.einsum("s,sp,sq,pqr->r", del_bpr, Uu, i_ij, G1)[None, :])

    if data.pairs is not None and "sp" in draws:
        # comparative aspect-BPR stream (ComparERSub): for a sampled chrono
        # pair (u, earlier i, later j, aspect a), push score(u, j, a) above
        # score(u, i, a)
        def pair_rows(pu, pi, pj, pa, a_ji):
            pred_p = _tucker3(G1, pu, pj, pa) - _tucker3(G1, pu, pi, pa)
            del_p = ld_d * (1.0 / (1.0 + torch.exp(pred_p)))
            return (del_p, -torch.einsum("s,sq,sr,pqr->sp", del_p, a_ji, pa, G1),
                    torch.einsum("s,sp,sr,pqr->sq", del_p, pu, pa, G1),
                    -torch.einsum("s,sp,sq,pqr->sr", del_p, pu, a_ji, G1))

        pu_, pe_, pl_, pa_ = (p[draws["sp"]] for p in data.pairs)
        pu, pi, pj, pa = U[pu_], I[pe_], I[pl_], A[pa_]
        a_ji = pj - pi
        del_p, g_u, g_pi, g_a = data_parallel(mesh, pair_rows, pu.shape[0], pu, pi, pj, pa,
                                               a_ji, axis=None)
        gG1 = gG1 - torch.einsum("s,sp,sq,sr->pqr", del_p, pu, a_ji, pa)
        add("U", pu_, g_u)
        add("I", pl_, -g_pi), add("I", pe_, g_pi)
        add("A", pa_, g_a)

    grads = {"G1": gG1, "G2": gG2, "G3": gG3}
    for name in ("U", "I", "A", "O"):
        table = params[name]
        grads[name] = accumulate_rows(table.new_zeros(table.shape), torch.cat(ids[name]),
                                      torch.cat(upd[name]))
    adagrad_project(params, sgrads, {n: grads[n] for n in NAMES}, lr, ld_reg)
    return params, sgrads


def run_iterations(n_iters, draw, step, generator):
    """``n_iters`` calls of ``step(draws of one iteration)``, the draws made
    ``DRAW_CHUNK`` iterations at a time by ``draw(generator, chunk)``."""
    done = 0
    while done < n_iters:
        chunk = min(DRAW_CHUNK, n_iters - done)
        draws = draw(generator, chunk)
        for t in range(chunk):
            step({k: v[t] for k, v in draws.items()})
        done += chunk


class MTER(Recommender):
    """Joint Tucker factorization of rating/attention/quality tensors.

    Parameters mirror the JAX package's. ``device``: where the model fits
    and scores (default: the card). ``mesh``: a ``parallel.make_mesh``
    mesh; every rank calls ``fit`` (module docstring).
    """

    def __init__(
        self,
        name="MTER",
        rating_scale=5.0,
        n_user_factors=15,
        n_item_factors=15,
        n_aspect_factors=12,
        n_opinion_factors=12,
        n_bpr_samples=1000,
        n_element_samples=50,
        lambda_reg=0.1,
        lambda_bpr=10,
        max_iter=200000,
        lr=0.1,
        n_threads=0,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.n_threads = n_threads
        self.rating_scale = rating_scale
        self.n_user_factors = n_user_factors
        self.n_item_factors = n_item_factors
        self.n_aspect_factors = n_aspect_factors
        self.n_opinion_factors = n_opinion_factors
        self.n_bpr_samples = n_bpr_samples
        self.n_element_samples = n_element_samples
        self.lambda_reg = lambda_reg
        self.lambda_bpr = lambda_bpr
        self.max_iter = max_iter
        self.lr = lr
        self.seed = seed
        self.rng = get_rng(seed)
        self.ignored_attrs.append("_tables")

        self.init_params = {} if init_params is None else init_params
        for name_ in NAMES:
            setattr(self, name_, self.init_params.get(name_, None))

    def _compute_attention_score(self, count):
        return 1 + (self.rating_scale - 1) * (2 / (1 + np.exp(-count)) - 1)

    def _compute_quality_score(self, sentiment):
        return 1 + (self.rating_scale - 1) / (1 + np.exp(-sentiment))

    def _init(self, train_set):
        sentiment = train_set.sentiment
        self.num_aspects = sentiment.num_aspects
        self.num_opinions = sentiment.num_opinions
        rng = self.rng

        if self.G1 is None:
            self.G1 = uniform(
                (self.n_user_factors, self.n_item_factors, self.n_aspect_factors),
                random_state=rng,
            )
        if self.G2 is None:
            self.G2 = uniform(
                (self.n_user_factors, self.n_aspect_factors, self.n_opinion_factors),
                random_state=rng,
            )
        if self.G3 is None:
            self.G3 = uniform(
                (self.n_item_factors, self.n_aspect_factors, self.n_opinion_factors),
                random_state=rng,
            )
        if self.U is None:
            self.U = uniform((self.num_users, self.n_user_factors), random_state=rng)
        if self.I is None:
            self.I = uniform((self.num_items, self.n_item_factors), random_state=rng)
        if self.A is None:
            self.A = uniform(
                (self.num_aspects + 1, self.n_aspect_factors), random_state=rng
            )
        if self.O is None:
            self.O = uniform(
                (self.num_opinions, self.n_opinion_factors), random_state=rng
            )

    def _build_data(self, data_set):
        sentiment = data_set.sentiment
        u_idx_arr, i_idx_arr, r_vals = data_set.uir_tuple
        rating_matrix = sp.csr_matrix(
            (r_vals, (u_idx_arr, i_idx_arr)), shape=(self.num_users, self.num_items)
        )

        user_item_aspect = {}
        user_aspect_opinion = {}
        item_aspect_opinion = {}
        for u_idx, by_item in sentiment.user_sentiment.items():
            if u_idx >= self.num_users:
                continue
            for i_idx, tup_idx in by_item.items():
                user_item_aspect[(u_idx, i_idx, sentiment.num_aspects)] = (
                    rating_matrix[u_idx, i_idx]
                )
                for a_idx, o_idx, polarity in sentiment.sentiment[tup_idx]:
                    user_item_aspect[(u_idx, i_idx, a_idx)] = (
                        user_item_aspect.get((u_idx, i_idx, a_idx), 0) + polarity
                    )
                    if polarity > 0:  # positive opinions only
                        user_aspect_opinion[(u_idx, a_idx, o_idx)] = (
                            user_aspect_opinion.get((u_idx, a_idx, o_idx), 0) + 1
                        )
                        item_aspect_opinion[(i_idx, a_idx, o_idx)] = (
                            item_aspect_opinion.get((i_idx, a_idx, o_idx), 0) + 1
                        )

        for key in user_item_aspect:
            if key[2] != sentiment.num_aspects:
                user_item_aspect[key] = self._compute_quality_score(
                    user_item_aspect[key]
                )
        for key in user_aspect_opinion:
            user_aspect_opinion[key] = self._compute_attention_score(
                user_aspect_opinion[key]
            )
        for key in item_aspect_opinion:
            item_aspect_opinion[key] = self._compute_attention_score(
                item_aspect_opinion[key]
            )

        return rating_matrix, user_item_aspect, user_aspect_opinion, item_aspect_opinion

    def _device_data(self, train_set, rating_matrix, uia, uao, iao, pairs, dev):
        """``MterData`` on ``dev`` from ``_build_data``'s dicts (in their
        insertion order, as the JAX package unpacks them)."""
        def unpack(d):
            keys = np.fromiter(itertools.chain.from_iterable(d.keys()), dtype=np.int64,
                               count=3 * len(d)).reshape(-1, 3)
            vals = np.fromiter(d.values(), dtype=np.float64, count=len(d)).astype(np.float32)
            return tuple(torch.as_tensor(a, device=dev)
                         for a in (vals, keys[:, 0].copy(), keys[:, 1].copy(), keys[:, 2].copy()))

        rid, cid, _ = train_set.uir_tuple
        return MterData(*unpack(uia), *unpack(uao), *unpack(iao),
                        torch.as_tensor(np.asarray(rid, np.int64), device=dev),
                        torch.as_tensor(np.asarray(cid, np.int64), device=dev),
                        CsrLookup.build(rating_matrix, device=dev),
                        None if pairs is None else tuple(
                            torch.as_tensor(np.asarray(p, np.int64), device=dev) for p in pairs))

    def _device_params(self, dev):
        params = {n: torch.as_tensor(np.asarray(getattr(self, n), np.float32), device=dev).clone()
                  for n in NAMES}
        return params, {n: torch.zeros_like(p) for n, p in params.items()}

    def _fit_sampled(self, data, dev, n_pair=0, ld_d=0.0):
        """The sampled iterations from the initial tables: the generator is
        seeded where the JAX package draws its key; on a mesh the sample
        counts are rounded as the JAX package rounds them (module
        docstring)."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.rng.randint(2**31)))
        params, sgrads = self._device_params(dev)
        lr, ld_reg, ld_bpr, ld_d = (float(np.float32(v)) for v in (
            self.lr, self.lambda_reg, self.lambda_bpr, ld_d))
        mesh = self.mesh
        n_el, n_bpr = (round_batch(mesh, n) for n in (self.n_element_samples,
                                                      self.n_bpr_samples))
        n_pair = round_batch(mesh, n_pair) if n_pair else 0
        with torch.no_grad():
            run_iterations(
                self.max_iter,
                lambda g, n: mter_draws(g, n, data, n_el, n_bpr, n_pair, self.num_items, dev),
                lambda d: mter_iteration(params, sgrads, data, d, lr, ld_reg, ld_bpr, ld_d,
                                         mesh),
                gen)
        for name in NAMES:
            setattr(self, name, params[name].cpu().numpy().astype(np.float64))
        self._tables = None

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        self._init(train_set)
        self._tables = None
        if not self.trainable:
            return self
        dev = self._device()
        rating_matrix, uia, uao, iao = self._build_data(train_set)
        data = self._device_data(train_set, rating_matrix, uia, uao, iao, None, dev)
        self._fit_sampled(data, dev)
        return self

    def _on_device(self):
        """(U, I, G1, the overall-rating aspect row) as float64 tensors on
        the model's device, copied once after a fit."""
        if getattr(self, "_tables", None) is None:
            dev = self._device()
            self._tables = tuple(torch.as_tensor(np.asarray(a, np.float64), device=dev) for a in (
                self.U, self.I, self.G1, self.A[self.num_aspects]))
        return self._tables

    def _user_item_factors(self, users):
        """(B, q) user rows of the overall-rating slice, float64."""
        U, _, G1, a_ov = self._on_device()
        u = torch.as_tensor(np.asarray(users, np.int64), device=U.device)
        return torch.einsum("bp,pqr,r->bq", U[u], G1, a_ov)

    def score(self, u_idx, i_idx=None):
        if self.is_unknown_user(u_idx):
            raise ScoreException("Can't make score prediction for user %d" % u_idx)
        if i_idx is not None and self.is_unknown_item(i_idx):
            raise ScoreException("Can't make score prediction for item %d" % i_idx)
        # overall-rating slice of the Tucker product
        _, I, _, _ = self._on_device()
        ua = self._user_item_factors([u_idx])[0]
        if i_idx is None:
            return (I @ ua).cpu().numpy()
        return float(I[i_idx] @ ua)

    def score_pairs(self, user_indices, item_indices):
        """``score(u, i)`` of every pair at once, on the device in float64;
        an unknown user or item takes ``default_score()``, as the loop's
        ScoreException does."""
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        _, I, _, _ = self._on_device()
        i = torch.as_tensor(np.where(known, items, 0).astype(np.int64), device=I.device)
        ua = self._user_item_factors(np.where(known, users, 0))
        preds = torch.sum(I[i] * ua, 1).cpu().numpy()
        return np.where(known, preds, self.default_score())

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        _, I, _, _ = self._on_device()
        scores = (self._user_item_factors(np.where(known, users, 0)) @ I.T).cpu().numpy()
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
