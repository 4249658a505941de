"""LRPPM — Learning to Rank user Preferences with Paired features from
Multiple aspects (Chen et al., SIGIR 2016).

Port of ``cornac_tpu/models/lrppm.py``: rating SGD plus an aspect-pair BPR
over the additive score U.UA + I.IA + U.I, plain SGD with a clip, a
regulariser on the touched entries and a non-negativity projection.

As in ``mter.py``, the draws move out of the iteration: ``lrppm_draws``
makes a chunk of iterations' index streams on the device (rating samples,
aspect-triple samples, negative aspects, in the JAX package's order) and
``lrppm_iteration`` runs one iteration on one iteration's draws, in place.
The skip of an observed negative aspect chains two lookups, as the JAX
package does: the (user, item) pair's nnz position in the rating CSR
(``CsrLookup.query_position``), then the negative aspect in that row of the
(nnz x aspects) aspect CSR (``Membership``). Each table's gradient is one
``accumulate_rows`` call over its updates in the order of the JAX
package's chained ``.at[].add``: the update touches only the entries whose
summed gradient is not exactly 0, so the sums must carry the same bits.

Ranking uses the paper's top-aspect composite score, which the JAX package
computes on the host in float64; the port computes it on the model's
device in float64.
"""

from collections import namedtuple

import numpy as np
import scipy.sparse as sp
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.csr_lookup import CsrLookup
from ..ops.membership import Membership
from ..utils import get_rng
from ..utils.init_utils import uniform
from .mter import run_iterations
from .recommender import Recommender, pad_to_catalog

COMPOSITE_USERS = 16  # users whose (items x aspects) scores one step holds

LrppmData = namedtuple("LrppmData", "rid cid rvals X_u X_i X_a X_l lookup aspects n_aspects")
LrppmData.__doc__ = """LRPPM's device streams: the rating triples, the
(user, item, aspect) triples and their weights, the rating ``CsrLookup``,
the aspect ``Membership`` keyed by the rating pair's nnz position, and the
number of aspects."""


def lrppm_draws(generator, n_iters, data, n_samples, n_ranking, device):
    """The index streams of ``n_iters`` iterations: (n_iters, n) int64
    tensors ``s`` (rating samples), ``s2`` (aspect-triple samples) and
    ``a_neg`` (negative aspects), drawn in that order."""
    def draw(high, n):
        return torch.randint(0, high, (n_iters, n), generator=generator, device=device)

    return {"s": draw(data.rid.shape[0], n_samples), "s2": draw(data.X_u.shape[0], n_ranking),
            "a_neg": draw(data.n_aspects, n_ranking)}


def _apply(tables, grads, lr, reg):
    """The JAX package's clipped, touched-only SGD step with the
    projection, in place, on all tables at once (``torch._foreach_*``)."""
    g = torch._foreach_clamp_max(torch._foreach_clamp_min(list(grads), -10.0), 10.0)
    # |sign(g)| is 1 where g != 0 and 0 elsewhere: the gate, as a factor
    touched = torch._foreach_abs(torch._foreach_sign(g))
    g = torch._foreach_add(g, torch._foreach_mul(torch._foreach_mul(list(tables), reg), touched))
    torch._foreach_sub_(list(tables), torch._foreach_mul(g, lr))
    torch._foreach_clamp_min_(list(tables), 0.0)


def lrppm_iteration(params, data, draws, lr, reg, ld):
    """One iteration of the JAX package's ``_lrppm_fit`` on one iteration's
    ``draws``, in place on ``params`` (U, I, UA, IA)."""
    U, I, UA, IA = params

    # rating stream: r ~ U.I
    s = draws["s"]
    u1, i1, r = data.rid[s], data.cid[s], data.rvals[s]
    Uu1, Ii1 = U[u1], I[i1]
    e = 2.0 * (torch.sum(Uu1 * Ii1, dim=1) - r)

    # aspect-pair ranking stream
    s2 = draws["s2"]
    u, i, a = data.X_u[s2], data.X_i[s2], data.X_a[s2]
    a_neg = draws["a_neg"]
    # skip when (u, i, a_neg) is an observed aspect triple: the pair's nnz
    # position in the rating CSR, then a_neg in that row of the aspect CSR
    _, r_ui, pair_pos = data.lookup.query_position(u, i)
    observed = data.aspects.query(pair_pos, a_neg)
    valid = (~observed) & (a_neg != a)
    Uu, Ii = U[u], I[i]
    UAa, UAn, IAa, IAn = UA[a], UA[a_neg], IA[a], IA[a_neg]
    ui = torch.sum(Uu * Ii, dim=1)

    def aspect_score(ua, ia):
        return torch.sum(Uu * ua, dim=1) + torch.sum(Ii * ia, dim=1) + ui

    pred = aspect_score(UAa, IAa) - aspect_score(UAn, IAn)
    z = (ld * valid / (1.0 + torch.exp(pred)))[:, None]

    # weighted rating refit on the sampled (u, i) pairs (their ratings came
    # with their positions above)
    del_rating = (2.0 * data.X_l[s2] * (r_ui - ui))[:, None]

    zU, zI = z * Uu, z * Ii
    dU = accumulate_rows(torch.zeros_like(U), torch.cat([u1, u, u]),
                         torch.cat([e[:, None] * Ii1, -z * (UAa - UAn), del_rating * Ii]))
    dI = accumulate_rows(torch.zeros_like(I), torch.cat([i1, i, i]),
                         torch.cat([e[:, None] * Uu1, -z * (IAa - IAn), del_rating * Uu]))
    dUA = accumulate_rows(torch.zeros_like(UA), torch.cat([a, a_neg]), torch.cat([-zU, zU]))
    dIA = accumulate_rows(torch.zeros_like(IA), torch.cat([a, a_neg]), torch.cat([-zI, zI]))
    _apply(params, (dU, dI, dUA, dIA), lr, reg)
    return params


def aspect_membership(csr, user_item_aspect, n_aspects, dev):
    """The JAX package's aspect CSR keyed by the (user, item) pair's nnz
    position in the rating CSR ``csr``, as a ``Membership`` on ``dev``
    (the CSR binary search, the JAX package's structure)."""
    pair_pos = {}
    for u_ in range(csr.shape[0]):
        for p in range(csr.indptr[u_], csr.indptr[u_ + 1]):
            pair_pos[(u_, int(csr.indices[p]))] = p
    rows = [[] for _ in range(csr.nnz)]
    for (uid, iid, aid) in user_item_aspect:
        p = pair_pos.get((uid, iid))
        if p is not None:
            rows[p].append(aid)
    aspect_indptr = np.zeros(csr.nnz + 1, dtype=np.int64)
    aspect_indices = []
    for p, aids in enumerate(rows):
        aspect_indices.extend(sorted(aids))
        aspect_indptr[p + 1] = len(aspect_indices)
    steps = max(1, int(np.diff(aspect_indptr).max(initial=0)).bit_length() + 1)
    # a sentinel past the last entry keeps the probes of empty rows in bounds
    indices = np.append(np.asarray(aspect_indices, np.int32), np.int32(2**31 - 1))
    return Membership("csr", (torch.as_tensor(aspect_indptr, device=dev),
                              torch.as_tensor(indices, device=dev)), n_aspects,
                      search_steps=steps)


class LRPPM(Recommender):
    """Aspect-pair ranking tensor model with composite top-aspect scoring.

    Parameters mirror the JAX package's. ``device``: where the model fits
    and scores (default: the card). ``mesh`` is refused (ROADMAP.md A8).
    """

    def __init__(
        self,
        name="LRPPM",
        rating_scale=5,
        n_factors=8,
        ld=1,
        reg=0.01,
        alpha=1,
        num_top_aspects=99999,
        n_ranking_samples=1000,
        n_samples=200,
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
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        self.mesh = mesh
        self.device = device
        self.n_threads = n_threads
        self.rating_scale = rating_scale
        self.n_factors = n_factors
        self.ld = ld
        self.reg = reg
        self.alpha = alpha
        self.num_top_aspects = num_top_aspects
        self.n_ranking_samples = n_ranking_samples
        self.n_samples = n_samples
        self.max_iter = max_iter
        self.lr = lr
        self.seed = seed
        self.rng = get_rng(seed)
        self.ignored_attrs.append("_tables")

        self.init_params = {} if init_params is None else init_params
        self.U = self.init_params.get("U", None)
        self.I = self.init_params.get("I", None)
        self.UA = self.init_params.get("UA", None)
        self.IA = self.init_params.get("IA", None)

    def _compute_quality_score(self, total_sentiment):
        return 1.0 / (1.0 + np.exp(-total_sentiment))

    def _build_data(self, train_set):
        """(user_item_aspect, item_aspect_quality) dicts, as the JAX fit
        builds them."""
        sentiment = train_set.sentiment
        user_item_aspect = {}
        item_aspect_quality = {}
        for uid, by_item in sentiment.user_sentiment.items():
            if uid >= self.num_users:
                continue
            for iid, tup_idx in by_item.items():
                for aid, oid, polarity in sentiment.sentiment[tup_idx]:
                    user_item_aspect[(uid, iid, aid)] = (
                        user_item_aspect.get((uid, iid, aid), 0) + polarity
                    )
                    item_aspect_quality[(iid, aid)] = (
                        item_aspect_quality.get((iid, aid), 0) + polarity
                    )
        return user_item_aspect, item_aspect_quality

    def _triples(self, user_item_aspect):
        """(X_u, X_i, X_a, X_l) lists of the aspect-ranking stream."""
        ui_num_aspects = {}
        for (uid, iid, aid) in user_item_aspect:
            ui_num_aspects[(uid, iid)] = ui_num_aspects.get((uid, iid), 0) + 1

        X_u, X_i, X_a, X_l = [], [], [], []
        for (uid, iid, aid) in user_item_aspect:
            X_u.append(uid)
            X_i.append(iid)
            X_a.append(aid)
            cnt = ui_num_aspects[(uid, iid)]
            neg_cnt = max(self.num_aspects - cnt, 1)
            X_l.append(1.0 / (cnt * neg_cnt))
        return X_u, X_i, X_a, X_l

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if train_set.sentiment is None:
            raise ValueError("this model needs the sentiment modality attached to the eval method")
        sentiment = train_set.sentiment
        self.num_aspects = sentiment.num_aspects
        rng = self.rng
        self._tables = None

        if self.U is None:
            self.U = uniform((self.num_users, self.n_factors), random_state=rng)
        if self.I is None:
            self.I = uniform((self.num_items, self.n_factors), random_state=rng)
        if self.UA is None:
            self.UA = uniform((self.num_aspects, self.n_factors), random_state=rng)
        if self.IA is None:
            self.IA = uniform((self.num_aspects, self.n_factors), random_state=rng)

        user_item_aspect, item_aspect_quality = self._build_data(train_set)
        iq_i, iq_a, iq_v = [], [], []
        for (iid, aid), total in item_aspect_quality.items():
            iq_i.append(iid)
            iq_a.append(aid)
            iq_v.append(self._compute_quality_score(total))
        self.item_aspect_quality = sp.csr_matrix(
            (iq_v, (iq_i, iq_a)), shape=(self.num_items, self.num_aspects)
        )

        if not self.trainable:
            return self

        dev = self._device()
        X_u, X_i, X_a, X_l = self._triples(user_item_aspect)
        rid, cid, rvals = train_set.uir_tuple
        csr = train_set.csr_matrix
        if not csr.has_sorted_indices:
            csr = csr.sorted_indices()
        as_long = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        as_float = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        data = LrppmData(as_long(rid), as_long(cid), as_float(rvals), as_long(X_u), as_long(X_i),
                         as_long(X_a), as_float(X_l), CsrLookup.build(csr, device=dev),
                         aspect_membership(csr, user_item_aspect, self.num_aspects, dev),
                         self.num_aspects)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rng.randint(2**31)))
        params = tuple(torch.as_tensor(np.asarray(t, np.float32), device=dev).clone()
                       for t in (self.U, self.I, self.UA, self.IA))
        lr, reg, ld = (float(np.float32(v)) for v in (self.lr, self.reg, self.ld))
        with torch.no_grad():
            run_iterations(
                self.max_iter,
                lambda g, n: lrppm_draws(g, n, data, self.n_samples, self.n_ranking_samples, dev),
                lambda d: lrppm_iteration(params, data, d, lr, reg, ld), gen)
        self.U, self.I, self.UA, self.IA = (t.cpu().numpy().astype(np.float64) for t in params)
        return self

    def _on_device(self):
        """(U, I, UA, IA, the dense item-aspect quality) as float64 tensors
        on the model's device, copied once after a fit."""
        if getattr(self, "_tables", None) is None:
            dev = self._device()
            self._tables = tuple(torch.as_tensor(np.asarray(a, np.float64), device=dev) for a in (
                self.U, self.I, self.UA, self.IA, self.item_aspect_quality.toarray()))
        return self._tables

    def score(self, u_idx, i_idx=None):
        if self.is_unknown_user(u_idx):
            raise ScoreException("Can't make score prediction for user %d" % u_idx)
        U, I = self._on_device()[:2]
        if i_idx is None:
            return (I @ U[u_idx]).cpu().numpy()
        if not self.knows_item(i_idx):
            raise ScoreException("Can't make score prediction for item %d" % i_idx)
        return float(I[i_idx] @ U[u_idx])

    def score_pairs(self, user_indices, item_indices):
        """``score(u, i)`` of every pair at once, on the device in float64;
        an unknown user or item takes ``default_score()``, as the loop's
        ScoreException does."""
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        U, I = self._on_device()[:2]
        u = torch.as_tensor(np.where(known, users, 0).astype(np.int64), device=U.device)
        i = torch.as_tensor(np.where(known, items, 0).astype(np.int64), device=U.device)
        preds = torch.sum(U[u] * I[i], 1).cpu().numpy()
        return np.where(known, preds, self.default_score())

    def _composite_scores(self, users):
        """The JAX package's rank() score, computed on the device in
        float64, as host numpy: alpha * the mean over the item's top aspects
        of (aspect score x quality) * rating_scale, plus (1 - alpha) * the
        rating score."""
        U, I, UA, IA, qual = self._on_device()
        u = torch.as_tensor(np.asarray(users, np.int64), device=U.device)
        base = U[u] @ I.T  # (B, n_items)
        if not (self.alpha > 0 and self.num_top_aspects > 0):
            return base.cpu().numpy()
        kta = min(self.num_top_aspects, self.num_aspects)
        item_part = I @ IA.T  # (n_items, n_aspects)
        out = torch.empty_like(base)
        for lo in range(0, len(users), COMPOSITE_USERS):
            b = slice(lo, lo + COMPOSITE_USERS)
            item_aspect = ((U[u[b]] @ UA.T)[:, None, :] + item_part[None]
                           + base[b][:, :, None])  # (users, n_items, n_aspects)
            top_scores, top_ids = torch.topk(item_aspect, kta, dim=2)
            top_qual = torch.gather(qual.expand(top_ids.shape[0], -1, -1), 2, top_ids)
            out[b] = (self.alpha * (top_scores * top_qual).mean(dim=2) * self.rating_scale
                      + (1 - self.alpha) * base[b])
        return out.cpu().numpy()

    def rank(self, user_idx, item_indices=None, k=-1, **kwargs):
        if not (self.alpha > 0 and self.num_top_aspects > 0):
            return super().rank(user_idx, item_indices, k, **kwargs)
        known_item_scores = self._composite_scores(np.asarray([user_idx]))[0]
        all_item_scores = np.ones(self.total_items) * np.min(known_item_scores)
        all_item_scores[: self.num_items] = known_item_scores
        item_indices = (
            np.arange(self.num_items)
            if item_indices is None
            else np.asarray(item_indices)
        )
        item_scores = all_item_scores[item_indices]
        if k != -1:
            partitioned_idx = np.argpartition(item_scores, -k)
            top_k_idx = partitioned_idx[-k:]
            sorted_top_k_idx = top_k_idx[np.argsort(item_scores[top_k_idx])]
            partitioned_idx[-k:] = sorted_top_k_idx
            ranked_items = item_indices[partitioned_idx[::-1]]
        else:
            ranked_items = item_indices[item_scores.argsort()[::-1]]
        return ranked_items, item_scores

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = self._composite_scores(np.where(known, users, 0))
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)
