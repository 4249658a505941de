"""C2PF — Collaborative Context Poisson Factorization (Salah & Lauw,
SIGIR 2017), variants ``c2pf``, ``tc2pf`` (tied) and ``rc2pf`` (reduced).

Port of ``cornac_tpu/models/c2pf.py``: coordinate-ascent variational
inference as dense Gamma-parameter tables, each sub-update a gather ->
normalise -> scatter-add over the rating edges (u, i, x) and the context
edges (i, j) of ``train_set.item_graph``. A fit is two phases of sweeps on
the model's device (``_c2pf_cavi``): ``max_iter`` sweeps with the item
influence kappa held off by a 1e15 prior, then ``0.2 * max_iter`` sweeps
with its real prior. Every scatter goes through the deterministic
``ops.accumulate.accumulate_rows`` (the hand-written kernel on the card),
Xi's included, so a seeded fit gives the same bits every time; no sweep
waits for the host. The initial tables are the JAX package's numpy Gamma
draws, bit for bit.

``recommend_batch`` keeps the JAX package's behaviour: it ranks by the
product of ``get_user_vectors()`` and ``get_item_vectors()``, which is
``Theta . Beta`` for ``c2pf`` and ``tc2pf`` (no Xi) and
``Theta . (Beta + Xi)`` for ``rc2pf`` (Beta added), not by ``score``'s
``Theta . (Beta + Xi)`` and ``Theta . Xi`` (ROADMAP.md C).

``mesh`` (``parallel.make_mesh``) splits both edge sets over "data" and
keeps the Gamma tables whole on every rank, as the JAX package does; the
per-edge rows are gathered back in edge order before each sum, so the
posterior keeps the single-device bits (``_c2pf_cavi``).
"""

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.dense_scores import device_dot, full_f32
from ..parallel.mesh import check_mesh
from ..parallel.sharded import data_parallel
from ..utils import get_rng
from .recommender import ANNMixin, MEASURE_DOT, Recommender

EPS = 2.0**-52
AA = 0.3  # the shared Gamma shape hyperparameter

_TABLES = ("G_s", "G_r", "L_s", "L_r", "L2_s", "L2_r", "l3_s", "l3_r", "T3_r")


def _exp_digamma(s, r):
    return torch.exp(torch.special.digamma(torch.clamp_min(s, EPS))
                     - torch.log(torch.clamp_min(r, EPS)))


def _scatter(rows, ids, values):
    """``zeros(rows, ...).at[ids].add(values)``, summed in batch order."""
    return accumulate_rows(values.new_zeros((rows,) + values.shape[1:]), ids, values)


def _c2pf_cavi(state, ru, ri, rx, ci, cj, util_sum, a_t, b_t, variant, n_iters, mesh=None):
    """``n_iters`` CAVI sweeps of one phase, as
    ``cornac_tpu/models/c2pf.py::_c2pf_cavi`` computes them on one device
    (its context-edge mask is all ones there). ``state``: dict of float32
    tensors G_s, G_r (users, k), L_s, L_r, L2_s, L2_r (items, k), l3_s,
    l3_r (context edges,), T3_r (items,); ru, ri, ci, cj int64, rx float32;
    ``a_t``, ``b_t`` the kappa prior. Returns the new state.

    ``mesh``: the state stays whole on every rank (replicated, as in the
    JAX package) and both edge sets are split over "data": each rank
    computes the per-edge rows of its slice of the rating and of the
    context edges, and the slices are gathered back in edge order before
    every sum (``data_parallel``), which keeps the single-device bits. The
    column sums over the edges (``ctx_mass``) run whole on every rank."""
    d = state["L2_s"].shape[0]
    use_beta = variant != "rc2pf"
    s = dict(state)
    n_r, n_c = ru.shape[0], ci.shape[0]

    def on_ratings(fn, *rows):
        return data_parallel(mesh, fn, n_r, ru, ri, *rows)

    def on_context(fn, *rows):
        return data_parallel(mesh, fn, n_c, ci, cj, *rows)

    def lb2_of(L2b, l3b):
        return _scatter(d, ci, on_context(lambda ci_, cj_, l3b_: L2b[cj_] * l3b_[:, None], l3b))

    for _ in range(n_iters):
        G_s, G_r = s["G_s"], s["G_r"]
        L_s, L_r = s["L_s"], s["L_r"]
        L2_s, L2_r = s["L2_s"], s["L2_r"]
        l3_s, l3_r, T3_r = s["l3_s"], s["l3_r"], s["T3_r"]

        Lt = _exp_digamma(G_s, G_r)
        Lb = _exp_digamma(L_s, L_r)
        if variant == "tc2pf":  # tied: the context factors are the item factors
            L2_s, L2_r = L_s, L_r
            L2b = Lb
        else:
            L2b = _exp_digamma(L2_s, L2_r)
        l3b = _exp_digamma(l3_s, l3_r)
        Lb2 = lb2_of(L2b, l3b)
        mix = (Lb + Lb2) if use_beta else Lb2

        def ratio():
            return on_ratings(lambda ru_, ri_, rx_: rx_ / ((Lt[ru_] * mix[ri_]).sum(1) + EPS), rx)

        def to_items(r_e):  # each rating's responsibility-weighted user row, summed by item
            return _scatter(d, ri, on_ratings(lambda ru_, ri_, r_: r_[:, None] * Lt[ru_], r_e))

        def context_rows(Lb_u):  # L2b[j] l3b Lb_u[i] of each context edge
            return on_context(lambda ci_, cj_, l3b_: L2b[cj_] * l3b_[:, None] * Lb_u[ci_], l3b)

        # --- kappa (item influence) ---------------------------------------
        r_e = ratio()
        Lb_u = to_items(r_e)
        l3_s = a_t + context_rows(Lb_u).sum(1)
        SkU = (G_s / torch.clamp_min(G_r, EPS)).sum(0)
        X2m = L2_s / torch.clamp_min(L2_r, EPS)
        with full_f32():
            Sj = X2m @ SkU
        if variant == "c2pf":
            l3_r = (a_t * (5.0 + a_t * util_sum[ci]) / torch.clamp_min(T3_r[ci], EPS)
                    + Sj[cj])
        else:  # tc2pf / rc2pf
            l3_r = b_t / torch.clamp_min(T3_r[ci], EPS) + Sj[cj]
        l3b = _exp_digamma(l3_s, l3_r)
        Lb2 = lb2_of(L2b, l3b)
        km = l3_s / torch.clamp_min(l3_r, EPS)
        if variant == "c2pf":
            T3_r = b_t + a_t * _scatter(d, ci, km)
        mix = (Lb + Lb2) if use_beta else Lb2

        # --- users ----------------------------------------------------------
        r_e = ratio()
        G_s = AA + Lt * _scatter(G_s.shape[0], ru, on_ratings(
            lambda ru_, ri_, r_: r_[:, None] * mix[ri_], r_e))
        ctx_mass = (X2m[cj] * km[:, None]).sum(0)
        if use_beta:
            g_rate = AA + (L_s / torch.clamp_min(L_r, EPS)).sum(0) + ctx_mass
        else:
            g_rate = AA + ctx_mass
        G_r = g_rate[None, :].expand(G_r.shape).contiguous()
        Lt = _exp_digamma(G_s, G_r)

        # --- items (beta) ---------------------------------------------------
        Tm_sum = (G_s / torch.clamp_min(G_r, EPS)).sum(0)
        if use_beta:
            r_e = ratio()
            L_s_new = AA + Lb * to_items(r_e)
            if variant == "tc2pf":
                # tied: the context contribution folds into the same table
                L_s_new = L_s_new + _scatter(d, cj, context_rows(to_items(r_e)))
                Sj_d = _scatter(d, cj, km)
                L_r = (AA + Tm_sum[None, :] * (1.0 + Sj_d[:, None])).expand(L_s.shape).contiguous()
            else:
                L_r = (AA + Tm_sum[None, :]).expand(L_s.shape).contiguous()
            L_s = L_s_new
            Lb = _exp_digamma(L_s, L_r)
            mix = Lb + Lb2

        # --- context (xi) ---------------------------------------------------
        if variant != "tc2pf":
            r_e = ratio()
            L2_s = AA + _scatter(d, cj, context_rows(to_items(r_e)))
            Sj_d2 = _scatter(d, cj, km)
            L2_r = (AA + Sj_d2[:, None] * Tm_sum[None, :]).expand(L2_s.shape).contiguous()
        else:
            L2_s, L2_r = L_s, L_r

        s = {"G_s": G_s, "G_r": G_r, "L_s": L_s, "L_r": L_r, "L2_s": L2_s, "L2_r": L2_r,
             "l3_s": l3_s, "l3_r": l3_r, "T3_r": T3_r}
    return s


class C2PF(Recommender, ANNMixin):
    """Context-aware Poisson factorization over an item graph.

    Parameters mirror the JAX package: ``k``, ``max_iter``, ``variant``
    (``"c2pf"``, ``"tc2pf"``, ``"rc2pf"``), ``seed``, ``init_params``
    ({'G_s', 'G_r', 'L_s', 'L_r', 'L2_s', 'L2_r', 'L3_s', 'L3_r', 'Theta',
    'Beta', 'Xi'}). The train set must carry the ``item_graph`` modality.
    ``device``: where the model trains and scores (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``, both
    edge sets are split over "data" and the posterior equals the
    single-device fit's (``_c2pf_cavi``).
    """

    def __init__(
        self,
        k=100,
        max_iter=100,
        variant="c2pf",
        name=None,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        if variant not in ("c2pf", "tc2pf", "rc2pf"):
            raise ValueError("variant must be one of c2pf, tc2pf, rc2pf")
        name = variant.upper() if name is None else name
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.k = k
        self.max_iter = max_iter
        self.variant = variant
        self.seed = seed
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device

        self.init_params = {} if init_params is None else init_params
        self.Theta = self.init_params.get("Theta", None)
        self.Beta = self.init_params.get("Beta", None)
        self.Xi = self.init_params.get("Xi", None)
        self.Gs = self.init_params.get("G_s", None)
        self.Gr = self.init_params.get("G_r", None)
        self.Ls = self.init_params.get("L_s", None)
        self.Lr = self.init_params.get("L_r", None)
        self.L2s = self.init_params.get("L2_s", None)
        self.L2r = self.init_params.get("L2_r", None)
        self.L3s = self.init_params.get("L3_s", None)
        self.L3r = self.init_params.get("L3_r", None)

    def _context_edges(self, train_set):
        """(gi, gj, gv) numpy: the item graph's edges between train items,
        or self loops over every item when there are none."""
        train_items = set(np.asarray(train_set.uir_tuple[1]).tolist())
        gi, gj, gv = train_set.item_graph.get_train_triplet(train_items, train_items)
        if len(gi) == 0:  # degenerate: no context edges
            gi = gj = np.arange(self.num_items)
            gv = np.ones(self.num_items)
        return gi, gj, gv

    def _initial_state(self, n_cedges):
        """The initial tables as float32 numpy, in the JAX package's order
        of draws: the given ones, else seeded Gamma(100, scale / 100)."""
        rng = get_rng(self.seed)
        n, d, k = self.num_users, self.num_items, self.k

        def tbl(existing, rows, scale=0.3):
            if existing is not None:
                return np.asarray(existing, np.float32)
            return rng.gamma(100, scale=scale / 100, size=(rows, k)).astype(np.float32)

        def edge_tbl(existing):
            if existing is not None:
                e = np.asarray(existing)
                return (e[:, 2] if e.ndim == 2 else e).astype(np.float32)
            return rng.gamma(100, scale=0.5 / 100, size=n_cedges).astype(np.float32)

        return {
            "G_s": tbl(self.Gs, n), "G_r": tbl(self.Gr, n),
            "L_s": tbl(self.Ls, d), "L_r": tbl(self.Lr, d),
            "L2_s": tbl(self.L2s, d), "L2_r": tbl(self.L2r, d),
            "l3_s": edge_tbl(self.L3s), "l3_r": edge_tbl(self.L3r),
            "T3_r": np.ones((d,), np.float32),
        }

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self
        if getattr(train_set, "item_graph", None) is None:
            raise ValueError("C2PF requires an item_graph modality")

        mesh = self.mesh
        dev = self._device()
        d = self.num_items
        u, i, x = train_set.uir_tuple
        ru, ri = (torch.as_tensor(np.asarray(a, np.int64), device=dev) for a in (u, i))
        rx = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        gi, gj, gv = self._context_edges(train_set)
        ci, cj = (torch.as_tensor(np.asarray(a, np.int64), device=dev) for a in (gi, gj))
        util_sum = np.zeros(d, np.float32)
        np.add.at(util_sum, np.asarray(gj, np.int64), np.asarray(gv, np.float32))
        util_sum = torch.as_tensor(util_sum, device=dev)

        state = {name: torch.as_tensor(a, device=dev)
                 for name, a in self._initial_state(len(gi)).items()}
        # phase 1: kappa held off by an enormous prior
        state = _c2pf_cavi(state, ru, ri, rx, ci, cj, util_sum, 1e15, 1e15, self.variant,
                           self.max_iter, mesh)
        # phase 2: the real kappa prior, 0.2 * max_iter refinement sweeps
        bt = 5.0 if self.variant == "c2pf" else 4.0
        state = _c2pf_cavi(state, ru, ri, rx, ci, cj, util_sum, 2.0, bt, self.variant,
                           max(1, int(0.2 * self.max_iter)), mesh)

        km = state["l3_s"] / torch.clamp_min(state["l3_r"], EPS)
        X2m = state["L2_s"] / torch.clamp_min(state["L2_r"], EPS)
        Xi = _scatter(d, ci, km[:, None] * X2m[cj])
        host = {name: t.cpu().numpy() for name, t in state.items()}
        self.Gs, self.Gr = host["G_s"], host["G_r"]
        self.Ls, self.Lr = host["L_s"], host["L_r"]
        self.L2s, self.L2r = host["L2_s"], host["L2_r"]
        self.L3s, self.L3r = host["l3_s"], host["l3_r"]
        self.Theta = self.Gs / np.maximum(self.Gr, EPS)
        self.Beta = self.Ls / np.maximum(self.Lr, EPS)
        self.Xi = Xi.cpu().numpy()
        return self

    def _item_table(self):
        if self.variant == "rc2pf":
            return self.Xi
        return self.Beta + self.Xi

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        tbl = self._item_table()
        if item_idx is None:
            return (tbl @ self.Theta[user_idx]).astype(np.float64)
        if self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        return float(tbl[item_idx] @ self.Theta[user_idx])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        scores = (self.Theta[np.where(known, users, 0)] @ self._item_table().T).astype(np.float64)
        scores[~known] = self.default_score()
        total = self.total_items
        if scores.shape[1] < total:
            out = np.broadcast_to(scores.min(axis=1, keepdims=True),
                                  (scores.shape[0], total)).copy()
            out[:, : scores.shape[1]] = scores
            return out
        return scores

    def _known_scores_device(self, safe_users, known):
        return device_dot(self.Theta[safe_users], self._item_table(), self._device())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        if self.variant == "rc2pf":
            return np.concatenate((self.Theta, self.Theta), axis=1)
        return self.Theta

    def get_item_vectors(self):
        if self.variant == "rc2pf":
            return np.concatenate((self.Beta, self.Xi), axis=1)
        return self.Beta
