"""HPF — (Hierarchical) Poisson Factorization (Gopalan et al., UAI 2015).

Port of ``cornac_tpu/models/hpf.py``: coordinate-ascent variational
inference as dense Gamma-parameter tables and, per sweep, a gather of the
two tables' expectations at every rating, the multinomial
responsibilities, and their scatter-add into the user and into the item
shape tables. The whole ``max_iter`` loop is one function of sweeps on the
model's device (``_hpf_cavi``); both scatters go through the deterministic
``ops.accumulate.accumulate_rows`` (the hand-written kernel on the card),
so a seeded fit gives the same bits at any size, and no sweep waits for
the host. ``hierarchical=False`` is plain Poisson factorization (PF). The
initial tables are the JAX package's numpy Gamma draws, bit for bit.
"""

import functools

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..ops.dense_scores import device_dot
from ..parallel.mesh import check_mesh
from ..parallel.sharded import data_parallel
from ..utils import get_rng
from ..utils.init_utils import gamma as gamma_init
from .recommender import ANNMixin, MEASURE_DOT, Recommender, pad_to_catalog

EPS = 2.0**-52


def _responsibilities(Lt, Lb, rid, cid, val):
    """Each rating's share of its value over the k components."""
    p = Lt[rid] * Lb[cid]
    return p * (val / (p.sum(1) + EPS))[:, None]


def _kappa_update(S, R, shape_hyper, rate_hyper):
    return shape_hyper / rate_hyper + (S / torch.clamp_min(R, EPS)).sum(1)


def _hpf_cavi(G_s, G_r, L_s, L_r, K_r, T_r, rid, cid, val, n_iters, hierarchical, mesh=None):
    """``n_iters`` CAVI sweeps, as ``cornac_tpu/models/hpf.py::_hpf_cavi``,
    on the device tensors given: the float32 tables G_* (num_users, k),
    L_* (num_items, k), K_r (num_users,), T_r (num_items,); rid, cid int64
    and val float32 (|R|,). Returns the new (G_s, G_r, L_s, L_r, K_r, T_r).
    The hierarchical rates are refreshed once before the first sweep, as
    the JAX function does: a fit calls this once.

    ``mesh``: the tables stay whole on every rank (the variational state is
    replicated, as in the JAX package) and the rating edges are split over
    "data": each rank computes the responsibilities of its slice of the
    edges, and the slices are gathered back in edge order before the two
    sums (``data_parallel``), which keeps the single-device bits."""
    if hierarchical:
        a_, b_, c_ = 0.3, 0.3, 1.0
        k_dim = G_s.shape[1]
        k_s = a_ + k_dim * a_
        t_s = b_ + k_dim * b_
        K_r = _kappa_update(G_s, G_r, a_, c_)
        T_r = _kappa_update(L_s, L_r, b_, c_)
    else:
        a_, b_, c_ = 0.3, 1.0, 0.3
        k_s, t_s = a_, c_
    item_shape = b_ if hierarchical else c_

    for _ in range(n_iters):
        # E[exp(log theta)] and E[exp(log beta)]
        Lt = torch.exp(torch.special.digamma(G_s) - torch.log(torch.clamp_min(G_r, EPS)))
        Lb = torch.exp(torch.special.digamma(L_s) - torch.log(torch.clamp_min(L_r, EPS)))

        # per-rating multinomial responsibilities, (nnz, k)
        contrib = data_parallel(mesh, functools.partial(_responsibilities, Lt, Lb),
                                val.shape[0], rid, cid, val)

        G_s = accumulate_rows(torch.full_like(G_s, a_), rid, contrib)
        G_r = (k_s / K_r)[:, None] + (L_s / torch.clamp_min(L_r, EPS)).sum(0)[None, :]
        if hierarchical:
            K_r = _kappa_update(G_s, G_r, a_, c_)

        L_s = accumulate_rows(torch.full_like(L_s, item_shape), cid, contrib)
        del contrib
        L_r = (t_s / T_r)[:, None] + (G_s / torch.clamp_min(G_r, EPS)).sum(0)[None, :]
        if hierarchical:
            T_r = _kappa_update(L_s, L_r, b_, c_)

    return G_s, G_r, L_s, L_r, K_r, T_r


class HPF(Recommender, ANNMixin):
    """Poisson factorization by whole-loop CAVI on the device.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``hierarchical`` (False: PF), ``seed``, ``init_params``
    ({'Theta', 'Beta', 'G_s', 'G_r', 'L_s', 'L_r'}). ``device``: where the
    model trains and scores (default: the card). ``mesh``: a
    ``parallel.make_mesh`` mesh; every rank calls ``fit``, the rating edges
    are split over "data" and the posterior equals the single-device fit's
    (``_hpf_cavi``).
    """

    def __init__(
        self,
        k=5,
        max_iter=100,
        name="HPF",
        trainable=True,
        verbose=False,
        hierarchical=True,
        seed=None,
        init_params=None,
        mesh=None,
        device=None,
    ):
        Recommender.__init__(self, name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.k = k
        self.max_iter = max_iter
        self.hierarchical = hierarchical
        self.seed = seed

        self.init_params = {} if init_params is None else init_params
        self.Theta = self.init_params.get("Theta", None)
        self.Beta = self.init_params.get("Beta", None)
        self.Gs = self.init_params.get("G_s", None)
        self.Gr = self.init_params.get("G_r", None)
        self.Ls = self.init_params.get("L_s", None)
        self.Lr = self.init_params.get("L_r", None)

    def _initial_tables(self):
        """(G_s, G_r, L_s, L_r) as float64 numpy: the given ones, else the
        seeded Gamma draws, in the JAX package's order."""
        rng = get_rng(self.seed)
        a_, b_ = (0.3, 0.3) if self.hierarchical else (0.3, 1.0)

        def init_tbl(existing, rows):
            if existing is not None:
                return np.asarray(existing, dtype=np.float64)
            return gamma_init((rows, self.k), shape_param=a_, scale_param=b_ / a_,
                              random_state=rng, dtype=np.float64)

        return (init_tbl(self.Gs, self.num_users), init_tbl(self.Gr, self.num_users),
                init_tbl(self.Ls, self.num_items), init_tbl(self.Lr, self.num_items))

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        if not self.trainable:
            return self

        dev = self._device()
        tables = [torch.tensor(np.asarray(t, np.float32), device=dev)
                  for t in self._initial_tables()]
        tables += [torch.ones(self.num_users, device=dev), torch.ones(self.num_items, device=dev)]
        rid, cid, val = train_set.uir_tuple
        edges = [torch.as_tensor(np.asarray(rid, np.int64), device=dev),
                 torch.as_tensor(np.asarray(cid, np.int64), device=dev),
                 torch.as_tensor(np.asarray(val, np.float32), device=dev)]
        G_s, G_r, L_s, L_r, _, _ = _hpf_cavi(*tables, *edges, self.max_iter, self.hierarchical,
                                             self.mesh)

        self.Gs, self.Gr = G_s.cpu().numpy(), G_r.cpu().numpy()
        self.Ls, self.Lr = L_s.cpu().numpy(), L_r.cpu().numpy()
        self.Theta = self.Gs / np.maximum(self.Gr, 1e-12)
        self.Beta = self.Ls / np.maximum(self.Lr, 1e-12)
        return self

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if item_idx is None:
            return self.Beta @ self.Theta[user_idx]
        return self.Beta[item_idx] @ self.Theta[user_idx]

    def _known_scores_device(self, safe_users, known):
        return device_dot(self.Theta[safe_users], self.Beta, self._device())

    def score_batch(self, user_indices):
        scores = self.score_batch_device(user_indices).cpu().numpy().astype(np.float64)
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        preds = np.sum(self.Theta[np.where(known, users, 0)]
                       * self.Beta[np.where(known, items, 0)], axis=1)
        return np.where(known, preds, self.default_score())

    def get_vector_measure(self):
        return MEASURE_DOT

    def get_user_vectors(self):
        return self.Theta

    def get_item_vectors(self):
        return self.Beta
