"""FM — Factorization Machines (Rendle, 2012).

Port of ``cornac_tpu/models/fm.py``. With the user/item one-hot design
matrix the FM prediction reduces to

    y(u, i) = k0*w0 + k1*(w_u + w_i) + k2 * <v_u, v_i>

over one feature table of ``num_users + num_items`` rows (items offset by
``num_users``). Every learner runs on the model's device:

- ``sgd``/``sgda``: minibatch SGD epochs (``_fm_sgd_epoch``) on a
  permutation each epoch draws from its own generator
  (``utils.checkpoint.epoch_generator``); the ``w`` and ``V`` updates are
  summed by the deterministic ``ops.accumulate.accumulate_rows``.
- ``als``: coordinate ALS sweeps (``_fm_als``) whose per-feature sums are
  ``_seg_sum``, as the JAX package writes it: one gather by the stable
  permutation of the ids, a float32 cumulative sum, and a difference at
  the segment boundaries. The cumulative sum runs in blocks whose order of
  additions is fixed (``_cumsum_rows``), so a fit is the same bits every
  time on either device, and is held to JAX's.
- ``mcmc``: the Gibbs sampler (``_fm_mcmc_sweep``, libFM
  ``fm_learn_mcmc.h`` semantics, see the JAX package's ``_fm_mcmc``); a
  sweep takes its gamma and normal draws as arguments (``McmcDraws``),
  which the fit draws from the sweep's generator.

Scoring (``_predict``, ``score``, ``score_batch``, ``score_pairs``) is the
JAX package's host numpy code over the fitted tables.
"""

import functools
from collections import namedtuple

import numpy as np
import torch

from ..exception import ScoreException
from ..ops.accumulate import accumulate_rows
from ..parallel.mesh import check_mesh, shard_tables
from ..parallel.sharded import (
    data_parallel,
    gather_shards,
    local_shard,
    row_shard_lookup,
    row_shard_scatter_add,
)
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from ..utils.init_utils import normal, zeros
from .recommender import Recommender, pad_to_catalog


def _clip(g):
    # the summed batch gradients are clipped, as in the JAX package: its
    # batched sum can compound where the reference's per-sample steps
    # self-correct; inactive at the golden scales
    return torch.clamp(g, -10.0, 10.0)


def _fm_sgd_rows(wu, wi, Vu, Vi, w0, r, m, reg1, reg2, use_w0, use_w, use_v):
    """The row-wise part of a minibatch (or of a data slice of one) from its
    fetched rows: (the errors, the clipped ``w`` steps of u then i, the
    clipped ``V`` steps of u then i) before the learning rate."""
    pred = torch.zeros_like(r)
    if use_w0:
        pred = pred + w0
    if use_w:
        pred = pred + wu + wi
    if use_v:
        pred = pred + (Vu * Vi).sum(1)
    e_ = (pred - r) * m
    dw = torch.cat([e_ + reg1 * wu * m, e_ + reg1 * wi * m])
    dV = torch.cat([e_[:, None] * Vi + reg2 * Vu * m[:, None],
                    e_[:, None] * Vu + reg2 * Vi * m[:, None]])
    return e_, _clip(dw).view(2, -1).T, _clip(dV).view(2, -1, Vu.shape[1]).transpose(0, 1)


def _fm_sgd_epoch(w0, w, V, perm, rid, cid_off, val, pad_mask, lr, regs, batch_size, use_w0,
                  use_w, use_v, mesh=None):
    """One SGD epoch, as an epoch of ``cornac_tpu/models/fm.py::_fm_sgd``:
    ``perm`` (n_total,) int64 holds the epoch's case indices (the JAX
    package draws ``permutation(fold_in(key, e), n_total) % n``),
    ``pad_mask`` (n_total,) float32 is 0 on the positions past n. w0 is a
    0-d float32 tensor, w (n_feat,) and V (n_feat, k2) float32, updated in
    place. Returns (w0, w, V, the epoch's summed squared error).

    ``mesh``: w and V are this rank's row shards over "model"; each rank
    computes the rows of its data slice of a minibatch from rows fetched
    with ``row_shard_lookup``, the rows are gathered back in batch order
    (``data_parallel``), w0 steps on the whole batch's error sum, and the
    rows are added on the ranks that own them: the single-device bits."""
    reg0, reg1, reg2 = regs
    if mesh is None:
        lookup, scatter = (lambda t, ids: t[ids]), accumulate_rows
    else:
        lookup = functools.partial(row_shard_lookup, mesh)
        scatter = functools.partial(row_shard_scatter_add, mesh)

    def rows(u, i, r, m):
        wui = lookup(w, torch.cat([u, i]))
        Vui = lookup(V, torch.cat([u, i]))
        return _fm_sgd_rows(*wui.chunk(2), *Vui.chunk(2), w0, r, m, reg1, reg2, use_w0, use_w,
                            use_v)

    loss = torch.zeros((), dtype=torch.float32, device=w.device)
    for start in range(0, perm.shape[0], batch_size):
        idx = perm[start : start + batch_size]
        m = pad_mask[start : start + batch_size]
        u, i, r = rid[idx], cid_off[idx], val[idx]
        e_, dw, dV = data_parallel(mesh, rows, idx.shape[0], u, i, r, m)
        loss = loss + (e_ * e_).sum()
        if use_w0:
            w0 = w0 - lr * _clip(e_.sum() + reg0 * w0)
        ui = torch.cat([u, i])
        if use_w:
            scatter(w, ui, -lr * dw.T.reshape(-1))
        if use_v:
            scatter(V, ui, -lr * dV.transpose(0, 1).reshape(-1, dV.shape[2]))
    return w0, w, V, loss


SCAN_BLOCK = 1024  # rows a block of the cumulative sum scans at once


def _row_scans(x):
    """Inclusive cumulative sums along the last dimension of a 2-D tensor,
    one row at a time: on the card PyTorch scans each row of a tensor with
    two or more rows in one block in a fixed order, while a tensor that is
    one row is scanned by CUB's look-back, whose order of additions (and so
    its float32 rounding) changes from run to run."""
    if x.shape[0] == 1:
        return torch.cat([x, torch.zeros_like(x)]).cumsum(1)[:1]
    return x.cumsum(1)


def _cumsum_rows(x):
    """The float32 cumulative sum of x (n, C) down its rows, in an order of
    additions fixed on either device: the rows in blocks of ``SCAN_BLOCK``,
    each block scanned, then the blocks' totals scanned and added to the
    blocks after them. (A scan down a column of a 2-D tensor runs one
    thread a column on the card, tens of ms at 80,000 rows.)"""
    n, C = x.shape
    nb = -(-n // SCAN_BLOCK)
    xt = torch.nn.functional.pad(x.T, (0, nb * SCAN_BLOCK - n))  # (C, nb * block)
    inner = _row_scans(xt.reshape(C * nb, SCAN_BLOCK)).view(C, nb, SCAN_BLOCK)
    totals = _row_scans(inner[:, :, -1])
    before = torch.nn.functional.pad(totals[:, :-1], (1, 0))  # the blocks before each
    return (inner + before[:, :, None]).view(C, nb * SCAN_BLOCK)[:, :n].T


def _seg_sum(x, perm, starts, ends):
    """Segment sums over the columns of x (n, C), as the JAX package's
    ``_seg_sum``: the rows gathered once in the stable order of their
    feature ids, a float32 cumulative sum (``_cumsum_rows``), and the
    difference of the sums at each feature's segment boundaries."""
    xp = x[perm]
    c = torch.cat([xp.new_zeros((1, xp.shape[1])), _cumsum_rows(xp)])
    return c[ends] - c[starts]  # (n_feat, C)


Block = namedtuple("Block", "ids perm starts ends cnt")
Block.__doc__ = """One feature block (the users, or the items) of the cases:
each case's feature id, the stable sort permutation of the ids, each
feature's segment [starts, ends) in that order, and its case count."""


def make_blocks(rid, cid_off, n_feat, device):
    """The two ``Block``s of the user and item ids (numpy), on ``device``."""
    blocks = []
    feats = np.arange(n_feat)
    for idx_arr in (rid, cid_off):
        idx_arr = np.asarray(idx_arr, np.int64)
        perm = np.argsort(idx_arr, kind="stable")
        sorted_ids = idx_arr[perm]
        blocks.append(Block(*(torch.as_tensor(a, device=device) for a in (
            idx_arr, perm, np.searchsorted(sorted_ids, feats),
            np.searchsorted(sorted_ids, feats, side="right"),
            np.bincount(idx_arr, minlength=n_feat).astype(np.float32)))))
    return blocks


def _predict_cases(w0, w, V, rid, cid, val, use_w0, use_w, use_v):
    p = torch.zeros_like(val)
    if use_w0:
        p = p + w0
    if use_w:
        p = p + w[rid] + w[cid]
    if use_v:
        p = p + (V[rid] * V[cid]).sum(1)
    return p


def _fm_als(w0, w, V, val, blocks, reg0, reg1, reg2, use_w0, use_w, use_v, n_sweeps):
    """``n_sweeps`` FM-ALS sweeps, as ``cornac_tpu/models/fm.py::_fm_als``
    (libFM fm_learn_als on the two-block design): the error is recomputed
    each sweep and kept up to date across the coordinate steps. w0 a 0-d
    tensor, w (n_feat,), V (n_feat, k2), val (n,) float32; V is updated in
    place. Returns (w0, w, V)."""
    n = val.shape[0]
    rid, cid = blocks[0].ids, blocks[1].ids
    for _ in range(n_sweeps):
        err = val - _predict_cases(w0, w, V, rid, cid, val, use_w0, use_w, use_v)
        if use_w0:
            w0_new = (err + w0).sum() / (n + reg0)
            err = err + (w0 - w0_new)
            w0 = w0_new
        if use_w:
            for b in blocks:
                num = _seg_sum((err + w[b.ids])[:, None], b.perm, b.starts, b.ends)[:, 0]
                w_new = torch.where(b.cnt > 0, num / (b.cnt + reg1), w)
                err = err - (w_new[b.ids] - w[b.ids])
                w = w_new
        if use_v:
            for b, other in zip(blocks, (cid, rid)):
                for f in range(V.shape[1]):
                    vf = V[:, f]
                    h = vf[other]
                    e_f = err + vf[b.ids] * h
                    nd = _seg_sum(torch.stack([e_f * h, h * h], 1), b.perm, b.starts, b.ends)
                    num, den = nd[:, 0], nd[:, 1]
                    vf_new = torch.where(den > 0, num / (den + reg2), vf)
                    err = err - (vf_new[b.ids] - vf[b.ids]) * h
                    V[:, f] = vf_new
    return w0, w, V


McmcDraws = namedtuple("McmcDraws", "g_alpha z_w0 g_w_lambda z_w_mu z_w g_v_lambda z_v_mu z_v")
McmcDraws.__doc__ = """One Gibbs sweep's random draws: the standard gamma
draws (scale 1) of alpha, of w's precision and of V's precision (0-d, each
at the shape of its conditional), and the standard normal draws of w0 and
w's mean (0-d), of the two blocks' w (2, n_feat), of V's means (k2,), and
of the two blocks' factors (k2, 2, n_feat). The JAX package draws each from
``fold_in(fold_in(key, sweep), slot)`` (``_fm_mcmc``)."""


def mcmc_shapes(n, n_feat):
    """The gamma shapes of (alpha, w's precision, V's precision) for n
    cases and n_feat features, at the libFM priors alpha_0 = 1."""
    alpha_0 = 1.0
    return (alpha_0 + n) / 2.0, (alpha_0 + n_feat + 1) / 2.0, (alpha_0 + n_feat + 1) / 2.0


def draw_mcmc(gen, n, n_feat, k2, device):
    """A sweep's ``McmcDraws`` from the generator ``gen`` on ``device``."""
    shapes = torch.empty(3, device=device)
    for slot, shape in enumerate(mcmc_shapes(n, n_feat)):
        shapes[slot] = shape  # a fill on the device: no copy from the host
    g = torch._standard_gamma(shapes, generator=gen)

    def z(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return McmcDraws(g[0], z(), g[1], z(), z(2, n_feat), g[2], z(k2), z(k2, 2, n_feat))


def _fm_mcmc_sweep(state, draws, val, blocks, reg0, use_w0, use_w, use_v, n_feat):
    """One Bayesian FM Gibbs sweep, as a sweep of
    ``cornac_tpu/models/fm.py::_fm_mcmc`` (libFM ``fm_learn_mcmc.h`` with
    ``do_sample=do_multilevel=True`` on the user/item one-hot design): the
    two blocks' features have disjoint supports, so each block's draw is
    one vectorised draw, the factor loop sequential. ``state`` is (w0, w,
    V, alpha, w_mu, w_lambda, v_mu, v_lambda); ``draws`` the sweep's
    ``McmcDraws``. Returns the new state."""
    w0, w, V, alpha, w_mu, w_lambda, v_mu, v_lambda = state
    n = val.shape[0]
    k2 = V.shape[1]
    alpha_0 = gamma_0 = beta_0 = 1.0
    mu_0 = 0.0
    rid, cid = blocks[0].ids, blocks[1].ids
    # e follows libFM's sign: prediction - target, fresh each sweep
    e = _predict_cases(w0, w, V, rid, cid, val, use_w0, use_w, use_v) - val

    # noise precision: alpha | e ~ Gamma((a0 + n) / 2, (g0 + SSE) / 2)
    alpha = draws.g_alpha / ((gamma_0 + (e * e).sum()) / 2.0)

    if use_w0:
        mean_raw = e.sum() - n * w0
        sigma2 = 1.0 / (reg0 + alpha * n)
        mean = -sigma2 * (alpha * mean_raw - mu_0 * reg0)
        w0_new = mean + torch.sqrt(sigma2) * draws.z_w0
        e = e + (w0_new - w0)
        w0 = w0_new

    if use_w:
        # lambda with the old mu, then mu with the new lambda (libFM order)
        g = beta_0 * (w_mu - mu_0) ** 2 + gamma_0 + ((w - w_mu) ** 2).sum()
        w_lambda = draws.g_w_lambda / (g / 2.0)
        mu_mean = (w.sum() + beta_0 * mu_0) / (n_feat + beta_0)
        w_mu = mu_mean + torch.sqrt(1.0 / ((n_feat + beta_0) * w_lambda)) * draws.z_w_mu
        for j, b in enumerate(blocks):
            S_e = _seg_sum(e[:, None], b.perm, b.starts, b.ends)[:, 0]
            mean_raw = S_e - b.cnt * w
            sigma2 = 1.0 / (w_lambda + alpha * b.cnt)
            mean = -sigma2 * (alpha * mean_raw - w_mu * w_lambda)
            draw = mean + torch.sqrt(sigma2) * draws.z_w[j]
            w_new = torch.where(b.cnt > 0, draw, w)
            e = e + (w_new - w)[b.ids]
            w = w_new

    if use_v:
        g_f = beta_0 * (v_mu - mu_0) ** 2 + gamma_0 + ((V - v_mu[None, :]) ** 2).sum(0)
        # one gamma draw shared by the k2 factors, as the JAX package draws it
        v_lambda = draws.g_v_lambda / (g_f / 2.0)
        mu_mean = (V.sum(0) + beta_0 * mu_0) / (n_feat + beta_0)
        v_mu = mu_mean + torch.sqrt(1.0 / ((n_feat + beta_0) * v_lambda)) * draws.z_v_mu
        V = V.clone()
        for f in range(k2):
            vf = V[:, f]
            lam_f, mu_f = v_lambda[f], v_mu[f]
            for j, (b, other) in enumerate(zip(blocks, (cid, rid))):
                h = vf[other]
                nd = _seg_sum(torch.stack([h * e, h * h], 1), b.perm, b.starts, b.ends)
                S_he, S_h2 = nd[:, 0], nd[:, 1]
                mean_raw = S_he - vf * S_h2
                sigma2 = 1.0 / (lam_f + alpha * S_h2)
                mean = -sigma2 * (alpha * mean_raw - mu_f * lam_f)
                draw = mean + torch.sqrt(sigma2) * draws.z_v[f, j]
                vf_new = torch.where(b.cnt > 0, draw, vf)
                e = e + (vf_new - vf)[b.ids] * h
                vf = vf_new
            V[:, f] = vf

    return w0, w, V, alpha, w_mu, w_lambda, v_mu, v_lambda


def mcmc_initial_state(w0, w, V, reg1, reg2):
    """The sampler's state before the first sweep: the tables, alpha = 1,
    w_mu = 0, w_lambda = max(reg1, 1e-8), v_mu = 0, v_lambda = max(reg2,
    1e-8) per factor (``fm_learn_mcmc.h:1310``, ``backend_libfm.pyx:223``)."""
    k2 = V.shape[1]
    f32 = dict(dtype=torch.float32, device=V.device)
    return (w0, w, V, torch.tensor(1.0, **f32), torch.tensor(0.0, **f32),
            torch.tensor(max(float(np.float32(reg1)), 1e-8), **f32), torch.zeros(k2, **f32),
            torch.full((k2,), max(float(np.float32(reg2)), 1e-8), **f32))


class FM(Recommender):
    """Factorization machine over user+item one-hot features.

    Parameters mirror the JAX package: ``k0``, ``k1``, ``k2``,
    ``max_iter``, ``learning_rate``, ``reg0``, ``reg1``, ``reg2``
    (``reg_all`` replaces the three when nonzero), ``init_stdev``,
    ``method`` ('sgd', 'sgda', 'als', 'mcmc'), ``batch_size``,
    ``init_params`` ({'w0', 'w', 'V'}), ``seed``. ``device``: where the
    model trains (default: the card). ``mesh``: a ``parallel.make_mesh``
    mesh; every rank calls ``fit``. The SGD learners row-shard ``w`` and
    ``V`` over "model" and split each minibatch over "data", and their
    factors equal the single-device fit's (``_fm_sgd_epoch``); ``als`` and
    ``mcmc`` accept the mesh and do not use it, as in the JAX package.
    """

    def __init__(
        self,
        name="FM",
        k0=1,
        k1=1,
        k2=8,
        max_iter=100,
        learning_rate=0.01,
        reg0=0.0,
        reg1=0.0,
        reg2=0.0,
        reg_all=0.0,
        init_stdev=0.1,
        method="mcmc",
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=True,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = device
        self.num_threads = num_threads  # the JAX package's OpenMP knob, accepted and unused
        self.k0 = k0
        self.k1 = k1
        self.k2 = k2
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.reg_all = reg_all  # stored so clone() round-trips the signature
        self.reg0 = reg_all if reg_all != 0.0 else reg0
        self.reg1 = reg_all if reg_all != 0.0 else reg1
        self.reg2 = reg_all if reg_all != 0.0 else reg2
        self.init_stdev = init_stdev
        self.method = method.lower()
        self.batch_size = batch_size
        self.seed = seed

        if self.method not in ("sgd", "sgda", "als", "mcmc"):
            raise ValueError("Unknown method: {}".format(method))

        self.init_params = {} if init_params is None else init_params
        self.w0 = self.init_params.get("w0", None)
        self.w = self.init_params.get("w", None)
        self.V = self.init_params.get("V", None)

    def _flags(self):
        return dict(use_w0=self.k0 > 0, use_w=self.k1 > 0, use_v=self.k2 > 0)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        rng = get_rng(self.seed)
        n_feat = self.num_users + self.num_items
        if self.w0 is None:
            self.w0 = 0.0
        if self.w is None:
            self.w = zeros(n_feat, dtype=np.float32)
        if self.V is None:
            self.V = normal((n_feat, max(self.k2, 1)), std=self.init_stdev, random_state=rng,
                            dtype=np.float32)
        if not self.trainable:
            return self

        mesh = self.mesh if self.method in ("sgd", "sgda") else None
        dev = self._device()
        rid, cid, val = train_set.uir_tuple
        cid_off = np.asarray(cid, np.int64) + self.num_users  # the item block's offset
        f32 = [torch.tensor(np.asarray(a, np.float32), device=dev)
               for a in (self.w0, self.w, self.V, val)]
        w0, w, V, val_d = f32
        regs = tuple(float(np.float32(r)) for r in (self.reg0, self.reg1, self.reg2))

        if self.method in ("als", "mcmc"):
            blocks = make_blocks(rid, cid_off, n_feat, dev)
            if self.method == "als":
                w0, w, V = _fm_als(w0, w, V, val_d, blocks, *regs, n_sweeps=self.max_iter,
                                   **self._flags())
            else:
                seed = int(rng.randint(2**31))
                state = mcmc_initial_state(w0, w, V, regs[1], regs[2])
                for s in range(self.max_iter):
                    draws = draw_mcmc(epoch_generator(seed, s, dev), len(val), n_feat,
                                      V.shape[1], dev)
                    state = _fm_mcmc_sweep(state, draws, val_d, blocks, regs[0],
                                           n_feat=n_feat, **self._flags())
                w0, w, V = state[:3]
            self.w0 = float(w0)
            self.w = w.cpu().numpy().astype(np.float64)
            self.V = V.cpu().numpy().astype(np.float64)
            return self

        n = len(rid)
        batch_size = min(self.batch_size, n)
        n_total = n + (-n) % batch_size
        seed = int(rng.randint(2**31))
        rid_d = torch.as_tensor(np.asarray(rid, np.int64), device=dev)
        cid_d = torch.as_tensor(cid_off, device=dev)
        pad_mask = (torch.arange(n_total, device=dev) < n).to(torch.float32)
        lr = float(np.float32(self.learning_rate))
        if mesh is not None:
            w_local, V_local = (local_shard(t) for t in shard_tables(mesh, w, V))
        else:
            w_local, V_local = w, V
        for e in range(self.max_iter):
            perm = torch.randperm(n_total, generator=epoch_generator(seed, e, dev),
                                  device=dev) % n
            w0, _, _, _ = _fm_sgd_epoch(w0, w_local, V_local, perm, rid_d, cid_d, val_d, pad_mask,
                                        lr, regs, batch_size, **self._flags(), mesh=mesh)
        if mesh is not None:
            w, V = gather_shards(mesh, w_local)[:n_feat], gather_shards(mesh, V_local)[:n_feat]
        self.w0 = float(w0)
        self.w = w.cpu().numpy()
        self.V = V.cpu().numpy()
        return self

    def _predict(self, users, items):
        users = np.asarray(users)
        items_off = np.asarray(items) + self.num_users
        pred = np.zeros(len(users))
        if self.k0:
            pred += self.w0
        if self.k1:
            pred += self.w[users] + self.w[items_off]
        if self.k2:
            pred += np.sum(self.V[users] * self.V[items_off], axis=1)
        return pred

    def score(self, user_idx, item_idx=None):
        if self.is_unknown_user(user_idx):
            raise ScoreException("Can't make score prediction for user %d" % user_idx)
        if item_idx is not None and self.is_unknown_item(item_idx):
            raise ScoreException("Can't make score prediction for item %d" % item_idx)
        if item_idx is None:
            return self._predict(np.full(self.num_items, user_idx), np.arange(self.num_items))
        return float(self._predict([user_idx], [item_idx])[0])

    def score_batch(self, user_indices):
        users = np.asarray(user_indices)
        known = (users >= 0) & (users < self.num_users)
        safe = np.where(known, users, 0)
        items = slice(self.num_users, self.num_users + self.num_items)
        scores = np.zeros((len(users), self.num_items))
        if self.k0:
            scores += self.w0
        if self.k1:
            scores += self.w[safe][:, None] + self.w[items][None, :]
        if self.k2:
            scores += self.V[safe] @ self.V[items].T
        scores[~known] = self.default_score()
        return pad_to_catalog(scores, self.total_items)

    def score_pairs(self, user_indices, item_indices):
        users = np.asarray(user_indices)
        items = np.asarray(item_indices)
        known = ((users >= 0) & (users < self.num_users)
                 & (items >= 0) & (items < self.num_items))
        preds = self._predict(np.where(known, users, 0), np.where(known, items, 0))
        return np.where(known, preds, self.default_score())
