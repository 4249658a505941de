"""FPMC — Factorized Personalized Markov Chains (Rendle et al., WWW 2010).

Port of ``cornac_tpu/models/fpmc.py``: the four-table factorization

    score(u, last, i) = <V_UI[u], V_IU[i]> + <V_IL[i], V_LI[last]>

trained over (user, previous item, next item) transitions. With
``loss='bpr'`` and no momentum the fit is the JAX package's per-sample SGD
epoch: each minibatch gathers its rows from the tables as they stood, then
scatters its six updates into V_UI, V_IU (positives, then negatives), V_LI
and V_IL (positives, then negatives) through ``accumulate_rows``, in the
JAX package's order, so duplicate rows sum in batch order and a seeded fit
gives the same bits on every run. Every other configuration is the general
path: the ``seq_utils.batch_loss`` family over ``[V_UI[u] | V_LI[last]] .
[V_IU[i] | V_IL[i]]`` with adagrad (``ops.optim.adagrad_m``) and, with
``model_selection='best'``, best-on-validation selection.

Draws (the epoch's transitions and negatives, or its permutation and
shared negatives) come from a ``torch.Generator`` keyed on (seed, epoch),
where the JAX package folds the epoch into its key: the same distributions,
another stream.
"""

import numpy as np
import torch

from ..ops.accumulate import accumulate_rows, gather_rows
from ..ops.optim import adagrad_m, step
from ..utils import get_rng
from ..utils.checkpoint import epoch_generator
from ..utils.init_utils import normal
from .recommender import NextItemRecommender
from .seq_utils import (
    SUPPORTED_LOSSES,
    batch_loss,
    neg_sampling_table,
    sample_negatives,
    val_score,
)

TABLES = ("V_UI", "V_IU", "V_IL", "V_LI")


def _fpmc_draws(generator, n, n_total, num_items, device):
    """One epoch's (transition index, negative item) draws, (n_total,)
    int64 each."""
    pos_idx = torch.randint(0, n, (n_total,), generator=generator, device=device)
    neg_items = torch.randint(0, num_items, (n_total,), generator=generator, device=device)
    return pos_idx, neg_items


def _fpmc_epoch(params, users, prevs, nexts, pos_idx, neg_items, n, lr, reg, batch_size):
    """One BPR epoch of per-sample SGD on given draws, updating the four
    tables of ``params`` in place. ``users``, ``prevs``, ``nexts``: (n,)
    int64 transitions; ``pos_idx``, ``neg_items``: (n_total,) draws, n_total
    a multiple of ``batch_size``; samples past n and negatives equal to the
    positive are skipped. Returns the epoch's loss sum (a device scalar)."""
    V_UI, V_IU, V_IL, V_LI = (params[name] for name in TABLES)
    n_total = pos_idx.shape[0]
    u, prev, pos = users[pos_idx], prevs[pos_idx], nexts[pos_idx]
    valid = (pos != neg_items) & (torch.arange(n_total, device=V_UI.device) < n)
    loss_sum = torch.zeros((), dtype=torch.float32, device=V_UI.device)
    for start in range(0, n_total, batch_size):
        sl = slice(start, start + batch_size)
        ub, pb, ib, jb = u[sl], prev[sl], pos[sl], neg_items[sl]
        mf = valid[sl].to(torch.float32)[:, None]
        vu, vl = V_UI[ub], V_LI[pb]
        vi_u, vj_u = V_IU[ib], V_IU[jb]
        vi_l, vj_l = V_IL[ib], V_IL[jb]
        x = torch.sum(vu * (vi_u - vj_u), dim=1) + torch.sum(vl * (vi_l - vj_l), dim=1)
        z = mf / (1.0 + torch.exp(x))[:, None]
        loss_sum += torch.sum(torch.log1p(torch.exp(-torch.abs(x))) * mf[:, 0])
        accumulate_rows(V_UI, ub, lr * (z * (vi_u - vj_u) - reg * vu * mf))
        accumulate_rows(V_IU, ib, lr * (z * vu - reg * vi_u * mf))
        accumulate_rows(V_IU, jb, lr * (-z * vu - reg * vj_u * mf))
        accumulate_rows(V_LI, pb, lr * (z * (vi_l - vj_l) - reg * vl * mf))
        accumulate_rows(V_IL, ib, lr * (z * vl - reg * vi_l * mf))
        accumulate_rows(V_IL, jb, lr * (-z * vl - reg * vj_l * mf))
    return loss_sum


def _general_loss(params, u, p, t, m, negs, loss_kind, reg, bpreg, elu_param):
    """The general path's loss on one minibatch of transitions (u, p, t)
    with mask m and shared negatives ``negs``."""
    vu = gather_rows(params["V_UI"], u)
    vl = gather_rows(params["V_LI"], p)
    state = torch.cat([vu, vl], dim=1)[:, None, :]
    out_emb = torch.cat([params["V_IU"], params["V_IL"]], dim=1)
    loss = batch_loss(loss_kind, state, out_emb, None, t[:, None], m[:, None], negs,
                      bpreg=bpreg, elu_param=elu_param)
    if reg > 0:
        loss = loss + reg * (torch.sum(vu**2 * m[:, None]) + torch.sum(vl**2 * m[:, None])
                             ) / torch.clamp(torch.sum(m), min=1.0)
    return loss


def _fpmc_scores(params, users, lasts, has_last):
    base = params["V_UI"][users] @ params["V_IU"].T
    trans = params["V_LI"][lasts] @ params["V_IL"].T
    return base + trans * has_last[:, None]


class FPMC(NextItemRecommender):
    """FPMC trained on the device.

    Parameters mirror the JAX package's: ``embedding_dim``, ``loss`` (bpr:
    the per-sample SGD epoch; the others: the ``batch_loss`` family),
    ``n_epochs``, ``learning_rate``, ``momentum``, ``n_sample``,
    ``sample_alpha``, ``lambda_reg``, ``bpreg``, ``elu_param``,
    ``model_selection`` ('last' or 'best' with ``val_eval_every``,
    ``val_k``, ``val_metric``), ``batch_size``, ``seed``. ``device``: where
    it trains and scores (default: the card; ``"cpu"`` asks for the CPU).
    """

    def __init__(
        self,
        name="FPMC",
        embedding_dim=32,
        loss="bpr",
        n_epochs=10,
        learning_rate=0.01,
        momentum=0.0,
        n_sample=2048,
        sample_alpha=0.5,
        lambda_reg=0.001,
        bpreg=1.0,
        elu_param=0.5,
        device=None,
        model_selection="last",
        val_eval_every=5,
        val_k=20,
        val_metric="recall",
        batch_size=1024,
        trainable=True,
        verbose=False,
        seed=None,
        mesh=None,
    ):
        super().__init__(name=name, trainable=trainable, verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8)")
        if loss not in SUPPORTED_LOSSES:
            raise ValueError(f"loss='{loss}' not supported; choose from {SUPPORTED_LOSSES}")
        if model_selection not in ("last", "best"):
            raise ValueError(
                f"model_selection='{model_selection}' not supported; choose 'last' or 'best'"
            )
        self.embedding_dim = embedding_dim
        self.loss = loss
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.n_sample = n_sample
        self.sample_alpha = sample_alpha
        self.lambda_reg = lambda_reg
        self.bpreg = bpreg
        self.elu_param = elu_param
        self.device = device
        self.model_selection = model_selection
        self.val_eval_every = val_eval_every
        self.val_k = val_k
        self.val_metric = val_metric
        self.batch_size = batch_size
        self.seed = seed
        self.mesh = mesh
        self.rng = get_rng(seed)

    def fit(self, train_set, val_set=None):
        super().fit(train_set, val_set)
        if not self.trainable:
            return self

        # (user, prev, next) transitions of every session
        item_arr = train_set.uir_tuple[1]
        user_arr = train_set.uir_tuple[0]
        users, prevs, nexts = [], [], []
        for sid, idx_list in train_set.sessions.items():
            items = [int(item_arr[i]) for i in idx_list]
            u = int(user_arr[idx_list[0]])
            for a, b in zip(items[:-1], items[1:]):
                users.append(u)
                prevs.append(a)
                nexts.append(b)
        if not users:
            raise ValueError("No transitions to train on.")

        dev = self._device()
        d = self.embedding_dim
        shapes = (self.total_users, self.total_items, self.total_items, self.total_items)
        self.params = {
            name: torch.as_tensor(normal((rows, d), std=0.01, random_state=self.rng), device=dev)
            for name, rows in zip(TABLES, shapes)
        }

        if self.loss == "bpr" and self.momentum == 0.0:
            n = len(users)
            bsz = min(self.batch_size, n)
            n_total = n + (-n) % bsz
            seed = self.rng.randint(2**31)
            u_d, p_d, t_d = (torch.as_tensor(np.asarray(a, np.int64), device=dev)
                             for a in (users, prevs, nexts))
            with torch.no_grad():
                for epoch in range(self.n_epochs):
                    pos_idx, neg_items = _fpmc_draws(epoch_generator(seed, epoch, dev), n,
                                                     n_total, self.num_items, dev)
                    _fpmc_epoch(self.params, u_d, p_d, t_d, pos_idx, neg_items, n,
                                self.learning_rate, self.lambda_reg, bsz)
            return self

        self._fit_general(users, prevs, nexts, train_set, val_set)
        return self

    def _fit_general(self, users, prevs, nexts, train_set, val_set):
        """The ``batch_loss`` family over transitions (in-batch and sampled
        negatives through the concatenated tables), adagrad."""
        dev = self._device()
        n = len(users)
        bsz = min(self.batch_size, n)
        n_pad = (-n) % bsz
        arrays = [np.concatenate([np.asarray(a, np.int64), np.zeros(n_pad, np.int64)])
                  for a in (users, prevs, nexts)]
        u_d, p_d, t_d = (torch.as_tensor(a, device=dev) for a in arrays)
        m_d = torch.as_tensor(np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)]),
                              device=dev)
        n_rows = n + n_pad
        n_batches = n_rows // bsz

        params = {name: self.params[name].requires_grad_(True) for name in TABLES}
        opt = adagrad_m(self.learning_rate, self.momentum)
        opt_state = opt.init(params)
        cum_probs = neg_sampling_table(train_set, self.sample_alpha, self.num_items, dev)
        seed = self.rng.randint(2**31)

        def run_epoch(epoch, opt_state):
            gen = epoch_generator(seed, epoch, dev)
            order = torch.randperm(n_rows, generator=gen, device=dev)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for b in range(n_batches):
                idx = order[b * bsz:(b + 1) * bsz]
                negs = sample_negatives(gen, cum_probs, (self.n_sample,))
                loss = _general_loss(params, u_d[idx], p_d[idx], t_d[idx], m_d[idx], negs,
                                     self.loss, self.lambda_reg, self.bpreg, self.elu_param)
                opt_state = step(params, opt, opt_state, loss)
                loss_sum += loss.detach()
            return opt_state, loss_sum

        select_best = self.model_selection == "best" and val_set is not None
        chunk = self.val_eval_every if select_best else self.n_epochs
        best_score, best_params = -np.inf, None
        done = 0
        while done < self.n_epochs:
            e = min(chunk, self.n_epochs - done)
            for epoch in range(done, done + e):
                opt_state, loss_sum = run_epoch(epoch, opt_state)
            done += e
            if self.verbose:
                print("Epoch %d/%d, loss: %.4f" % (done, self.n_epochs, float(loss_sum) / n_batches))
            if select_best:
                score = val_score(self, train_set, val_set, self.val_metric, self.val_k)
                if score > best_score:
                    best_score = score
                    best_params = {k: v.detach().clone() for k, v in params.items()}
        final = best_params if select_best and best_params is not None else params
        self.params = {k: v.detach() for k, v in final.items()}

    def score(self, user_idx, history_items, **kwargs):
        return self.score_history_batch(np.asarray([user_idx]), [list(history_items)])[0]

    @torch.no_grad()
    def score_history_batch(self, user_indices, histories):
        dev = self.params["V_UI"].device
        users = np.clip(np.asarray(user_indices, dtype=np.int64), 0, self.total_users - 1)
        lasts = np.asarray([int(h[-1]) if len(h) else 0 for h in histories], dtype=np.int64)
        has_last = np.asarray([1.0 if len(h) else 0.0 for h in histories], dtype=np.float32)
        scores = _fpmc_scores(self.params, torch.as_tensor(users, device=dev),
                              torch.as_tensor(lasts, device=dev),
                              torch.as_tensor(has_last, device=dev))
        return scores.cpu().numpy().astype(np.float64)[:, :self.num_items]
