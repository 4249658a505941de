"""VEBPR — View-Enhanced BPR (Ding et al., TKDE 2019).

Port of ``cornac_tpu/models/vebpr.py``: BPR with a view middle tier
(purchase > viewed but not purchased > neither, weighted ``alpha`` and
``1 - alpha``) on a ``PurchaseViewDataset``; users without views take the
plain BPR step. The trainer is SBPR's (``models/sbpr.py``): per-epoch draws
keyed on (seed, global epoch), negatives that were purchased (or viewed,
for a user with views) skipped through ``ops.membership``, and every
scatter through ``ops.accumulate.accumulate_rows``. The item-factor update
is one call over [i; j; v] where the JAX package makes three scatters: the
same update up to float32 rounding.
"""

import numpy as np
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.membership import build_membership
from ..utils.checkpoint import epoch_generator, epoch_loop
from .bpr import BPR
from .recommender import Recommender
from .sbpr import _tier_draws, middle_tier


def _vebpr_step(U, V, u, i, j, v, m, hv, lr, reg, alpha):
    """One minibatch of VEBPR's SGD, in place, as
    ``cornac_tpu/models/vebpr.py::_vebpr_epochs``' body computes it."""
    m = m.to(U.dtype)
    wu, vi, vj, vv = U[u], V[i], V[j], V[v]

    # no-view branch: plain BPR
    x_ij = torch.clamp((wu * (vi - vj)).sum(1), -50.0, 50.0)
    d_ij = m * ~hv / (1.0 + torch.exp(x_ij))
    # view branch: purchase > view (weight alpha), view > negative (1 - alpha)
    x_iv = torch.clamp((wu * (vi - vv)).sum(1), -50.0, 50.0)
    x_vj = torch.clamp((wu * (vv - vj)).sum(1), -50.0, 50.0)
    d_iv = alpha * m * hv / (1.0 + torch.exp(x_iv))
    d_vj = (1.0 - alpha) * m * hv / (1.0 + torch.exp(x_vj))

    dU = (d_ij[:, None] * (vi - vj) + d_iv[:, None] * (vi - vv) + d_vj[:, None] * (vv - vj)
          - reg * wu * m[:, None])
    dVi = (d_ij + d_iv)[:, None] * wu - reg * vi * m[:, None]
    dVj = (-d_ij - d_vj)[:, None] * wu - reg * vj * m[:, None]
    dVv = (d_vj - d_iv)[:, None] * wu - reg * vv * (m * hv)[:, None]

    accumulate_rows(U, u, lr * dU)
    # one call over [i; j; v] in place of the reference's three scatters
    accumulate_rows(V, torch.cat([i, j, v]), lr * torch.cat([dVi, dVj, dVv]))


def _vebpr_epoch(U, V, draws, pairs, purchase_mem, view_mem, views, n, hyper, batch_size):
    """One epoch of VEBPR on given draws (``sbpr._tier_draws``' tuples
    covering |R| padded to whole minibatches), updating U and V in place.
    ``views``: (ids, indptr) int64 tensors of the view matrix's CSR rows;
    ``hyper``: (lr, lambda_reg, alpha). Returns the number of samples
    skipped (a device scalar)."""
    view_ids, view_indptr = views
    skipped = torch.zeros((), dtype=torch.int64, device=U.device)
    start = 0
    for pos_idx, negs, tier in draws:
        users, items = pairs[pos_idx].unbind(1)
        padm = torch.arange(start, start + pos_idx.shape[0], device=U.device) < n
        pos, hv = middle_tier(view_ids, view_indptr, users, tier)
        view_item = view_ids[pos]
        bad = purchase_mem.query(users, negs) | (hv & view_mem.query(users, negs))
        valid = ~bad & padm
        skipped += (padm & ~valid).sum()
        for s in range(0, pos_idx.shape[0], batch_size):
            sl = slice(s, s + batch_size)
            _vebpr_step(U, V, users[sl], items[sl], negs[sl], view_item[sl], valid[sl], hv[sl],
                        *hyper)
        start += pos_idx.shape[0]
    return skipped


class VEBPR(BPR):
    """BPR with a view middle tier (a ``PurchaseViewDataset`` is required).

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``lambda_reg``, ``alpha``, ``batch_size``,
    ``init_params`` ({'U','V'}), ``seed``; no item bias. ``device``: where
    the model trains and scores (default: the card).
    """

    def __init__(
        self,
        name="VEBPR",
        k=10,
        max_iter=100,
        learning_rate=0.01,
        lambda_reg=0.1,
        alpha=0.5,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        super().__init__(
            name=name,
            k=k,
            max_iter=max_iter,
            learning_rate=learning_rate,
            lambda_reg=lambda_reg,
            use_bias=False,
            num_threads=num_threads,
            batch_size=batch_size,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )
        self.alpha = alpha

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self._init()
        if not self.trainable:
            return self

        if not hasattr(train_set, "view_matrix"):
            raise ValueError("VEBPR requires a PurchaseViewDataset (view_matrix missing).")

        dev = self._device()
        rid, cid, _ = train_set.uir_tuple
        n = len(rid)
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        purchase_mem = build_membership(train_set.csr_matrix, device=dev)
        view_csr = train_set.view_matrix.tocsr()
        view_mem = build_membership(view_csr, device=dev)
        view_ids = np.asarray(view_csr.indices, dtype=np.int64)
        if len(view_ids) == 0:
            view_ids = np.zeros(1, dtype=np.int64)
        views = (torch.as_tensor(view_ids, device=dev),
                 torch.as_tensor(np.asarray(view_csr.indptr, np.int64), device=dev))
        U, V = (torch.tensor(np.asarray(a, np.float32), device=dev)
                for a in (self.u_factors, self.i_factors))
        hyper = (self.learning_rate, self.lambda_reg, self.alpha)
        seed = self.rng.randint(2**31)
        batch_size = min(self.batch_size, n)
        n_total = n + (-n) % batch_size

        def run_chunk(state, start, e):
            for epoch in range(start, start + e):
                draws = _tier_draws(epoch_generator(seed, epoch, dev), n, n_total, batch_size,
                                    train_set.num_items)
                skipped = _vebpr_epoch(*state, draws, pairs, purchase_mem, view_mem, views, n,
                                       hyper, batch_size)
            return state, skipped

        epoch_loop(self, self.max_iter, run_chunk, (U, V),
                   on_report=lambda done, skipped: print(
                       "Epoch %d/%d, skipped: %.2f%%"
                       % (done, self.max_iter, 100.0 * int(skipped) / n)))

        self.u_factors = U.cpu().numpy()
        self.i_factors = V.cpu().numpy()
        return self
