"""SBPR — Social Bayesian Personalized Ranking (Zhao, McAuley & King,
CIKM 2014).

Port of ``cornac_tpu/models/sbpr.py``: BPR with a social middle tier
(positive > an item of a friend's that the user has not rated > negative,
the middle step weighted by 1 / (1 + the number of friends who rated it));
users without such items take the plain BPR step. Built on the port's BPR
trainer: each epoch draws (pair, negative, middle-tier uniform) from a
``torch.Generator`` keyed on (seed, global epoch) (``epoch_generator``),
observed negatives and negatives equal to the social item are skipped
through ``ops.membership``, and every scatter goes through the
deterministic ``ops.accumulate.accumulate_rows``, so a seeded fit gives the
same bits every time, chunked, checkpointed and resumed or not
(``utils.checkpoint.epoch_loop``).

The JAX package applies the item-factor updates as three scatters (i, then
j, then k); the port makes one ``accumulate_rows`` call over [i; j; k],
which sums each row's updates in that order before adding them once: the
same update up to float32 rounding. The three bias scatters stay three
calls in the JAX package's order, each reading the bias table the one
before wrote (the reference's regularisation terms read ``Bi[j]`` after the
update at ``i`` and ``Bi[k]`` after both).
"""

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.membership import build_membership
from ..utils.checkpoint import epoch_generator, epoch_loop
from . import bpr as _bpr
from .bpr import BPR
from .recommender import Recommender


def social_items(X, Y):
    """The social positives of every user, as CSR arrays (ids, counts,
    indptr), int32: for user u, the items rated by at least one of u's
    friends (the stored entries of row u of ``Y``) and not by u, ascending,
    each with the number of friends who rated it. ``X``: the (users, items)
    train CSR matrix; ``Y``: the (users, users) friendship CSR matrix.

    The JAX package loops over the users in Python
    (``cornac_tpu/models/sbpr.py::_prepare_social_data``); here one sparse
    product of the two structure matrices gives the same three arrays."""
    def structure(m):
        m = sp.csr_matrix(m)
        m.sum_duplicates()
        return sp.csr_matrix((np.ones(len(m.indices)), m.indices.copy(), m.indptr.copy()),
                             shape=m.shape)

    Xb, Yb = structure(X), structure(Y)
    counts = (Yb @ Xb).tocsr()
    counts = (counts - counts.multiply(Xb)).tocsr()  # drop the user's own items
    counts.eliminate_zeros()
    counts.sort_indices()
    return (counts.indices.astype(np.int32), counts.data.astype(np.int32),
            counts.indptr.astype(np.int32))


def _tier_draws(gen, n, n_total, batch_size, num_items):
    """An epoch's draws from ``gen``: (positive pair index, negative item,
    middle-tier uniform) tensors, in one draw of ``n_total`` or, above
    ``bpr._BULK_SAMPLING_MAX``, one per minibatch."""
    size = batch_size if n_total > _bpr._BULK_SAMPLING_MAX else n_total
    dev = gen.device
    for _ in range(n_total // size):
        pos_idx = torch.randint(n, (size,), generator=gen, device=dev)
        negs = torch.randint(num_items, (size,), generator=gen, device=dev)
        tier = torch.rand((size,), generator=gen, device=dev)
        yield pos_idx, negs, tier


def middle_tier(ids, indptr, users, tier):
    """(position in ``ids``, whether the user has any) of each user's
    middle-tier item, picked by the uniform ``tier`` from the user's CSR
    row, as the JAX package picks it: floor(tier x row length) past the
    row's start, clamped to the array (a user with an empty row gets a
    position whose item is unused)."""
    start = indptr[users]
    count = indptr[users + 1] - start
    pos = start + torch.floor(tier * torch.clamp_min(count, 1)).to(torch.int64)
    return torch.clamp_max(pos, ids.shape[0] - 1), count > 0


def _sbpr_step(U, V, Bi, u, i, j, k, m, hs, cnt, lr, lbd_u, lbd_v, lbd_b, use_bias):
    """One minibatch of SBPR's SGD, in place, as
    ``cornac_tpu/models/sbpr.py::_sbpr_epochs``' body computes it."""
    m = m.to(U.dtype)
    s_uk = 1.0 / (1.0 + cnt.to(U.dtype))
    wu, vi, vj, vk = U[u], V[i], V[j], V[k]
    bi, bj, bk = Bi[i], Bi[j], Bi[k]

    # plain-BPR branch
    x_ij = bi - bj + (wu * (vi - vj)).sum(1)
    z_ij = m * ~hs / (1.0 + torch.exp(x_ij))
    # social branch
    x_ik = (bi - bk + (wu * (vi - vk)).sum(1)) * s_uk
    x_kj = bk - bj + (wu * (vk - vj)).sum(1)
    z_ik = m * hs / (1.0 + torch.exp(x_ik))
    z_kj = m * hs / (1.0 + torch.exp(x_kj))
    zs = z_ik * s_uk
    mh = m * hs

    dU = (z_ij[:, None] * (vi - vj) + zs[:, None] * (vi - vk) + z_kj[:, None] * (vk - vj)
          - lbd_u * wu * m[:, None])
    dVi = (z_ij + zs)[:, None] * wu - lbd_v * vi * m[:, None]
    dVj = (-z_ij - z_kj)[:, None] * wu - lbd_v * vj * m[:, None]
    dVk = (z_kj - zs)[:, None] * wu - lbd_v * vk * mh[:, None]

    accumulate_rows(U, u, lr * dU)
    # one call over [i; j; k] in place of the reference's three scatters
    accumulate_rows(V, torch.cat([i, j, k]), lr * torch.cat([dVi, dVj, dVk]))
    if use_bias:
        # three calls in order: each regularisation term reads the table
        # the call before updated
        accumulate_rows(Bi, i, lr * (z_ij + zs - lbd_b * Bi[i] * m))
        accumulate_rows(Bi, j, lr * (-z_ij - z_kj - lbd_b * Bi[j] * m))
        accumulate_rows(Bi, k, lr * (z_kj - zs - lbd_b * Bi[k] * mh))


def _sbpr_epoch(U, V, Bi, draws, pairs, membership, social, n, hyper, batch_size, use_bias):
    """One epoch of SBPR on given draws (``_tier_draws``' tuples covering
    |R| padded to whole minibatches), updating U, V and Bi in place.
    ``social``: (ids, counts, indptr) int64 tensors of ``social_items``;
    ``hyper``: (lr, lambda_u, lambda_v, lambda_b). Samples past |R|,
    observed negatives and negatives equal to the social item are skipped.
    Returns the number skipped (a device scalar)."""
    soc_ids, soc_counts, soc_indptr = social
    skipped = torch.zeros((), dtype=torch.int64, device=U.device)
    start = 0
    for pos_idx, negs, tier in draws:
        users, items = pairs[pos_idx].unbind(1)
        padm = torch.arange(start, start + pos_idx.shape[0], device=U.device) < n
        pos, hs = middle_tier(soc_ids, soc_indptr, users, tier)
        soc_item, soc_cnt = soc_ids[pos], soc_counts[pos]
        valid = ~membership.query(users, negs) & (negs != soc_item) & padm
        skipped += (padm & ~valid).sum()
        for s in range(0, pos_idx.shape[0], batch_size):
            sl = slice(s, s + batch_size)
            _sbpr_step(U, V, Bi, users[sl], items[sl], negs[sl], soc_item[sl], valid[sl],
                       hs[sl], soc_cnt[sl], *hyper, use_bias)
        start += pos_idx.shape[0]
    return skipped


class SBPR(BPR):
    """BPR with a social middle tier: positives > friends' items > negatives.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``lambda_u``, ``lambda_v``, ``lambda_b``,
    ``use_bias``, ``batch_size``, ``init_params`` ({'U','V','Bi'}),
    ``seed``. The train set must carry the ``user_graph`` modality.
    ``device``: where the model trains and scores (default: the card).
    """

    def __init__(
        self,
        name="SBPR",
        k=10,
        max_iter=100,
        learning_rate=0.001,
        lambda_u=0.01,
        lambda_v=0.01,
        lambda_b=0.01,
        use_bias=True,
        num_threads=0,
        batch_size=1024,
        trainable=True,
        verbose=False,
        init_params=None,
        seed=None,
        mesh=None,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(f"{name}(mesh=...) is not ported yet (ROADMAP.md A8 (b))")
        super().__init__(
            name=name,
            k=k,
            max_iter=max_iter,
            learning_rate=learning_rate,
            lambda_reg=lambda_u,
            use_bias=use_bias,
            num_threads=num_threads,
            batch_size=batch_size,
            trainable=trainable,
            verbose=verbose,
            init_params=init_params,
            seed=seed,
            mesh=mesh,
            device=device,
        )
        self.lambda_u = lambda_u
        self.lambda_v = lambda_v
        self.lambda_b = lambda_b

    def _prepare_social_data(self, train_set):
        """(ids, counts, indptr) of every train user's social positives
        (``social_items`` over the train matrix and the user graph cut to
        the train users)."""
        Y = train_set.user_graph.matrix[: self.num_users, : self.num_users]
        return social_items(train_set.csr_matrix, Y)

    def fit(self, train_set, val_set=None):
        Recommender.fit(self, train_set, val_set)
        self._init()
        if not self.trainable:
            return self

        if getattr(train_set, "user_graph", None) is None:
            raise ValueError("this model needs the user_graph modality attached to the eval method")

        soc_ids, soc_counts, soc_indptr = self._prepare_social_data(train_set)
        if len(soc_ids) == 0:  # degenerate: no social signal at all
            soc_ids = np.zeros(1, dtype=np.int32)
            soc_counts = np.zeros(1, dtype=np.int32)

        dev = self._device()
        rid, cid, _ = train_set.uir_tuple
        n = len(rid)
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        membership = build_membership(train_set.csr_matrix, device=dev)
        social = tuple(torch.as_tensor(np.asarray(a, np.int64), device=dev)
                       for a in (soc_ids, soc_counts, soc_indptr))
        U, V, Bi = (torch.tensor(np.asarray(a, np.float32), device=dev)
                    for a in (self.u_factors, self.i_factors, self.i_biases))
        hyper = (self.learning_rate, self.lambda_u, self.lambda_v, self.lambda_b)
        seed = self.rng.randint(2**31)
        batch_size = min(self.batch_size, n)
        n_total = n + (-n) % batch_size

        def run_chunk(state, start, e):
            for epoch in range(start, start + e):
                draws = _tier_draws(epoch_generator(seed, epoch, dev), n, n_total, batch_size,
                                    train_set.num_items)
                skipped = _sbpr_epoch(*state, draws, pairs, membership, social, n, hyper,
                                      batch_size, self.use_bias)
            return state, skipped

        epoch_loop(self, self.max_iter, run_chunk, (U, V, Bi),
                   on_report=lambda done, skipped: print(
                       "Epoch %d/%d, skipped: %.2f%%"
                       % (done, self.max_iter, 100.0 * int(skipped) / n)))

        self.u_factors = U.cpu().numpy()
        self.i_factors = V.cpu().numpy()
        self.i_biases = Bi.cpu().numpy()
        return self
