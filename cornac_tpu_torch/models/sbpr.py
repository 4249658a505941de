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

``mesh`` (``parallel.make_mesh``) trains one process a rank and keeps the
single-device fit's bits, as BPR's branch does (``models/bpr.py``): U, V and
Bi are row-sharded over "model", every rank draws the same triplets and
middle-tier items, each computes the rows of its data slice of a minibatch
from rows fetched with ``row_shard_lookup``, and the rows, gathered back in
batch order, are added on the ranks that own them (``row_shard_scatter_add``).
The three bias steps stay three calls in order, each reading the bias
table the one before wrote.
"""

import functools

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.accumulate import accumulate_rows
from ..ops.membership import build_membership
from ..parallel.mesh import shard_tables
from ..parallel.sharded import (
    data_parallel,
    local_shard,
    row_shard_lookup,
    row_shard_scatter_add,
)
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


def _sbpr_rows(wu, vi, vj, vk, bi, bj, bk, m, hs, cnt, lbd_u, lbd_v):
    """The row-wise part of a minibatch (or of a data slice of one) from its
    fetched rows: (U's update rows, V's rows for i, j and k before the
    learning rate, and the bias steps' gradient terms for i, j and k with
    their masks), as ``cornac_tpu/models/sbpr.py::_sbpr_epochs``' body
    computes them."""
    m = m.to(wu.dtype)
    s_uk = 1.0 / (1.0 + cnt.to(wu.dtype))

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
    return dU, dVi, dVj, dVk, z_ij + zs, -z_ij - z_kj, z_kj - zs, m, mh


def _sbpr_step(U, V, Bi, u, i, j, k, m, hs, cnt, lr, lbd_u, lbd_v, lbd_b, use_bias, mesh=None):
    """One minibatch of SBPR's SGD, in place. ``mesh``: U, V and Bi are this
    rank's row shards over "model"; each rank fetches and computes the rows
    of its data slice, which are gathered back in batch order, and each
    row's updates are added on the rank that owns it."""
    if mesh is None:
        lookup, scatter = (lambda t, ids: t[ids]), accumulate_rows
    else:
        lookup = functools.partial(row_shard_lookup, mesh)
        scatter = functools.partial(row_shard_scatter_add, mesh)

    def rows(u, i, j, k, m, hs, cnt):
        v = lookup(V, torch.cat([i, j, k]))
        b = lookup(Bi, torch.cat([i, j, k]))
        return _sbpr_rows(lookup(U, u), *v.chunk(3), *b.chunk(3), m, hs, cnt, lbd_u, lbd_v)

    dU, dVi, dVj, dVk, gi, gj, gk, mf, mh = data_parallel(mesh, rows, u.shape[0], u, i, j, k,
                                                          m, hs, cnt)
    scatter(U, u, lr * dU)
    # one call over [i; j; k] in place of the reference's three scatters
    scatter(V, torch.cat([i, j, k]), lr * torch.cat([dVi, dVj, dVk]))
    if use_bias:
        # three calls in order: each regularisation term reads the table
        # the call before updated
        scatter(Bi, i, lr * (gi - lbd_b * lookup(Bi, i) * mf))
        scatter(Bi, j, lr * (gj - lbd_b * lookup(Bi, j) * mf))
        scatter(Bi, k, lr * (gk - lbd_b * lookup(Bi, k) * mh))


def _sbpr_epoch(U, V, Bi, draws, pairs, membership, social, n, hyper, batch_size, use_bias,
                mesh=None):
    """One epoch of SBPR on given draws (``_tier_draws``' tuples covering
    |R| padded to whole minibatches), updating U, V and Bi in place.
    ``social``: (ids, counts, indptr) int64 tensors of ``social_items``;
    ``hyper``: (lr, lambda_u, lambda_v, lambda_b). Samples past |R|,
    observed negatives and negatives equal to the social item are skipped.
    ``mesh``: U, V and Bi are this rank's row shards (``_sbpr_step``).
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
                       hs[sl], soc_cnt[sl], *hyper, use_bias, mesh)
        start += pos_idx.shape[0]
    return skipped


class SBPR(BPR):
    """BPR with a social middle tier: positives > friends' items > negatives.

    Parameters mirror the JAX package: ``k``, ``max_iter``,
    ``learning_rate``, ``lambda_u``, ``lambda_v``, ``lambda_b``,
    ``use_bias``, ``batch_size``, ``init_params`` ({'U','V','Bi'}),
    ``seed``. The train set must carry the ``user_graph`` modality.
    ``device``: where the model trains and scores (default: the card).
    ``mesh``: a ``parallel.make_mesh`` mesh; every rank calls ``fit``, and
    the factors equal the single-device fit's (module docstring).
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

        mesh = self.mesh
        dev = self._device()
        rid, cid, _ = train_set.uir_tuple
        n = len(rid)
        pairs = torch.as_tensor(np.stack([rid, cid], axis=1).astype(np.int64), device=dev)
        membership = build_membership(train_set.csr_matrix, device=dev)
        social = tuple(torch.as_tensor(np.asarray(a, np.int64), device=dev)
                       for a in (soc_ids, soc_counts, soc_indptr))
        tables = tuple(torch.tensor(np.asarray(a, np.float32), device=dev)
                       for a in (self.u_factors, self.i_factors, self.i_biases))
        if mesh is not None:
            tables = shard_tables(mesh, *tables)  # DTensors: what a checkpoint gathers
        hyper = (self.learning_rate, self.lambda_u, self.lambda_v, self.lambda_b)
        seed = self.rng.randint(2**31)
        batch_size = min(self.batch_size, n)
        n_total = n + (-n) % batch_size

        def run_chunk(state, start, e):
            for epoch in range(start, start + e):
                draws = _tier_draws(epoch_generator(seed, epoch, dev), n, n_total, batch_size,
                                    train_set.num_items)
                skipped = _sbpr_epoch(*(local_shard(t) for t in state), draws, pairs,
                                      membership, social, n, hyper, batch_size, self.use_bias,
                                      mesh)
            return state, skipped

        epoch_loop(self, self.max_iter, run_chunk, tables,
                   on_report=lambda done, skipped: print(
                       "Epoch %d/%d, skipped: %.2f%%"
                       % (done, self.max_iter, 100.0 * int(skipped) / n)))

        U, V, Bi = tables
        if mesh is not None:
            n_u, n_i = len(self.u_factors), len(self.i_factors)
            U, V, Bi = U.full_tensor()[:n_u], V.full_tensor()[:n_i], Bi.full_tensor()[:n_i]
        self.u_factors = U.cpu().numpy()
        self.i_factors = V.cpu().numpy()
        self.i_biases = Bi.cpu().numpy()
        return self
