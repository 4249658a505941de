"""The RMSProp stream epoch shared by the sigmoid-link factor models.

Port of ``cornac_tpu/ops/rmsprop.py``: one minibatched RMSProp epoch over a
stream of (row, col, value) observations with the model
``value ~ sigmoid(A[row] . B[col])`` (or the identity link), on the tables'
device. PMF's rating stream, SoRec's trust and rating streams and MCF's
item-graph and rating streams all run it. Each minibatch gathers the rows of
A, B and their caches, writes the caches back (the last position of a row in
the minibatch wins, ``set_rows_last_wins``) and adds the factor updates
through the deterministic ``ops.accumulate.accumulate_rows``, each position
using its own new cache value. Nothing syncs with the host inside an epoch.
The JAX package's padding of the columns to 64 is left out: padded columns
are exactly zero either way.
"""

import numpy as np
import torch

from .accumulate import accumulate_rows


def set_rows_last_wins(table, ids, values):
    """``table[ids[p]] = values[p]`` for every batch position p, in place,
    where for a row that appears more than once the last position in batch
    order wins: the rule of ``cache.at[u].set(...)`` in the JAX package on
    its CPU reference (XLA applies a scatter's updates in order). A max of
    the batch positions per row (order-free, so deterministic on the card),
    then one gather: every duplicate of a row writes the same value."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((table.shape[0],), -1, dtype=torch.int64, device=ids.device)
    last.scatter_reduce_(0, ids, pos, reduce="amax")
    table[ids] = values[last[ids]]
    return table


def _rmsprop_rows(pa, pb, old_a, old_b, v, m, lr_a, lr_b, reg, gamma, non_linear):
    """The row-wise part of a minibatch from its fetched rows: (A's new
    cache rows, B's new cache rows, A's update rows, B's update rows, each
    position's loss term), a padded position keeping its old cache rows and
    adding nothing."""
    eps = 1e-8
    sc = (pa * pb).sum(1)
    if non_linear:
        sg = torch.sigmoid(torch.clamp(sc, -6.0, 6.0))
        e = v - sg
        we = e * sg * (1.0 - sg)
    else:
        e = v - sc
        we = e
    we = we * m
    terms = (e * e + reg * ((pa * pa).sum(1) + (pb * pb).sum(1))) * m
    mm = m[:, None]
    ga = we[:, None] * pb - reg * pa * mm
    gb = we[:, None] * pa - reg * pb * mm
    ca = gamma * old_a + (1 - gamma) * ga * ga
    cb = gamma * old_b + (1 - gamma) * gb * gb
    return (torch.where(mm > 0, ca, old_a), torch.where(mm > 0, cb, old_b),
            lr_a * ga / (torch.sqrt(ca) + eps) * mm, lr_b * gb / (torch.sqrt(cb) + eps) * mm,
            terms)


def rmsprop_stream_epoch(A, B, cache_a, cache_b, perm, mask, pairs, vals, lr_a, lr_b, reg, gamma,
                         batch_size, non_linear=True, mesh=None):
    """One RMSProp epoch over the observations in the order ``perm``
    ((n_total,) int64, the stream padded to whole minibatches; ``mask``
    (n_total,) float32 is 0 on the padding), updating the four tables in
    place. ``pairs``: (n, 2) int64 (row of A, row of B); ``vals``: (n,)
    float32. A moves at ``lr_a``, B at ``lr_b``. Returns the epoch's loss (a
    device scalar).

    As ``cornac_tpu/ops/rmsprop.py::rmsprop_stream_epoch`` computes it: the
    score clipped to [-6, 6] before the sigmoid; each position writes its
    new cache row, a padded position the old one, the last position of a
    row winning; the factor updates use each position's own new cache
    value and sum through ``accumulate_rows`` in batch order.

    ``mesh`` (``parallel.make_mesh``): the four tables are this rank's row
    shards over "model". Each rank fetches the rows of its data slice of a
    minibatch (``row_shard_lookup``), computes their cache rows, update
    rows and loss terms, and the slices are gathered back in batch order
    (``data_parallel``); each rank then writes the cache rows it owns
    (``row_shard_set_last_wins``) and adds the update rows it owns
    (``row_shard_scatter_add``): the single-device epoch's bits."""
    from ..parallel.sharded import (
        data_parallel,
        row_shard_lookup,
        row_shard_scatter_add,
        row_shard_set_last_wins,
    )

    loss = torch.zeros((), dtype=torch.float32, device=A.device)
    for s in range(0, perm.shape[0], batch_size):
        idx, m = perm[s:s + batch_size], mask[s:s + batch_size]
        r, c = pairs[idx].unbind(1)
        v = vals[idx]
        if mesh is None:
            new_a, new_b, upd_a, upd_b, terms = _rmsprop_rows(
                A[r], B[c], cache_a[r], cache_b[c], v, m, lr_a, lr_b, reg, gamma, non_linear)
            set_rows_last_wins(cache_a, r, new_a)
            set_rows_last_wins(cache_b, c, new_b)
            accumulate_rows(A, r, upd_a)
            accumulate_rows(B, c, upd_b)
        else:
            def rows(r, c, v, m):
                pa, ca = (row_shard_lookup(mesh, t, r) for t in (A, cache_a))
                pb, cb = (row_shard_lookup(mesh, t, c) for t in (B, cache_b))
                return _rmsprop_rows(pa, pb, ca, cb, v, m, lr_a, lr_b, reg, gamma, non_linear)

            new_a, new_b, upd_a, upd_b, terms = data_parallel(mesh, rows, idx.shape[0], r, c, v,
                                                              m)
            row_shard_set_last_wins(mesh, cache_a, r, new_a)
            row_shard_set_last_wins(mesh, cache_b, c, new_b)
            row_shard_scatter_add(mesh, A, r, upd_a)
            row_shard_scatter_add(mesh, B, c, upd_b)
        loss += terms.sum()
    return loss


def stream_order(n, batch_size, rng, device):
    """(perm, mask) of one epoch of a stream of ``n`` observations, as
    ``cornac_tpu/ops/rmsprop.py::run_stream_epoch`` makes them: the order
    ``rng.permutation(n)`` from the caller's numpy generator (so a fit draws
    what the JAX package's fit draws), padded with position 0 to whole
    minibatches of ``min(batch_size, n)``, and the mask that is 0 on the
    padding. The order goes to the device from pinned memory without
    waiting, so an epoch never syncs with the host."""
    bsz = min(batch_size, n)
    n_pad = (-n) % bsz
    perm = np.concatenate([rng.permutation(n), np.zeros(n_pad, np.int64)])
    host = torch.from_numpy(perm)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    mask = torch.cat([torch.ones(n, device=device), torch.zeros(n_pad, device=device)])
    return host.to(device, non_blocking=True), mask, bsz


def run_stream_epoch(A, B, cache_a, cache_b, pairs, vals, rng, lr_a, lr_b, reg, gamma,
                     batch_size=1024, non_linear=True, mesh=None):
    """One epoch of the stream (``pairs``, ``vals``) in the order the numpy
    generator ``rng`` draws (``stream_order``), updating the tables in
    place. Returns the epoch's loss (a device scalar). ``mesh``: the four
    tables are row-sharded over "model" (``DTensor``s, or this rank's
    shards), as ``rmsprop_stream_epoch`` takes them."""
    from ..parallel.sharded import local_shard

    A, B, cache_a, cache_b = (local_shard(t) for t in (A, B, cache_a, cache_b))
    perm, mask, bsz = stream_order(pairs.shape[0], batch_size, rng, pairs.device)
    return rmsprop_stream_epoch(A, B, cache_a, cache_b, perm, mask, pairs, vals, lr_a, lr_b, reg,
                                gamma, bsz, non_linear, mesh)
