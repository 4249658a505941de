"""Sharded-embedding and sharded-ranking primitives, and the data axis's
split of a minibatch.

Port of ``cornac_tpu/parallel/sharded.py``. Every function runs in every
rank of the mesh (SPMD) and issues its collectives explicitly:

* ``row_shard_lookup``: each rank gathers the rows it owns of a table
  row-sharded over "model" and zeros the rest; an all-reduce over the model
  group assembles the rows. A row that is ``-0.0`` comes back ``+0.0``
  when the model axis has more than one rank (the sum with the other
  ranks' zeros); ``torch.equal`` takes them as equal, and no later value
  depends on the sign.
* ``row_shard_scatter_add``: one ``ops.accumulate.accumulate_rows`` call on
  the local shard with ids shifted by the shard's first row. That call
  drops ids outside the shard, which is the JAX function's owned-row mask,
  and sums each row's updates in batch order: a sharded table receives the
  single-device table's additions, in its order.
* ``sharded_topk``: each rank scores its rows through ``ops.fused_topk``
  (the hand-written kernel on the card, its plain version on the CPU),
  the (score, global id) candidates are all-gathered over "model" and
  merged, ties to the smaller global id, as the unsharded top-k breaks
  them.
* ``batch_slice`` and ``gather_batch``: the data axis's split of a
  minibatch. Every rank holds the whole minibatch's ids (each rank draws
  the same global stream); rank d computes the update rows of slice d,
  and ``gather_batch`` puts the slices back in batch order, so the update
  rows reach ``accumulate_rows`` in the single-device order. Each rank
  computes its slice's per-row dot products and elementwise functions
  itself: a row's reduction and each element's function give the same
  bits in a slice as in the whole batch (``tests/test_torch_parallel.py``
  holds the fits bit for bit on every layout, one thread a rank). A slice
  starts at a multiple of ``SLICE_ROWS`` rows, so that CPU vector loops
  meet each element at the same place of a vector as in the whole batch.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..ops.fused_topk import fused_topk
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    is_dtensor,
    pad_rows_to_multiple,
)

SLICE_ROWS = 64


def local_shard(table):
    """The rows this rank holds: a ``DTensor``'s local tensor (the same
    storage, so in-place updates reach the table), or ``table`` itself when
    it is already a rank's plain shard."""
    return table.to_local() if is_dtensor(table) else table


def _first_row(mesh, rows):
    return mesh.get_local_rank(MODEL_AXIS) * rows


def row_shard_lookup(mesh, table, ids):
    """Gather rows of a model-axis row-sharded table by global row id.

    table: (R, ...) sharded ``Shard(0)`` over "model" (a ``DTensor`` or
    this rank's shard); R divisible by the model-axis size. ids: (B,)
    integer global row ids, the same on every rank of the model group.
    Returns the (B, ...) rows, a plain tensor equal on the model group.
    """
    local = local_shard(table)
    rows = local.shape[0]
    at = ids.long() - _first_row(mesh, rows)
    owned = (at >= 0) & (at < rows)
    out = local[at.clamp(0, max(rows - 1, 0))]
    # masked_fill_ takes the 0 by value; torch.where(..., 0.0) would copy it
    # to the card from pageable memory at every call
    out.masked_fill_(~owned.view((-1,) + (1,) * (local.dim() - 1)), 0.0)
    dist.all_reduce(out, group=mesh.get_group(MODEL_AXIS))
    return out


def row_shard_scatter_add(mesh, table, ids, updates):
    """Scatter-add ``updates`` (B, ...) into rows ``ids`` (B,) of a
    model-axis row-sharded table, in place; returns ``table``. Each rank
    applies the updates of the rows it owns, summed per row in batch order
    (the deterministic replacement of the reference's racy writes)."""
    local = local_shard(table)
    from ..ops.accumulate import accumulate_rows

    accumulate_rows(local, ids.long() - _first_row(mesh, local.shape[0]), updates)
    return table


def _all_gather(x, group, parts):
    """(parts * n, ...) of every rank's ``x`` (n, ...), in group-rank order."""
    out = x.new_empty((parts * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_single is the name of newer torch releases for the call
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def sharded_topk(mesh, user_emb, item_table, k, item_bias=None):
    """Full-catalog top-k with the item table row-sharded over "model".

    user_emb: (B, d) float32, the same on every rank of the model group.
    item_table: (N, d) and item_bias: (N,) or None, sharded ``Shard(0)``
    over "model". k is capped at the rows of a shard, as in the JAX package.
    Returns (scores (B, k) float32, global item ids (B, k) int32), best
    first, equal scores by ascending global id.
    """
    items = local_shard(item_table)
    bias = None if item_bias is None else local_shard(item_bias)
    rows = items.shape[0]
    k = min(int(k), rows)
    scores, idx = fused_topk(user_emb, items, k, bias=bias)
    gid = idx.to(torch.int64) + _first_row(mesh, rows)
    group, parts = mesh.get_group(MODEL_AXIS), axis_size(mesh, MODEL_AXIS)
    B = scores.shape[0]
    # (parts, B, k) in shard order -> (B, parts * k); each shard's list is
    # best first with ties by ascending id, and shard s's ids all lie below
    # shard s + 1's, so a stable sort on the score keeps the tie rule
    s_all = _all_gather(scores, group, parts).view(parts, B, k).permute(1, 0, 2).reshape(B, -1)
    g_all = _all_gather(gid, group, parts).view(parts, B, k).permute(1, 0, 2).reshape(B, -1)
    order = torch.sort(s_all, dim=1, descending=True, stable=True).indices[:, :k]
    return s_all.gather(1, order), g_all.gather(1, order).to(torch.int32)


def pad_rows_for_mesh(x, mesh, fill=0.0):
    """Pad a table's leading dim up to a multiple of the model-axis size
    with rows of ``fill``. Returns (padded numpy array, original rows)."""
    n = x.shape[0]
    pad = (-n) % axis_size(mesh, MODEL_AXIS)
    if pad == 0:
        return x, n
    block = np.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype)
    return np.concatenate([np.asarray(x), block]), n


def batch_slice(mesh, n):
    """(start, stop, rows a slice) of this rank's slice of an n-row
    minibatch along the data axis: slices of equal size, a multiple of
    ``SLICE_ROWS``, in data-rank order; the last ones may be short or
    empty."""
    parts = axis_size(mesh, DATA_AXIS)
    per = -(-(-(-n // parts)) // SLICE_ROWS) * SLICE_ROWS
    start = min(mesh.get_local_rank(DATA_AXIS) * per, n)
    return start, min(start + per, n), per


def gather_batch(mesh, x, n, per):
    """The n-row whole of a minibatch whose slices (``batch_slice``) the
    ranks of the data group hold: this rank's slice ``x`` is padded to
    ``per`` rows, the slices are all-gathered in data-rank order, which is
    the batch's order, and the padding is cut off."""
    parts = axis_size(mesh, DATA_AXIS)
    x = pad_rows_to_multiple(x, per) if x.shape[0] else x.new_zeros((per,) + tuple(x.shape[1:]))
    return _all_gather(x, mesh.get_group(DATA_AXIS), parts)[:n]


def all_sum(mesh, value, axis=DATA_AXIS):
    """Sum a tensor over the ranks of ``axis``'s group, in place; returns
    it. The sharded trainers add their counts of a data slice with it."""
    dist.all_reduce(value, group=mesh.get_group(axis))
    return value
