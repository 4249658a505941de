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
  ``axis=None`` splits over every rank of the mesh instead (the JAX
  package's ``P(("data", "model"))``), in global rank order.
* ``data_parallel``: a function of a minibatch's rows run on this rank's
  slice, its outputs gathered back in batch order: the row-wise part of a
  step, written once for both the single-device and the mesh fit;
  ``split_scoring`` runs a scorer that way over every rank when the ranks divide
  the batch.
* ``round_batch``: the JAX package's rounding of a minibatch sharded over
  every rank, or over one axis (CVAE's and ConvMF's over "data").
* ``slice_rows``: a replicated table's rows at this rank's slice of a
  minibatch, whose gradient is summed in batch order as on one device.
* ``row_shard_set_last_wins``: ``set_rows_last_wins`` on a row-sharded
  table, the RMSProp caches' write.
* ``sum_grads``: a list of gradients summed over the ranks in one
  all-reduce.
* ``all_sum_messages``: a sum over the ranks whose gradient is again that
  sum, for the partial messages of a sharded graph (``ops.graph``, GCMC):
  every rank's loss reaches every rank's edges.
* ``Share``: this rank's rows of a minibatch split over every rank, for
  the losses that couple a minibatch's rows (a mean over the whole batch,
  an in-batch block that scores every row against every column, batch
  statistics, draws made for the whole batch).
* ``data_group_first``: whether this rank is the first of its "data" group,
  the rank that adds a loss's terms of no row where a minibatch is split
  over "data" alone (CVAE's VAE), as ``Share.first`` does over every rank.
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


def gather_shards(mesh, shard):
    """The whole table (its rows padded to the shard count) of which
    ``shard`` is this rank's row shard over "model", on every rank: the
    shards all-gathered in model-rank order."""
    return _all_gather(local_shard(shard), mesh.get_group(MODEL_AXIS), axis_size(mesh, MODEL_AXIS))


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


def _split(mesh, axis):
    """(parts, this rank's index, process group) of ``axis``, or of the
    whole mesh when ``axis`` is None: a ``make_mesh`` mesh spans the group
    in rank order, so its flat index is the global rank."""
    if axis is None:
        return mesh.size(), dist.get_rank(), dist.group.WORLD
    return axis_size(mesh, axis), mesh.get_local_rank(axis), mesh.get_group(axis)


def batch_slice(mesh, n, axis=DATA_AXIS):
    """(start, stop, rows a slice) of this rank's slice of an n-row
    minibatch along ``axis`` (None: every rank of the mesh): slices of equal
    size, a multiple of ``SLICE_ROWS``, in rank order; the last ones may be
    short or empty."""
    parts, index, _ = _split(mesh, axis)
    per = -(-(-(-n // parts)) // SLICE_ROWS) * SLICE_ROWS
    start = min(index * per, n)
    return start, min(start + per, n), per


def gather_batch(mesh, x, n, per, axis=DATA_AXIS):
    """The n-row whole of a minibatch whose slices (``batch_slice``) the
    ranks of ``axis`` hold: this rank's slice ``x`` is padded to ``per``
    rows, the slices are all-gathered in rank order, which is the batch's
    order, and the padding is cut off."""
    parts, _, group = _split(mesh, axis)
    x = pad_rows_to_multiple(x, per) if x.shape[0] else x.new_zeros((per,) + tuple(x.shape[1:]))
    return _all_gather(x, group, parts)[:n]


def data_parallel(mesh, fn, n, *rows, axis=DATA_AXIS):
    """``fn(*rows)`` on the n-row minibatch ``rows``, computed slice-wise on
    a mesh. ``fn`` is row-wise (row p of each output depends on row p of
    the inputs alone) and returns one float tensor or a tuple of them. With
    ``mesh`` None it runs on the whole batch; else each rank runs it on its
    ``batch_slice`` and the outputs are gathered back in batch order, so
    every rank holds the single-device outputs, bit for bit."""
    if mesh is None:
        return fn(*rows)
    lo, hi, per = batch_slice(mesh, n, axis)
    out = fn(*(r[lo:hi] for r in rows))
    single = isinstance(out, torch.Tensor)
    outs = (out,) if single else tuple(out)
    widths = [int(np.prod(o.shape[1:], dtype=np.int64)) for o in outs]
    flat = torch.cat([o.reshape(o.shape[0], w) for o, w in zip(outs, widths)], 1)
    whole = gather_batch(mesh, flat, n, per, axis)
    # contiguous, as the outputs of a whole batch's row-wise ops are: a
    # reduction over a strided view may add in another order on the card
    res = [part.reshape((n,) + tuple(o.shape[1:])).contiguous()
           for o, part in zip(outs, whole.split(widths, 1))]
    return res[0] if single else tuple(res)


def round_batch(mesh, bsz, axis=None):
    """A minibatch size rounded down to a multiple of the ranks of ``axis``
    (None: every rank of the mesh), at least one row a rank, as the JAX
    package rounds the minibatches it shards; ``bsz`` itself without a
    mesh."""
    if mesh is None:
        return bsz
    parts = mesh.size() if axis is None else axis_size(mesh, axis)
    return max(parts, bsz - bsz % parts)


def split_scoring(mesh, fn, n, *rows):
    """``fn(*rows)`` on an n-row scoring batch, split over every rank
    (``data_parallel`` with ``axis=None``) when there is a mesh and its
    ranks divide n, as the JAX package shards an inference batch over the
    mesh; on the whole batch otherwise. A collective every rank calls on a
    mesh."""
    if mesh is not None and n % mesh.size() == 0:
        return data_parallel(mesh, fn, n, *rows, axis=None)
    return fn(*rows)


class _SliceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mesh, axis):
        lo, hi, ctx.per = batch_slice(mesh, ids.shape[0], axis)
        ctx.mesh, ctx.axis, ctx.shape = mesh, axis, table.shape
        ctx.save_for_backward(ids)
        return table[ids[lo:hi]]

    @staticmethod
    def backward(ctx, grad):
        from ..ops.accumulate import accumulate_rows

        (ids,) = ctx.saved_tensors
        whole = gather_batch(ctx.mesh, grad.contiguous(), ids.shape[0], ctx.per, ctx.axis)
        return accumulate_rows(grad.new_zeros(ctx.shape), ids, whole), None, None, None


def slice_rows(mesh, table, ids, axis=DATA_AXIS):
    """The rows of a replicated table at this rank's ``batch_slice`` of the
    minibatch's ids ``ids`` (all of them, the same on every rank), whose
    gradient is the whole minibatch's: the slices' row gradients are
    gathered back in batch order and summed into the table by
    ``accumulate_rows``, as ``ops.accumulate.gather_rows``'s backward sums
    the single-device batch. Every rank then holds the same table gradient,
    which needs no sum over the ranks (``ops.optim.step``'s ``whole``)."""
    return _SliceRows.apply(table, ids, mesh, axis)


def all_sum(mesh, value, axis=DATA_AXIS):
    """Sum a tensor over the ranks of ``axis``'s group (None: every rank),
    in place; returns it. The sharded trainers add their counts of a data
    slice, and their gradients, with it."""
    dist.all_reduce(value, group=_split(mesh, axis)[2])
    return value


def sum_grads(mesh, grads, axis=DATA_AXIS, keep=()):
    """The tensors ``grads`` (a list) summed over ``axis``'s ranks (None:
    every rank) in one all-reduce of their concatenation, but for the
    positions in ``keep``, which are returned as they are. The data-parallel
    trainers sum their gradients with it (``ops.optim.step``, GCMC)."""
    grads = list(grads)
    summed = [j for j in range(len(grads)) if j not in keep]
    flat = all_sum(mesh, torch.cat([grads[j].reshape(-1) for j in summed]), axis)
    for j, part in zip(summed, flat.split([grads[j].numel() for j in summed])):
        grads[j] = part.view(grads[j].shape)
    return grads


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_sum(mesh, x.clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return all_sum(ctx.mesh, grad.clone(), ctx.axis), None, None


def all_sum_messages(mesh, x, axis=DATA_AXIS):
    """The sum of every rank's ``x`` over ``axis`` (None: every rank), with
    autograd: its gradient is the sum of the ranks' gradients, so a
    message built from one rank's share of the edges receives the
    gradient of every rank's loss."""
    return _AllSum.apply(x, mesh, axis)


def row_shard_set_last_wins(mesh, table, ids, values):
    """``ops.rmsprop.set_rows_last_wins`` on a model-axis row-sharded
    table: each rank writes the rows it owns (ids shifted by the shard's
    first row), the last batch position of a row winning, as on one device.
    A position whose row another rank owns writes again a row the batch
    writes here, with its value, or row 0 with its own value when the batch
    writes none here, so that nothing waits for the host to count them.
    Returns ``table``."""
    local = local_shard(table)
    rows = local.shape[0]
    at = ids.long() - _first_row(mesh, rows)
    owned = (at >= 0) & (at < rows)
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((rows + 1,), -1, dtype=torch.int64, device=ids.device)
    last.scatter_reduce_(0, torch.where(owned, at, rows), pos, reduce="amax")
    last = last[:rows]
    at = torch.where(owned, at, last.argmax())  # a written row, or row 0
    src = last[at]
    written = (src >= 0).view((-1,) + (1,) * (values.dim() - 1))
    local[at] = torch.where(written, values[src.clamp_min(0)], local[at])
    return table


def data_group_first(mesh):
    """Whether this rank is the first of its "data" group (or there is no
    mesh): the rank that adds a data-parallel loss's terms of no row."""
    return mesh is None or mesh.get_local_rank(DATA_AXIS) == 0


class Share:
    """This rank's share of an n-row minibatch that a data-parallel fit
    splits over every rank of ``mesh`` (``batch_slice`` with ``axis=None``,
    the JAX package's ``P(("data", "model"))``): the rows ``lo:hi``; with
    ``mesh`` None, the whole batch.

    For the losses that couple a minibatch's rows: every rank holds the
    whole minibatch and computes the terms of its own rows over the whole
    batch's count (``n`` rows, or the whole mask's sum), and ``first``
    (global rank 0, or no mesh) adds the terms that belong to no row, such
    as a dense table's penalty, once; ``ops.optim.step(mesh=, axis=None)``
    then sums the gradients. Random draws are made for the whole batch and
    cut (``draw``), so that every layout draws one stream. Where the share
    is the whole batch (no mesh, or a mesh of one rank) ``take`` gives the
    tensor itself, and the fit runs the single-device operations."""

    def __init__(self, mesh, n):
        self.mesh, self.n = mesh, int(n)
        if mesh is None:
            self.lo, self.hi, self.per, self.first = 0, self.n, self.n, True
        else:
            self.lo, self.hi, self.per = batch_slice(mesh, self.n, None)
            self.first = dist.get_rank() == 0

    @property
    def whole(self):
        """Whether this rank holds every row of the batch."""
        return self.lo == 0 and self.hi == self.n

    def take(self, x):
        """This rank's rows of ``x``, whose leading dimension is the batch
        (``x`` itself where they are all of them)."""
        return x if self.whole else x[self.lo:self.hi]

    def draw(self, shape, generator, device):
        """``torch.rand`` of a (rows, ...) shape, drawn for the whole batch
        (n rows) and cut to this rank's rows."""
        return self.take(torch.rand((self.n,) + tuple(shape[1:]), generator=generator,
                                    device=device))

    def gather(self, x):
        """The whole batch of a row-wise tensor of which ``x`` holds this
        rank's rows, on every rank (no gradient); a collective that every
        rank calls on a mesh."""
        return x if self.mesh is None else gather_batch(self.mesh, x, self.n, self.per, None)

    def sum(self, x):
        """``x`` summed over every rank, its gradient summed again
        (``all_sum_messages``): a whole-batch statistic from the ranks'
        partial sums; ``x`` itself without a mesh."""
        return x if self.mesh is None else all_sum_messages(self.mesh, x, None)
