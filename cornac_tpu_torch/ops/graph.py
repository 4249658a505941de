"""Bipartite-graph propagation for the graph CF models (LightGCN, NGCF).

Port of ``cornac_tpu/ops/graph.py``. Two forms of the symmetric-normalized
adjacency, chosen by :class:`NormAdjacency`:

- **dense** (num_users x num_items within ``DENSE_ADJ_BUDGET`` cells): the
  normalized matrix lives on the device and a propagation step is two
  ``torch.matmul`` in full float32, as the JAX form is two XLA products;
- **edges** (beyond it): flat edge arrays with 1/sqrt(du * di) weights, a
  step gathers the embedding rows of every edge (``gather_rows``), scales
  them and sums them into the other side's rows (``accumulate_rows``, the
  hand-written kernel on the card). Both directions are deterministic: the
  forward's sums and the backward's (the gather's gradient is again an
  ``accumulate_rows``) are taken in edge order, never by atomics
  (``index_add_`` sums with atomics on the card).

``propagate_torch`` is the edge form's plain version, with ``index_add_``
and autograd's own gather; on the card only the tests and ``chip_smoke.py``
call it.

``NormAdjacency(mesh=)`` shards the adjacency over every rank of a
``parallel.make_mesh`` mesh, as the JAX package shards it over every mesh
axis. The edge form splits the edge list into contiguous parts, one a rank
in global rank order (uneven parts, so no padding edge is needed); the
dense form splits the user rows into blocks, one a rank. Each rank
propagates its part, and the partial messages are summed over the ranks
(``parallel.sharded.all_sum_messages``, whose gradient is again that sum,
so every rank's loss reaches every rank's edges). The messages equal the
plain adjacency's up to the order of the float32 sums, and bit for bit on a
mesh of one rank.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.mesh import check_mesh, mesh_device
from .accumulate import accumulate_rows, gather_rows
from .dispatch import full_f32

# dense adjacency budget: num_users * num_items cells (f32), 5e7 = 200 MB
DENSE_ADJ_BUDGET = 50_000_000


def _degree_norm(train_set):
    """(users, items, 1/sqrt(du * di) in float64) of the train set's edges."""
    u, i, _ = train_set.uir_tuple
    du = np.zeros(train_set.num_users)
    di = np.zeros(train_set.num_items)
    np.add.at(du, u, 1)
    np.add.at(di, i, 1)
    return u, i, 1.0 / np.sqrt(np.maximum(du[u] * di[i], 1.0))


def build_norm_edges(train_set, device=None):
    """(users int64, items int64, norm float32) edge tensors on ``device``
    (default: the card) with symmetric-normalized weights."""
    return _edge_tensors(*_degree_norm(train_set), resolve_device(device))


def _edge_tensors(u, i, norm, device):
    """(users int64, items int64, norm float32) tensors on ``device`` of
    the numpy edges (u, i, norm)."""
    return (torch.as_tensor(np.asarray(u, np.int64), device=device),
            torch.as_tensor(np.asarray(i, np.int64), device=device),
            torch.as_tensor(norm.astype(np.float32), device=device))


class _ScatterRows(torch.autograd.Function):
    """``zeros(rows, d).index_add(0, ids, updates)`` in batch order
    (``accumulate_rows``), whose gradient with respect to the updates is the
    gather ``grad[ids]``."""

    @staticmethod
    def forward(ctx, updates, ids, rows):
        ctx.save_for_backward(ids)
        out = updates.new_zeros((rows,) + updates.shape[1:])
        return accumulate_rows(out, ids, updates.contiguous())

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return grad[ids], None, None


def scatter_rows(updates, ids, rows):
    """(rows, ...) sums of ``updates`` by ``ids``, deterministically, with
    autograd."""
    return _ScatterRows.apply(updates, ids, rows)


def propagate(user_emb, item_emb, edge_u, edge_i, edge_norm):
    """One symmetric-normalized bipartite propagation step (edge form):
    (messages to users, messages to items)."""
    w = edge_norm[:, None]
    msg_to_items = scatter_rows(gather_rows(user_emb, edge_u) * w, edge_i, item_emb.shape[0])
    msg_to_users = scatter_rows(gather_rows(item_emb, edge_i) * w, edge_u, user_emb.shape[0])
    return msg_to_users, msg_to_items


def propagate_torch(user_emb, item_emb, edge_u, edge_i, edge_norm):
    """Plain version of ``propagate``: ``index_add`` and autograd's gather
    (both atomic on the card, so it agrees there only to float32
    rounding)."""
    w = edge_norm[:, None]
    msg_to_items = torch.zeros_like(item_emb).index_add(0, edge_i, user_emb[edge_u] * w)
    msg_to_users = torch.zeros_like(user_emb).index_add(0, edge_u, item_emb[edge_i] * w)
    return msg_to_users, msg_to_items


def layer_mean(step, user_emb, item_emb, num_layers):
    """Mean of layer-0..K embeddings, each layer ``step(ue, ie)`` of the
    one before."""
    ue_acc, ie_acc = user_emb, item_emb
    ue, ie = user_emb, item_emb
    for _ in range(num_layers):
        ue, ie = step(ue, ie)
        ue_acc = ue_acc + ue
        ie_acc = ie_acc + ie
    return ue_acc / (num_layers + 1), ie_acc / (num_layers + 1)


def lightgcn_embeddings(user_emb, item_emb, edge_u, edge_i, edge_norm, num_layers):
    """Mean of layer-0..K embeddings under LightGCN propagation (edge form)."""
    return layer_mean(lambda ue, ie: propagate(ue, ie, edge_u, edge_i, edge_norm),
                      user_emb, item_emb, num_layers)


class NormAdjacency:
    """Symmetric-normalized bipartite adjacency on ``device`` (default: the
    card), dense within ``budget_elems`` cells, else as edges (see the
    module's docstring). ``mesh``: a ``parallel.make_mesh`` mesh; each rank
    holds its part and ``propagate`` sums the ranks' messages (every rank
    calls it)."""

    def __init__(self, train_set, budget_elems=DENSE_ADJ_BUDGET, mesh=None, device=None):
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.num_users = train_set.num_users
        self.num_items = train_set.num_items
        dev = resolve_device(device) if mesh is None else mesh_device(mesh)
        u, i, norm = _degree_norm(train_set)
        self.rows = slice(0, self.num_users)  # this rank's block of the dense form's rows
        self.dense = None
        if self.num_users * self.num_items <= budget_elems:
            if mesh is not None:  # the rank's block of user rows
                per = -(-self.num_users // mesh.size())
                start = min(self.num_users, per * torch.distributed.get_rank())
                self.rows = slice(start, min(self.num_users, start + per))
            keep = (u >= self.rows.start) & (u < self.rows.stop)
            A = np.zeros((self.rows.stop - self.rows.start, self.num_items), np.float32)
            np.add.at(A, (u[keep] - self.rows.start, i[keep]), norm[keep])
            self.dense = torch.as_tensor(A, device=dev)
        elif mesh is not None:  # the rank's part of the edges
            per = -(-len(u) // mesh.size())
            start = min(len(u), per * torch.distributed.get_rank())
            u, i, norm = (a[start:start + per] for a in (u, i, norm))
        self.edge_u, self.edge_i, self.edge_norm = _edge_tensors(u, i, norm, dev)

    def propagate(self, user_emb, item_emb):
        """One propagation step: (messages to users, messages to items)."""
        if self.mesh is None:
            if self.dense is not None:
                with full_f32():
                    return self.dense @ item_emb, self.dense.T @ user_emb
            return propagate(user_emb, item_emb, self.edge_u, self.edge_i, self.edge_norm)
        from ..parallel.sharded import all_sum_messages

        if self.dense is not None:
            to_users = user_emb.new_zeros(user_emb.shape)
            with full_f32():
                block = self.dense @ item_emb
                to_items = self.dense.T @ user_emb[self.rows]
            to_users = torch.cat([to_users[:self.rows.start], block, to_users[self.rows.stop:]])
        elif self.edge_u.shape[0]:
            to_users, to_items = propagate(user_emb, item_emb, self.edge_u, self.edge_i,
                                           self.edge_norm)
        else:  # a rank past the last edge
            to_users, to_items = user_emb * 0.0, item_emb * 0.0
        both = all_sum_messages(self.mesh, torch.cat([to_users, to_items]), None)
        return both[:self.num_users], both[self.num_users:]

    def lightgcn(self, user_emb, item_emb, num_layers):
        """Mean of layer-0..K embeddings under LightGCN propagation."""
        return layer_mean(self.propagate, user_emb, item_emb, num_layers)
