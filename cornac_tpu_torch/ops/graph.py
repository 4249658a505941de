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
call it. Sharding the adjacency over a mesh waits for ROADMAP.md A8.
"""

import numpy as np
import torch

from ..device import resolve_device
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
    dev = resolve_device(device)
    u, i, norm = _degree_norm(train_set)
    return (torch.as_tensor(np.asarray(u, np.int64), device=dev),
            torch.as_tensor(np.asarray(i, np.int64), device=dev),
            torch.as_tensor(norm.astype(np.float32), device=dev))


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
    module's docstring)."""

    def __init__(self, train_set, budget_elems=DENSE_ADJ_BUDGET, mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "NormAdjacency(mesh=...), the adjacency sharded over a mesh, is not ported yet "
                "(ROADMAP.md A8)")
        self.mesh = mesh
        self.num_users = train_set.num_users
        self.num_items = train_set.num_items
        dev = resolve_device(device)
        self.edge_u, self.edge_i, self.edge_norm = build_norm_edges(train_set, dev)
        self.dense = None
        if self.num_users * self.num_items <= budget_elems:
            A = np.zeros((self.num_users, self.num_items), np.float32)
            u, i, norm = _degree_norm(train_set)
            np.add.at(A, (u, i), norm)
            self.dense = torch.as_tensor(A, device=dev)

    def propagate(self, user_emb, item_emb):
        """One propagation step: (messages to users, messages to items)."""
        if self.dense is not None:
            with full_f32():
                return self.dense @ item_emb, self.dense.T @ user_emb
        return propagate(user_emb, item_emb, self.edge_u, self.edge_i, self.edge_norm)

    def lightgcn(self, user_emb, item_emb, num_layers):
        """Mean of layer-0..K embeddings under LightGCN propagation."""
        return layer_mean(self.propagate, user_emb, item_emb, num_layers)
