"""The port's NormAdjacency, LightGCN and NGCF against the JAX package's, on
the CPU.

- ``build_norm_edges``: the same edges and weights.
- ``NormAdjacency``: the dense form and the edge form (forced with
  ``budget_elems=0``) against each other and against the JAX package's,
  forward (one step and LightGCN's layer mean) and gradient, within rtol
  1e-5 / atol 1e-6; the edge form's plain version ``propagate_torch`` too.
- LightGCN and NGCF: initial parameters bit for bit from the same seed;
  one loss and its gradients on the same triplets in both forms, then one
  Adam step, within rtol 1e-5 / atol 1e-6 (the JAX losses, closures of
  ``fit``, written out here).
- Scoring on the same embeddings against JAX.
- Short fits: a seeded fit twice (once verbose) gives the same bits, in
  both forms.
- ``mesh=`` refuses anything but a ``parallel.make_mesh`` mesh.
"""

import contextlib
import functools
import io

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.models import LightGCN as JLightGCN, NGCF as JNGCF
from cornac_tpu.ops import graph as j_graph
from cornac_tpu.utils import get_rng as j_get_rng
from cornac_tpu_torch.models import NGCF, LightGCN
from cornac_tpu_torch.models import lightgcn as lightgcn_mod
from cornac_tpu_torch.ops import graph
from cornac_tpu_torch.ops.optim import adam, step
from cornac_tpu_torch.utils import get_rng

from test_torch_vaecf import _assert_grads, _assert_tree_equal, _both, _grads

cornac_tpu_torch.set_default_device("cpu")

TOL = dict(rtol=1e-5, atol=1e-6)


def _emb(train, d=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(train.num_users, d).astype(np.float32),
            rng.randn(train.num_items, d).astype(np.float32))


def test_build_norm_edges_matches_jax():
    jtrain, train = _both()
    for ours, theirs in zip(graph.build_norm_edges(train, device="cpu"),
                            j_graph.build_norm_edges(jtrain)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("budget", [graph.DENSE_ADJ_BUDGET, 0])
def test_propagation_forward_and_gradient_match_jax(budget):
    jtrain, train = _both()
    ue, ie = _emb(train)
    adj = graph.NormAdjacency(train, budget_elems=budget, device="cpu")
    j_adj = j_graph.NormAdjacency(jtrain, budget_elems=budget)
    assert (adj.dense is None) == (budget == 0) == (j_adj.dense is None)
    gu, gi = _emb(train, seed=1)  # cotangents

    def j_fn(u, i):
        a, b = j_adj.propagate(u, i)
        c, d = j_adj.lightgcn(u, i, 3)
        return jnp.sum(a * gu) + jnp.sum(b * gi) + jnp.sum(c * gi.sum()) + jnp.sum(d * gu.sum())

    want = jax.value_and_grad(j_fn, argnums=(0, 1))(jnp.asarray(ue), jnp.asarray(ie))
    u = torch.tensor(ue, requires_grad=True)
    i = torch.tensor(ie, requires_grad=True)
    a, b = adj.propagate(u, i)
    c, d = adj.lightgcn(u, i, 3)
    ja, jb = j_adj.propagate(jnp.asarray(ue), jnp.asarray(ie))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), **TOL)
    value = (a * torch.from_numpy(gu)).sum() + (b * torch.from_numpy(gi)).sum() \
        + (c * float(gi.sum())).sum() + (d * float(gu.sum())).sum()
    np.testing.assert_allclose(float(value), float(want[0]), rtol=1e-5)
    grads = torch.autograd.grad(value, [u, i])
    for got, exp in zip(grads, want[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def test_dense_edge_and_plain_forms_agree():
    _, train = _both()
    ue, ie = _emb(train, seed=2)
    dense = graph.NormAdjacency(train, device="cpu")
    edges = graph.NormAdjacency(train, budget_elems=0, device="cpu")
    outs = []
    for fn in (dense.propagate, edges.propagate,
               lambda u, i: graph.propagate_torch(u, i, edges.edge_u, edges.edge_i,
                                                  edges.edge_norm)):
        u = torch.tensor(ue, requires_grad=True)
        i = torch.tensor(ie, requires_grad=True)
        a, b = fn(u, i)
        g = torch.autograd.grad((a * a).sum() + (b * 3).sum(), [u, i])
        outs.append([t.detach().numpy() for t in (a, b, *g)])
    for other in outs[1:]:
        for x, y in zip(outs[0], other):
            np.testing.assert_allclose(y, x, **TOL)
    got = graph.lightgcn_embeddings(torch.from_numpy(ue), torch.from_numpy(ie), edges.edge_u,
                                    edges.edge_i, edges.edge_norm, 2)
    for x, y in zip(got, dense.lightgcn(torch.from_numpy(ue), torch.from_numpy(ie), 2)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


def _j_lightgcn_loss(adj, layers, lam):
    """``cornac_tpu/models/lightgcn.py``'s LightGCN ``loss_fn``."""
    def loss_fn(params, u, i, j):
        ue, ie = adj.lightgcn(params["user_emb"], params["item_emb"], layers)
        pu, vi, vj = ue[u], ie[i], ie[j]
        bpr = jnp.mean(jax.nn.softplus(jnp.sum(pu * (vj - vi), axis=1)))
        reg = 0.5 * (jnp.sum(params["user_emb"][u] ** 2) + jnp.sum(params["item_emb"][i] ** 2)
                     + jnp.sum(params["item_emb"][j] ** 2)) / u.shape[0]
        return bpr + lam * reg
    return loss_fn


def _j_ngcf_loss(model, lam):
    """``cornac_tpu/models/lightgcn.py``'s NGCF ``loss_fn``."""
    def loss_fn(params, u, i, j):
        ue, ie = model._ngcf_embeddings(params)
        pu, vi, vj = ue[u], ie[i], ie[j]
        bpr = jnp.mean(jax.nn.softplus(jnp.sum(pu * (vj - vi), axis=1)))
        reg = 0.5 * (jnp.sum(pu**2) + jnp.sum(vi**2) + jnp.sum(vj**2)) / u.shape[0]
        return bpr + lam * reg
    return loss_fn


@pytest.mark.parametrize("budget", [graph.DENSE_ADJ_BUDGET, 0])
@pytest.mark.parametrize("cls,j_cls", [(LightGCN, JLightGCN), (NGCF, JNGCF)],
                         ids=["LightGCN", "NGCF"])
def test_init_loss_grads_and_adam_step_match_jax(cls, j_cls, budget, bsz=32, lam=0.01):
    jtrain, train = _both()
    kw = dict(emb_size=6, lambda_reg=lam)
    if cls is NGCF:
        kw["layer_sizes"] = [6, 5]
    theirs, ours = j_cls(**kw), cls(**kw)
    for m, t in ((theirs, jtrain), (ours, train)):
        m.num_users, m.num_items = t.num_users, t.num_items
        m.uid_map, m.iid_map = t.uid_map, t.iid_map
    tree = theirs._init_params(j_get_rng(8))
    params = ours._init_params(get_rng(8))
    _assert_tree_equal(params, tree)
    theirs._adj = j_graph.NormAdjacency(jtrain, budget_elems=budget)
    ours._adj = graph.NormAdjacency(train, budget_elems=budget, device="cpu")

    rng = np.random.RandomState(5)
    u, i, j = (rng.randint(n, size=bsz) for n in (train.num_users, train.num_items,
                                                  train.num_items))
    j_loss = (_j_ngcf_loss(theirs, lam) if cls is NGCF
              else _j_lightgcn_loss(theirs._adj, ours.num_layers, lam))
    loss, j_grads = jax.value_and_grad(j_loss)(tree, *(jnp.asarray(a) for a in (u, i, j)))
    t_in = [torch.from_numpy(a.astype(np.int64)) for a in (u, i, j)]
    value = ours._loss(params, *t_in)
    np.testing.assert_allclose(float(value), float(loss), **TOL)
    _assert_grads(_grads(value, params), j_grads)

    opt = optax.adam(0.01)
    updates, _ = opt.update(j_grads, opt.init(tree), tree)
    named = dict(params.named_parameters())
    t_opt = adam(0.01)
    step(named, t_opt, t_opt.init(named), ours._loss(params, *t_in))
    _assert_tree_equal(params, optax.apply_updates(tree, updates), exact=False)


@pytest.mark.parametrize("cls,j_cls", [(LightGCN, JLightGCN), (NGCF, JNGCF)],
                         ids=["LightGCN", "NGCF"])
def test_scores_match_jax_on_the_same_embeddings(cls, j_cls):
    jtrain, train = _both()
    theirs = j_cls(emb_size=6, num_epochs=1, batch_size=128, seed=3).fit(jtrain)
    ours = cls(emb_size=6, num_epochs=0, batch_size=128, seed=3).fit(train)
    ours.U, ours.V = np.asarray(theirs.U), np.asarray(theirs.V)
    users, items = np.array([0, 5, 5, 39, -1]), np.array([2, 2, 9, 49, 3])
    np.testing.assert_allclose(ours.score(5), theirs.score(5), **TOL)
    np.testing.assert_allclose(ours.score_batch(users), theirs.score_batch(users), **TOL)
    np.testing.assert_allclose(ours.score_pairs(users, items), theirs.score_pairs(users, items),
                               **TOL)
    np.testing.assert_allclose(ours.score_batch_device(users[:4]).numpy(),
                               np.asarray(theirs.score_batch_device(users[:4])), **TOL)


@pytest.mark.parametrize("budget", [graph.DENSE_ADJ_BUDGET, 0])
@pytest.mark.parametrize("cls", [LightGCN, NGCF])
def test_seeded_fits_are_identical(cls, budget, monkeypatch):
    _, train = _both()
    monkeypatch.setattr(lightgcn_mod, "NormAdjacency",
                        functools.partial(graph.NormAdjacency, budget_elems=budget))
    kw = dict(emb_size=6, num_epochs=2, batch_size=128, seed=9)
    if cls is NGCF:
        kw["layer_sizes"] = [6, 6]
    a = cls(**kw).fit(train)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        b = cls(**kw, verbose=True).fit(train)
    assert out.getvalue().count("Epoch") == 2
    assert (a._adj.dense is None) == (budget == 0)
    for (n, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=n)
    np.testing.assert_array_equal(a.U, b.U)
    assert np.isfinite(a.score_batch(np.arange(4))).all()


def test_refusals_name_their_roadmap_items():
    _, train = _both()
    # mesh= is ported (tests/test_torch_parallel_models.py): anything but a
    # parallel.make_mesh mesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        graph.NormAdjacency(train, mesh=object(), device="cpu")
    for cls in (LightGCN, NGCF):
        with pytest.raises(TypeError, match="DeviceMesh"):
            cls(mesh=object())
