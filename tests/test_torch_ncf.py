"""The port's GMF, MLP and NeuMF against the JAX package's, on the CPU.

- Initial parameters: bit for bit from the same ``get_rng`` seed (NeuMF's
  towers drawn as GMF and MLP draw them, then the fused output layer).
- One loss and its gradients on the same minibatch (users, items, labels
  and the mask of valid negatives made in the test), then one step of each
  optimizer, within rtol 1e-5 / atol 1e-6. The JAX loss is
  ``cornac_tpu/models/ncf.py``'s ``loss_fn``, a closure of ``fit``,
  written out here.
- An epoch's draws: every positive once, ``num_neg`` negatives each,
  observed negatives masked (``ops.membership``), padding masked.
- ``pretrain``: NeuMF's merge of pretrained GMF and MLP towers against JAX.
- Scoring on the same parameters: ``score``, ``score_batch``,
  ``score_pairs`` against JAX.
- Short fits: a seeded fit twice (once verbose) gives the same bits; early
  stopping on validation NDCG@100 runs through ``ranking_eval``.
"""

import contextlib
import io

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.models import GMF as JGMF, MLP as JMLP, NeuMF as JNeuMF
from cornac_tpu.utils import get_rng as j_get_rng
from cornac_tpu_torch.convert import params_to_module
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.models import GMF, MLP, NeuMF
from cornac_tpu_torch.models import ncf as ncf_mod
from cornac_tpu_torch.ops.membership import build_membership
from cornac_tpu_torch.ops.optim import make_optimizer, step
from cornac_tpu_torch.utils import get_rng

from test_torch_vaecf import _assert_grads, _assert_tree_equal, _both, _data, _grads

cornac_tpu_torch.set_default_device("cpu")

TOL = dict(rtol=1e-5, atol=1e-6)

CASES = {
    "GMF": (lambda **kw: JGMF(num_factors=4, **kw), lambda **kw: GMF(num_factors=4, **kw)),
    "MLP": (lambda **kw: JMLP(layers=(8, 6, 4), **kw), lambda **kw: MLP(layers=(8, 6, 4), **kw)),
    "NeuMF": (lambda **kw: JNeuMF(num_factors=4, layers=(8, 6, 4), **kw),
              lambda **kw: NeuMF(num_factors=4, layers=(8, 6, 4), **kw)),
}


def _shaped(model, n_users=40, n_items=50):
    model.num_users, model.num_items = n_users, n_items
    return model


def _j_loss(model, reg):
    """``cornac_tpu/models/ncf.py``'s ``loss_fn``."""
    def loss_fn(params, u, i, y, m):
        p = jnp.clip(model._forward(params, u, i), 1e-7, 1.0 - 1e-7)
        bce = -(y * jnp.log(p) + (1 - y) * jnp.log(1 - p))
        loss = jnp.sum(bce * m) / jnp.maximum(jnp.sum(m), 1.0)
        if reg > 0:
            loss = loss + reg * sum(jnp.sum(x**2) for x in jax.tree_util.tree_leaves(params))
        return loss
    return loss_fn


@pytest.mark.parametrize("learner", ["adam", "sgd", "rmsprop", "adagrad"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_init_loss_grads_and_one_step_match_jax(name, learner, reg=0.01, bsz=64):
    j_make, make = CASES[name]
    theirs, ours = _shaped(j_make(verbose=False)), _shaped(make(verbose=False))
    tree = theirs._init_params(j_get_rng(12))
    params = ours._init_params(get_rng(12))
    _assert_tree_equal(params, tree)

    rng = np.random.RandomState(3)
    u, i = rng.randint(40, size=bsz), rng.randint(50, size=bsz)
    y = (rng.rand(bsz) < 0.3).astype(np.float32)
    m = (rng.rand(bsz) < 0.9).astype(np.float32)
    j_in = (jnp.asarray(u, jnp.int32), jnp.asarray(i, jnp.int32), jnp.asarray(y), jnp.asarray(m))
    t_in = (torch.from_numpy(u.astype(np.int64)), torch.from_numpy(i.astype(np.int64)),
            torch.from_numpy(y), torch.from_numpy(m))
    loss, j_grads = jax.value_and_grad(_j_loss(theirs, reg))(tree, *j_in)

    def ours_loss():
        return ncf_mod._bce_loss(ours._forward, params, *t_in, reg)

    value = ours_loss()
    np.testing.assert_allclose(float(value), float(loss), **TOL)
    _assert_grads(_grads(value, params), j_grads)

    opt = {"adam": optax.adam, "sgd": optax.sgd, "rmsprop": optax.rmsprop,
           "adagrad": optax.adagrad}[learner](0.01)
    updates, _ = opt.update(j_grads, opt.init(tree), tree)
    named = dict(params.named_parameters())
    t_opt = make_optimizer(learner, 0.01)
    step(named, t_opt, t_opt.init(named), ours_loss())
    _assert_tree_equal(params, optax.apply_updates(tree, updates), exact=False)


def test_epoch_draws_mask_observed_negatives_and_padding():
    _, train = _both()
    rid, cid, _ = train.uir_tuple
    n, num_neg, n_pad = len(rid), 4, 7
    membership = build_membership(train.csr_matrix, device="cpu")
    gen = torch.Generator().manual_seed(0)
    users, items, labels, valid = ncf_mod._epoch_batches(
        gen, torch.as_tensor(rid, dtype=torch.int64), torch.as_tensor(cid, dtype=torch.int64),
        membership, train.num_items, num_neg, n_pad)
    assert users.shape[0] == n * (1 + num_neg) + n_pad
    assert int(labels.sum()) == n and bool((valid[labels == 1] == 1).all())
    pos = sorted(zip(users[labels == 1].tolist(), items[labels == 1].tolist()))
    assert pos == sorted(zip(rid.tolist(), cid.tolist()))
    observed = set(zip(rid.tolist(), cid.tolist()))
    neg = labels == 0
    seen = torch.tensor([(a, b) in observed for a, b in zip(users[neg].tolist(),
                                                           items[neg].tolist())])
    assert seen.any()  # some negatives hit observed pairs, and are masked, not redrawn
    # every observed negative and every padding entry (0, 0) is masked
    pad_seen = (0, 0) in observed
    assert int(valid[neg].sum()) == int((~seen).sum()) - (0 if pad_seen else n_pad)
    assert bool((valid[neg][seen] == 0).all())


def test_pretrain_merges_the_towers_as_jax(alpha=0.3):
    jtrain, train = _both()
    j_gmf = JGMF(num_factors=4, num_epochs=1, seed=1, verbose=False).fit(jtrain)
    j_mlp = JMLP(layers=(8, 6, 4), num_epochs=1, seed=2, verbose=False).fit(jtrain)
    gmf = GMF(num_factors=4, num_epochs=0, seed=1, verbose=False).fit(train)
    mlp = MLP(layers=(8, 6, 4), num_epochs=0, seed=2, verbose=False).fit(train)
    gmf.params = params_to_module(j_gmf.params, device="cpu")
    mlp.params = params_to_module(j_mlp.params, device="cpu")
    theirs = _shaped(JNeuMF(num_factors=4, layers=(8, 6, 4)).pretrain(j_gmf, j_mlp, alpha),
                     train.num_users, train.num_items)
    ours = _shaped(NeuMF(num_factors=4, layers=(8, 6, 4)).pretrain(gmf, mlp, alpha),
                   train.num_users, train.num_items)
    _assert_tree_equal(ours._init_params(get_rng(4)), theirs._init_params(j_get_rng(4)),
                       exact=False)
    # the merged model owns its parameters: the towers' models keep theirs
    merged = ours._init_params(get_rng(4))
    with torch.no_grad():
        merged.mlp.mlp[0].w.add_(1.0)
    np.testing.assert_array_equal(mlp.params.mlp[0].w.detach().numpy(),
                                  np.asarray(j_mlp.params["mlp"][0]["w"]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_scores_match_jax_on_the_same_parameters(name):
    jtrain, train = _both()
    j_make, make = CASES[name]
    theirs = j_make(num_epochs=1, seed=3, verbose=False).fit(jtrain)
    ours = make(num_epochs=0, seed=3, verbose=False).fit(train)
    ours.params = params_to_module(theirs.params, device="cpu")
    users, items = np.array([0, 5, 5, 39, -1]), np.array([2, 2, 9, 49, 3])
    np.testing.assert_allclose(ours.score(5), theirs.score(5), **TOL)
    assert np.isclose(ours.score(5, 9), theirs.score(5, 9), **TOL)
    np.testing.assert_allclose(ours.score_batch(users), theirs.score_batch(users), **TOL)
    np.testing.assert_allclose(ours.score_pairs(users, items), theirs.score_pairs(users, items),
                               **TOL)
    np.testing.assert_allclose(ours.score_batch_device(users[:4]).numpy(),
                               np.asarray(theirs.score_batch_device(users[:4])), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_seeded_fits_are_identical(name):
    _, train = _both()
    make = CASES[name][1]
    a = make(num_epochs=2, batch_size=128, seed=7, verbose=False).fit(train)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        b = make(num_epochs=2, batch_size=128, seed=7, verbose=True).fit(train)
    assert out.getvalue().count("Epoch") == 2
    for (n, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        np.testing.assert_array_equal(p.detach().numpy(), q.detach().numpy(), err_msg=n)
    assert np.isfinite(a.score_batch(np.arange(4))).all()


def test_early_stopping_watches_validation_ndcg():
    data = _data()
    train = Dataset.from_uir(data[:400], seed=1)
    val = Dataset.build(data[400:], global_uid_map=train.uid_map,
                        global_iid_map=train.iid_map, seed=1)
    model = GMF(num_factors=4, num_epochs=6, seed=1, verbose=False,
                early_stopping={"min_delta": 1.0, "patience": 1})
    with contextlib.redirect_stdout(io.StringIO()):
        model.fit(train, val)
    assert model.current_epoch == 2 and model.stopped_epoch == 2
    assert 0.0 <= model.best_value <= 1.0


def test_refusals():
    for cls in (GMF, MLP, NeuMF):
        with pytest.raises(NotImplementedError, match="A8"):
            cls(mesh=object())
    with pytest.raises(ValueError):
        GMF(backend="mxnet")
    with pytest.raises(ValueError):
        NeuMF(num_factors=5, layers=(8, 4))
