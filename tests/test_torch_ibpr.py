"""The port's IBPR, OnlineIBPR and COE against the JAX package's, on the CPU.

- Three Adam minibatch steps on the JAX package's own triplets (drawn in the
  test as ``cornac_tpu/models/ibpr.py``'s ``run_epochs`` draws them, from the
  key the seeded fit makes): the port's ``_triplet_step`` from the same
  seeded initial factors ends within rtol 1e-5 / atol 1e-6 of the JAX fit of
  one epoch. OnlineIBPR's items do not move.
- The device scorers ``device_dot`` and ``device_neg_l2`` on the same
  factors within rtol 1e-6 of the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax

import cornac_tpu_torch
from cornac_tpu.data import Dataset as JDataset
from cornac_tpu.models import COE as JCOE, IBPR as JIBPR, OnlineIBPR as JOnlineIBPR
from cornac_tpu.ops.dense_scores import device_dot as j_dot, device_neg_l2 as j_neg_l2
from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.models import COE, IBPR, OnlineIBPR
from cornac_tpu_torch.models import ibpr as ibpr_mod
from cornac_tpu_torch.ops.dense_scores import device_dot, device_neg_l2
from cornac_tpu_torch.ops.membership import build_membership
from cornac_tpu_torch.ops.optim import adam
from cornac_tpu_torch.utils import get_rng

cornac_tpu_torch.set_default_device("cpu")


def _data(seed=6, n_users=50, n_items=40, n=600):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    return [(f"u{u}", f"i{i}", 1.0) for u, i in pairs]


@pytest.mark.parametrize("cls,j_cls,lr", [(IBPR, JIBPR, 0.05), (OnlineIBPR, JOnlineIBPR, 0.01),
                                          (COE, JCOE, 0.05)])
def test_three_adam_steps_on_jax_triplets(cls, j_cls, lr, seed=8, k=5):
    data = _data()
    jtrain, train = JDataset.from_uir(data, seed=1), Dataset.from_uir(data, seed=1)
    n = train.num_ratings
    bsz = -(-n // 3)
    theirs = j_cls(k=k, max_iter=1, learning_rate=lr, batch_size=bsz, seed=seed).fit(jtrain)

    # the seeded fit's initial factors and key, then its epoch-0 draws
    rng = get_rng(seed)
    U0 = rng.randn(train.num_users, k).astype(np.float32)
    V0 = rng.randn(train.num_items, k).astype(np.float32)
    key = jax.random.PRNGKey(rng.randint(2**31))
    k_pos, k_neg = jax.random.split(jax.random.fold_in(key, 0))
    pos_idx = np.asarray(jax.random.randint(k_pos, (3 * bsz,), 0, n), np.int64)
    negs = torch.from_numpy(np.asarray(jax.random.randint(k_neg, (3 * bsz,), 0,
                                                          train.num_items), np.int64))
    rid, cid, _ = train.uir_tuple
    users = torch.from_numpy(rid[pos_idx].astype(np.int64))
    pos = torch.from_numpy(cid[pos_idx].astype(np.int64))
    valid = (~build_membership(train.csr_matrix, device="cpu").query(users, negs)).float()
    assert 0 < valid.sum() < 3 * bsz  # some negatives are observed and masked out

    ours = cls(k=k, learning_rate=lr, seed=seed)
    params = {"U": torch.tensor(U0, requires_grad=True), "V": torch.tensor(V0, requires_grad=True)}
    opt = adam(lr)
    state = opt.init(params)
    for s in range(0, 3 * bsz, bsz):
        sl = slice(s, s + bsz)
        state, loss = ibpr_mod._triplet_step(params, opt, state, users[sl], pos[sl], negs[sl],
                                             valid[sl], ours.lamda, ours._distance,
                                             ours._update_items)
        assert np.isfinite(float(loss))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(params["U"].detach().numpy(), theirs.U, **tol)
    np.testing.assert_allclose(params["V"].detach().numpy(), theirs.V, **tol)
    if cls is OnlineIBPR:
        np.testing.assert_array_equal(params["V"].detach().numpy(), V0)
        assert float(state["nu"]["V"].abs().max()) == 0.0
    # the port's own fit starts from the same factors and moves them
    fitted = cls(k=k, max_iter=1, learning_rate=lr, batch_size=bsz, seed=seed).fit(train)
    assert np.isfinite(fitted.U).all() and not np.array_equal(fitted.U, U0)


def test_device_scorers_match_jax():
    rng = np.random.RandomState(3)
    u, V = rng.randn(17, 6).astype(np.float32), rng.randn(90, 6).astype(np.float32)
    np.testing.assert_allclose(device_dot(u, V, "cpu").numpy(), np.asarray(j_dot(u, V)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(device_neg_l2(u, V, "cpu").numpy(), np.asarray(j_neg_l2(u, V)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cls,j_cls", [(IBPR, JIBPR), (COE, JCOE)])
def test_fit_scores_rank_as_jax_on_the_same_factors(cls, j_cls):
    data = _data()
    init = {"U": np.random.RandomState(1).randn(50, 4).astype(np.float32),
            "V": np.random.RandomState(2).randn(40, 4).astype(np.float32)}
    ours = cls(k=4, trainable=False, init_params=dict(init)).fit(Dataset.from_uir(data, seed=1))
    theirs = j_cls(k=4, trainable=False, init_params=dict(init)).fit(
        JDataset.from_uir(data, seed=1))
    users = np.arange(0, ours.num_users, 3)
    np.testing.assert_allclose(ours.score_batch(users), theirs.score_batch(users), rtol=1e-6)
    np.testing.assert_allclose(ours.score_batch_device(users).numpy(),
                               np.asarray(theirs.score_batch_device(users)), rtol=1e-6,
                               atol=1e-6)
    assert ours.get_vector_measure() == theirs.get_vector_measure()
    uids = list(ours.uid_map)[:6]
    assert ours.recommend_batch(uids, k=5) == theirs.recommend_batch(uids, k=5)
