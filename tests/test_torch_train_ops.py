"""The port's training primitives against the JAX package's, on the CPU.

- ``accumulate_rows`` (plain version; the kernel's arithmetic): within
  float32 rounding of ``cornac_tpu.ops.accumulate.accumulate_rows`` on
  shapes that take each of its strategies (one-hot product, plain scatter,
  sorted scatter; 1-D and 2-D tables), rtol 1e-5 / atol 1e-5 (both sum
  float32 updates, in another order); bit for bit equal to one sum per run
  in batch order added once, and to itself on a second call.
- ``Membership.query``: exact against every JAX build (bitmap, b+tree,
  CSR binary search), forced by ``bitmap_max_bytes`` and
  ``btree_max_degree``.
- ``epoch_loop``: the JAX package's chunking, report, ``max_chunk`` and
  early exit; ``enable_checkpointing`` raises.
- ``init_utils.normal``: the JAX package's draws, bit for bit.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.ops.accumulate import accumulate_rows as j_accumulate_rows
from cornac_tpu.ops.membership import build_membership as j_build_membership
from cornac_tpu.utils.init_utils import normal as j_normal
from cornac_tpu_torch.models import BPR, MF
from cornac_tpu_torch.ops.accumulate import accumulate_rows, accumulate_rows_torch
from cornac_tpu_torch.ops.dense_scores import device_broadcast_row
from cornac_tpu_torch.ops.membership import build_membership
from cornac_tpu_torch.utils.checkpoint import epoch_generator, epoch_loop
from cornac_tpu_torch.utils.init_utils import normal

cornac_tpu_torch.set_default_device("cpu")


def _accumulate_case(R, B, d, seed):
    rng = np.random.RandomState(seed)
    shape = (R,) if d is None else (R, d)
    table = rng.randn(*shape).astype(np.float32)
    # duplicate-heavy: a quarter of the batch hits 5 popular rows
    ids = np.where(rng.rand(B) < 0.25, rng.randint(5, size=B), rng.randint(R, size=B))
    updates = rng.randn(B, *shape[1:]).astype(np.float32)
    return table, ids.astype(np.int64), updates


@pytest.mark.parametrize("R,B,d", [
    (50, 500, 11),     # one-hot product: rows <= batch and <= 4096
    (40, 300, None),   # one-hot, a 1-D table (the baselines' biases)
    (5000, 6000, 3),   # plain scatter: rows <= batch, above the one-hot cap
    (3000, 500, 64),   # plain scatter: 256-byte rows
    (3000, 500, 11),   # sorted scatter
    (1000, 100, None), # sorted scatter, 1-D
], ids=["onehot", "onehot_1d", "scatter_dup", "scatter_fast_rows", "sorted", "sorted_1d"])
def test_accumulate_rows_matches_jax(R, B, d):
    table, ids, updates = _accumulate_case(R, B, d, seed=R + B)
    want = np.asarray(j_accumulate_rows(jnp.asarray(table), jnp.asarray(ids, jnp.int32),
                                        jnp.asarray(updates)))
    got = accumulate_rows(torch.from_numpy(table.copy()), torch.from_numpy(ids),
                          torch.from_numpy(updates))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    again = accumulate_rows(torch.from_numpy(table.copy()), torch.from_numpy(ids),
                            torch.from_numpy(updates))
    assert torch.equal(got, again)


@pytest.mark.parametrize("d", [None, 1, 33, 200])
def test_accumulate_rows_sums_each_run_in_batch_order(d):
    # the kernel's arithmetic: per row, 0.0 plus the row's updates in batch
    # order, then one add to the table; the plain version gives these bits
    table, ids, updates = _accumulate_case(70, 900, d, seed=3)
    want = table.copy()
    for r in np.unique(ids):
        s = np.zeros(table.shape[1:], np.float32)
        for q in np.flatnonzero(ids == r):
            s = s + updates[q]
        want[r] = want[r] + s
    t = torch.from_numpy(table.copy())
    out = accumulate_rows_torch(t, torch.from_numpy(ids), torch.from_numpy(updates))
    assert out is t  # in place
    np.testing.assert_array_equal(out.numpy(), want)


def test_accumulate_rows_empty_batch_and_bad_force():
    t = torch.ones(4, 3)
    out = accumulate_rows(t, torch.zeros(0, dtype=torch.long), torch.zeros(0, 3))
    assert torch.equal(out, torch.ones(4, 3))
    with pytest.raises(ValueError):
        accumulate_rows(t, torch.zeros(1, dtype=torch.long), torch.zeros(1, 3), force="kernel")


def _membership_matrix(seed=0, n_users=60, n_items=300):
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, 40, n_users)
    deg[[3, n_users - 1]] = 0        # empty rows, the last one too
    deg[7] = n_items                  # a full row
    deg[11] = 200                     # above a 64-wide leaf: several b+tree leaves
    rows = np.repeat(np.arange(n_users), deg)
    cols = np.concatenate([rng.choice(n_items, size=k, replace=False) for k in deg])
    mat = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n_users, n_items))
    mat.indices = mat.indices.copy()
    # unsorted column indices inside the rows, as a scipy CSR may hold them
    for u in range(n_users):
        s, e = mat.indptr[u], mat.indptr[u + 1]
        mat.indices[s:e] = rng.permutation(mat.indices[s:e])
        mat.data[s:e] = 1.0
    mat.has_sorted_indices = False
    return mat


@pytest.mark.parametrize("build,kind,port_kind", [
    ({}, "bitmap", "bitmap"),
    ({"bitmap_max_bytes": 0}, "btree", "csr"),
    ({"bitmap_max_bytes": 0, "btree_max_degree": 1}, "csr", "csr"),
])
def test_membership_matches_every_jax_build(build, kind, port_kind):
    mat = _membership_matrix()
    theirs = j_build_membership(mat, **build)
    ours = build_membership(mat, **build)
    assert theirs.kind == kind and ours.kind == port_kind
    n_users, n_items = mat.shape
    uu, ii = np.meshgrid(np.arange(n_users), np.arange(n_items), indexing="ij")
    rng = np.random.RandomState(1)
    users = np.concatenate([uu.ravel(), rng.randint(n_users, size=5000)])
    items = np.concatenate([ii.ravel(), rng.randint(n_items, size=5000)])
    want = np.asarray(theirs.query(jnp.asarray(users, jnp.int32), jnp.asarray(items, jnp.int32)))
    got = ours.query(torch.from_numpy(users), torch.from_numpy(items)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: n_users * n_items], mat.toarray().ravel() != 0)


def _chunks(total, verbose=False, max_chunk=None, stop_at=None):
    class Model:
        pass

    model = Model()
    model.verbose = verbose
    calls, reports = [], []

    def run_chunk(state, start, e):
        calls.append((start, e))
        info = {"loss": start + e}
        if stop_at is not None and start + e >= stop_at:
            info["stop"] = True
        return state + e, info

    state = epoch_loop(model, total, run_chunk, 0, on_report=lambda d, i: reports.append(d),
                       max_chunk=max_chunk)
    return state, calls, reports


def test_epoch_loop_chunks_like_the_jax_package():
    assert _chunks(5) == (5, [(0, 5)], [])
    assert _chunks(3, verbose=True) == (3, [(0, 1), (1, 1), (2, 1)], [1, 2, 3])
    assert _chunks(5, max_chunk=2) == (5, [(0, 2), (2, 2), (4, 1)], [])
    assert _chunks(6, max_chunk=1, stop_at=2) == (2, [(0, 1), (1, 1)], [])
    assert _chunks(0) == (0, [], [])


def test_epoch_loop_refuses_checkpointing(tmp_path):
    # checkpointing is ported now: where a user asks for checkpoints, the
    # trainers' epoch loop saves its carry (tests/test_torch_checkpoint.py
    # holds the resumes); with none asked for, it writes nothing
    from cornac_tpu_torch.utils.checkpoint import CheckpointManager, epoch_loop

    for cls in (BPR, MF):
        model = cls(k=4)
        assert model.enable_checkpointing(tmp_path / cls.__name__, every=2) is model
        assert model._ckpt_cfg["every"] == 2 and model._ckpt_cfg["resume"]
        state = (torch.zeros(3),)

        def run_chunk(state, start, e):
            state[0].add_(e)
            return state, None

        out = epoch_loop(model, 5, run_chunk, state)
        assert out[0].tolist() == [5.0] * 3
        assert CheckpointManager(tmp_path / cls.__name__).all_steps() == [2, 4, 5]
        assert model.disable_checkpointing()._ckpt_cfg is None
        epoch_loop(model, 3, run_chunk, state)
        assert CheckpointManager(tmp_path / cls.__name__).all_steps() == [2, 4, 5]


def test_epoch_generator_depends_on_seed_and_global_epoch():
    def draw(seed, epoch):
        return torch.randint(1000, (8,), generator=epoch_generator(seed, epoch, "cpu"))

    assert torch.equal(draw(5, 3), draw(5, 3))
    assert not torch.equal(draw(5, 3), draw(5, 4))
    assert not torch.equal(draw(5, 3), draw(6, 3))


def test_normal_matches_jax():
    for args in (((7, 3), 0.0, 0.01), ((11,), 2.0, 3.0)):
        np.testing.assert_array_equal(normal(*args, random_state=42),
                                      j_normal(*args, random_state=42))
        assert normal(*args, random_state=42).dtype == np.float32


def test_device_broadcast_row():
    out = device_broadcast_row(np.array([3, 1, 2]), 4, "cpu")
    assert out.shape == (4, 3) and out.dtype == torch.float32
    assert torch.equal(out[2], torch.tensor([3.0, 1.0, 2.0]))
