"""The port's fused score + top-k against the JAX package's.

On the CPU the port's ``fused_topk`` runs its plain version; the JAX
function runs its Pallas kernel in interpret mode and its XLA path. Item
indices must be equal exactly, scores to rtol 1e-5 (float32 products
summed in another order). The CUDA kernel itself is held to the plain
version on the card by ``chip_smoke.py`` and by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import cornac_tpu_torch
from cornac_tpu.ops.pallas_ranking import fused_topk as jax_fused_topk
from cornac_tpu_torch.ops.fused_topk import (
    CHUNK, FUSED_TOPK, ROWS, fused_topk, fused_topk_torch, split_plan)

cornac_tpu_torch.set_default_device("cpu")

JAX_PATHS = ["pallas_interpret", "xla"]


def _data(B=13, N=1000, d=16, bias=False, seed=3):
    rng = np.random.RandomState(seed)
    U = rng.randn(B, d).astype(np.float32)
    V = rng.randn(N, d).astype(np.float32)
    b = rng.randn(N).astype(np.float32) if bias else None
    return U, V, b


def _assert_same(port, ref):
    s, i = port
    s_ref, i_ref = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("jax_path", JAX_PATHS)
@pytest.mark.parametrize(
    "B,N,k,bias",
    [
        (13, 1000, 20, False),   # bias off
        (13, 1000, 20, True),    # bias on
        (11, 300, 300, True),    # k = N, B not a multiple of 8
        (3, 50, 200, False),     # k > N: capped at the catalog
    ],
)
def test_matches_jax(jax_path, B, N, k, bias):
    U, V, b = _data(B=B, N=N, bias=bias)
    port = fused_topk(U, V, k, bias=b)
    assert port[1].shape == (B, min(k, N)) and port[1].dtype == torch.int32
    _assert_same(port, jax_fused_topk(U, V, k, bias=b, force=jax_path))


@pytest.mark.parametrize("jax_path", JAX_PATHS)
def test_tie_break_across_tiles(jax_path):
    # the same vector in three tiles of the JAX kernel (tile_n=512) scores
    # identically; both sides must order the ties by ascending item index
    rng = np.random.RandomState(5)
    V = rng.randn(1400, 16).astype(np.float32)
    V[1300] = V[70]
    V[900] = V[70]
    U = rng.randn(6, 16).astype(np.float32)
    port = fused_topk(U, V, 1400)
    _assert_same(port, jax_fused_topk(U, V, 1400, force=jax_path))
    for row in port[1].numpy():
        pos = [int(np.flatnonzero(row == i)[0]) for i in (70, 900, 1300)]
        assert pos == sorted(pos)


@pytest.mark.parametrize("jax_path", JAX_PATHS)
@pytest.mark.parametrize("k", [60, 600])
def test_exact_ties_match_jax(jax_path, k):
    # entries in {-1, 0, 1}: small integer scores, so most items tie with
    # others exactly and the order inside each tie is the whole answer
    rng = np.random.RandomState(11)
    U = rng.randint(-1, 2, (9, 4)).astype(np.float32)
    V = rng.randint(-1, 2, (600, 4)).astype(np.float32)
    _assert_same(fused_topk(U, V, k), jax_fused_topk(U, V, k, force=jax_path))


def test_matches_dense_argsort():
    U, V, _ = _data(B=5, N=300)
    _, i = fused_topk(U, V, 20)
    np.testing.assert_array_equal(i.numpy(), np.argsort(-(U @ V.T), axis=1)[:, :20])


def test_cpu_tensors_take_the_plain_version():
    U, V, b = _data(bias=True)
    before = FUSED_TOPK.launches
    s, i = fused_topk(torch.from_numpy(U), torch.from_numpy(V), 7, bias=torch.from_numpy(b))
    assert FUSED_TOPK.launches == before
    s_ref, i_ref = fused_topk_torch(
        torch.from_numpy(U), torch.from_numpy(V), 7, torch.from_numpy(b)
    )
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


def test_kernel_refuses_cpu_tensors_and_unported_variants():
    U, V, _ = _data()
    with pytest.raises(ValueError):
        fused_topk(U, V, 5, force="kernel")
    with pytest.raises(ValueError):
        FUSED_TOPK(torch.from_numpy(U), torch.from_numpy(V), 5)
    for kwargs in ({"precision": "bf16"}, {"recall_target": 0.95}):
        with pytest.raises(NotImplementedError):
            fused_topk(U, V, 5, **kwargs)
    # partitions is ported: the exact answer, whatever P
    s, i = fused_topk(U, V, 5, partitions=4)
    assert torch.equal(i, fused_topk(U, V, 5)[1])


@pytest.mark.parametrize("P", [2, 3, 7, 400])
@pytest.mark.parametrize("ints", [False, True])
def test_partitions_match_jax(P, ints):
    # the JAX function's two-stage selection (P catalog blocks, then the
    # P*k survivors) is exact; with integer scores ties span the blocks
    rng = np.random.RandomState(P)
    if ints:
        U = rng.randint(-1, 2, (9, 4)).astype(np.float32)
        V = rng.randint(-1, 2, (1000, 4)).astype(np.float32)
    else:
        U, V, _ = _data(B=9, N=1000)
    port = fused_topk(U, V, 40, partitions=P)
    _assert_same(port, jax_fused_topk(U, V, 40, force="xla", partitions=P))
    _assert_same(port, jax_fused_topk(U, V, 40, force="xla"))


@pytest.mark.parametrize("B,N,k,sms,per_sm", [
    (1, 17_700, 100, 132, 2),      # /recommend: one user
    (5, 17_700, 17_700, 132, 3),   # k = N: one slice
    (17, 17_700, 400, 132, 1),     # k above a chunk
    (256, 17_700, 100, 132, 2),
    (8192, 17_700, 100, 132, 2),   # recommend_batch: the row blocks fill the card
    (3, 50, 200, 132, 3),          # k past N (the wrapper caps k first)
    (40, 1_000_000, 10, 16, 2),
    (2, 513, 1, 132, 3),
])
def test_split_plan_invariants(B, N, k, sms, per_sm):
    k = min(k, N)
    S = split_plan(B, N, k, sms, per_sm)
    chunks = -(-N // CHUNK)
    row_blocks = -(-B // ROWS)
    slots = per_sm * sms  # resident blocks of one wave
    assert 1 <= S <= chunks  # every slice holds at least one chunk
    # the merge takes no more candidates per row than the catalog has
    assert S == 1 or S * k <= N
    # one wave: a split grid never queues blocks behind others
    assert S == 1 or S * row_blocks <= slots
    # and it fills the card, unless one slice per chunk or per k items is the limit
    assert (S + 1) * row_blocks > slots or S in (chunks, max(1, N // k))
    if row_blocks >= slots:
        assert S == 1


def test_split_plan_counts_on_count_aware_lists():
    # k above one slice's items: N = 17,700 in 35 chunks over S slices,
    # with k = 400 the slices of one chunk hold 512 items, the last one
    # 292, fewer than k; the kernel pads each slice's list with empty
    # keys, so the merge still finds k items
    S = split_plan(1, 17_700, 400, 132, 2)
    chunks = -(-17_700 // CHUNK)
    last = 17_700 - ((S - 1) * chunks // S) * CHUNK
    assert S == chunks and last < 400
