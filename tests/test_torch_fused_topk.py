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
    # the variants are ported (tests below); what is not a variant raises
    for kwargs in ({"precision": "f16"}, {"recall_target": 0.0}, {"recall_target": 1.5}):
        with pytest.raises(ValueError):
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


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("k", [1, 10, 300])
def test_bf16_matches_jax(bias, k):
    # JAX: bf16 operands, float32 accumulation (_fused_topk_xla_bf16). The
    # port rounds the operands to bf16 and runs the exact path: their
    # products are exact in float32, so only the order of the sums differs.
    # Scores within rtol 1e-5 / atol 1e-5; ids equal, except swaps of items
    # whose bf16 scores lie within that tolerance of each other.
    from cornac_tpu.ops.pallas_ranking import _fused_topk_xla_bf16

    U, V, b = _data(B=17, N=2000, d=33, bias=bias, seed=k)
    s, i = fused_topk(U, V, k, bias=b, precision="bf16")
    bj = np.zeros(2000, np.float32) if b is None else b
    s_ref, i_ref = (np.asarray(a) for a in _fused_topk_xla_bf16(U, V, bj, k))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), s_ref, **tol)
    exact = _bf16(U).astype(np.float64) @ _bf16(V).astype(np.float64).T + bj
    rows, cols = np.nonzero(i.numpy() != i_ref)
    np.testing.assert_allclose(exact[rows, i.numpy()[rows, cols]],
                               exact[rows, i_ref[rows, cols]], **tol)
    assert len(rows) <= 2
    # the rounding is real: the f32 path gives other scores
    assert not np.array_equal(s.numpy(), fused_topk(U, V, k, bias=b)[0].numpy())


@pytest.mark.parametrize("k", [1, 2, 7, 64, 199, 200])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_recall_target_matches_jax_on_ties(k, precision):
    # integer scores tie everywhere. The port answers every recall_target
    # with the exact selection, ties to the smaller index, as lax.top_k;
    # recall_target is checked first, so precision does not change the
    # answer (as in JAX). Off the TPU jax.lax.approx_max_k gives lax.top_k's
    # answer, ties included, for 2 <= k < N: there the lists are equal. At
    # k = 1 it keeps the last of the tied items and at k = N it orders ties
    # arbitrarily (ROADMAP.md C): there the scores are equal and each list
    # holds the same items in each run of equal scores.
    from cornac_tpu.ops.pallas_ranking import _fused_topk_xla, _fused_topk_xla_approx

    rng = np.random.RandomState(k)
    N = 200
    U = rng.randint(-1, 2, (9, 5)).astype(np.float32)
    V = rng.randint(-1, 2, (N, 5)).astype(np.float32)
    b = rng.randint(-1, 2, N).astype(np.float32)
    _, i_top = _fused_topk_xla(U, V, b, k)
    for target in (0.5, 0.95):
        s, i = fused_topk(U, V, k, bias=b, recall_target=target, precision=precision)
        s_ref, i_ref = (np.asarray(a) for a in _fused_topk_xla_approx(U, V, b, k, target))
        np.testing.assert_array_equal(s.numpy(), s_ref)
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_top))
        if 2 <= k < N:
            np.testing.assert_array_equal(i.numpy(), i_ref)
        else:
            full = U @ V.T + b
            for row in range(U.shape[0]):
                for score in np.unique(s_ref[row]):
                    at = s_ref[row] == score
                    assert set(i.numpy()[row][at]) <= set(np.flatnonzero(full[row] == score))
                    assert set(i_ref[row][at]) <= set(np.flatnonzero(full[row] == score))
                    assert at.sum() == len(set(i.numpy()[row][at]))
        j_s, j_i = jax_fused_topk(U, V, k, bias=b, recall_target=target, precision=precision)
        np.testing.assert_array_equal(np.asarray(j_i), i_ref)


@pytest.mark.parametrize("measure_model", ["BPR", "COE"])
def test_exact_ann_with_recall_target_matches_jax(measure_model):
    # TPUExactANN(recall_target=0.95): the JAX class answers through
    # approx_max_k (exact off the TPU), the port through its exact path;
    # dot measure (BPR) and L2 (COE)
    from cornac_tpu.data import Dataset as JDataset
    from cornac_tpu.models import BPR as JBPR, COE as JCOE, TPUExactANN as JANN
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.models import BPR, COE, TPUExactANN

    rng = np.random.RandomState(5)
    data = [(f"u{u}", f"i{i}", 1.0) for u, i in
            sorted({(rng.randint(60), rng.randint(90)) for _ in range(900)})]
    cls, j_cls = (BPR, JBPR) if measure_model == "BPR" else (COE, JCOE)
    init = {"U": rng.randn(60, 6).astype(np.float32), "V": rng.randn(90, 6).astype(np.float32)}
    if measure_model == "BPR":
        init["Bi"] = rng.randn(90).astype(np.float32)
    jm = j_cls(k=6, trainable=False, init_params=dict(init)).fit(JDataset.from_uir(data, seed=1))
    pm = cls(k=6, trainable=False, init_params=dict(init)).fit(Dataset.from_uir(data, seed=1))
    jann, pann = JANN(jm, recall_target=0.95), TPUExactANN(pm, recall_target=0.95)
    jann.build_index()
    pann.build_index()
    q = np.asarray(jm.get_user_vectors(), np.float32)[:20]
    # k < N: at k = N approx_max_k orders ties arbitrarily (see above)
    for k in (5, 89):
        ji, jd = jann.knn_query(q, k)
        pi, pd = pann.knn_query(q, k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
