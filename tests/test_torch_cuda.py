"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and skips without one. The file
imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's ``conftest.py``:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import warnings

import numpy as np
import pytest
import torch

from cornac_tpu_torch.data import Dataset
from cornac_tpu_torch.models import BPR, MF, MMMF, WBPR, BaselineOnly, TPUExactANN
from cornac_tpu_torch.models import ItemKNN, UserKNN
from scipy.sparse import coo_matrix

from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows, accumulate_rows_torch
from cornac_tpu_torch.ops.cosine_topk import (
    COSINE_TOPK, NEG_INF, co_support_cosine, cosine_topk, cosine_topk_sparse, cosine_topk_torch,
    dense_views, scipy_views)
from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(card, *arrays):
    return [None if a is None else torch.from_numpy(a).to(card) for a in arrays]


@pytest.mark.parametrize("k", [1, 100, 600, 3000])
@pytest.mark.parametrize("bias", [False, True])
def test_kernel_matches_plain(card, k, bias):
    rng = np.random.RandomState(k)
    U, V, b = _on(card, rng.randn(77, 51).astype(np.float32),
                  rng.randn(3000, 51).astype(np.float32),
                  rng.randn(3000).astype(np.float32) if bias else None)
    before = FUSED_TOPK.launches
    s, i = fused_topk(U, V, k, bias=b)
    s_ref, i_ref = fused_topk_torch(U, V, k, b)
    torch.cuda.synchronize()
    assert FUSED_TOPK.launches == before + 1
    assert torch.equal(i, i_ref)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [50, 1300])
def test_exact_ties_in_index_order(card, k):
    # entries in {-1, 0, 1}: integer scores, exact in float32 whatever the
    # order of the sums, so the order inside each tie is the whole answer
    rng = np.random.RandomState(11)
    U, V = _on(card, rng.randint(-1, 2, (21, 4)).astype(np.float32),
               rng.randint(-1, 2, (1300, 4)).astype(np.float32))
    s, i = fused_topk(U, V, k)
    s_ref, i_ref = fused_topk_torch(U, V, k)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("B", [1, 5, 17])
@pytest.mark.parametrize("ints", [False, True])
def test_split_kernel_matches_plain(card, B, ints):
    # a catalog of 6 chunks split over 5 slices: the one-chunk slices hold
    # 512 items, fewer than k = 600, so the merge relies on the lists'
    # empty-key padding; integer scores tie across slices
    rng = np.random.RandomState(B)
    if ints:
        U, V = rng.randint(-1, 2, (B, 4)), rng.randint(-1, 2, (3000, 4))
    else:
        U, V = rng.randn(B, 51), rng.randn(3000, 51)
    U, V = _on(card, U.astype(np.float32), V.astype(np.float32))
    assert FUSED_TOPK.plan(U, 3000, 600) == 5
    before = FUSED_TOPK.launches
    s, i = fused_topk(U, V, 600)
    s_ref, i_ref = fused_topk_torch(U, V, 600)
    torch.cuda.synchronize()
    assert FUSED_TOPK.launches == before + 1  # one call, scoring and merge
    assert torch.equal(i, i_ref)
    if ints:
        assert torch.equal(s, s_ref)
    else:
        torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)


def test_kernel_refuses_bad_inputs(card):
    U = torch.zeros(4, 8, device=card)
    V = torch.zeros(16, 8, device=card)
    for args in ((U.double(), V.double(), 3), (U, V[:, :4], 3), (U, V, 17), (U, V.T, 3)):
        with pytest.raises(ValueError):
            FUSED_TOPK(*args)


def test_serving_answers_match_the_cpu(card):
    # quarter-integer factors: every score is exact in float32, so the
    # kernel on the card and the plain version on the CPU must agree
    # item for item, ties included
    rng = np.random.RandomState(3)
    n_users, n_items, k = 120, 900, 6
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(3000)})
    train = Dataset.from_uir([(f"u{u}", f"i{i}", 1.0) for u, i in pairs], seed=1)
    init = {
        "U": rng.randint(-4, 5, (train.num_users, k)).astype(np.float32) / 4,
        "V": rng.randint(-4, 5, (train.num_items, k)).astype(np.float32) / 4,
        "Bi": rng.randint(-4, 5, train.num_items).astype(np.float32) / 4,
    }
    uids = list(train.uid_map)[:50]
    answers = []
    for device in (card, "cpu"):
        bpr = BPR(k=k, trainable=False, init_params=init, device=device).fit(train)
        ann = TPUExactANN(bpr)
        ann.build_index()
        answers.append([
            model.recommend_batch(uids, k=10, remove_seen=seen, train_set=train)
            for model in (bpr, ann) for seen in (False, True)
        ] + [ann.recommend(uids[0], train_set=train)])
    assert answers[0] == answers[1]


def _star_weights(n, m, density, seed, half=False):
    rng = np.random.RandomState(seed)
    values = rng.randint(1, 11, (n, m)) / 2.0 if half else rng.randint(1, 6, (n, m))
    return np.where(rng.rand(n, m) < density, values, 0.0).astype(np.float32)


@pytest.mark.parametrize("n,m,k,exclude_self,half", [
    (300, 500, 20, True, False),    # n not a multiple of the row or column tile
    (300, 500, 299, True, True),    # k = n - 1
    (129, 33, 200, False, False),   # k past n: capped at n; m not a multiple of the slab
    (20, 1, 5, True, True),         # m = 1, n below one tile
])
def test_cosine_kernel_exact_on_star_ratings(card, n, m, k, exclude_self, half):
    # star ratings: every sum is exact, so the neighbour tables must agree
    # index for index, ties (1.0 and 0.0 are everywhere) included
    W = torch.from_numpy(_star_weights(n, m, 0.1, seed=n + m, half=half)).to(card)
    W[7] = 0.0  # an all-zero row
    before = COSINE_TOPK.launches
    s, i = cosine_topk(W, k, exclude_self=exclude_self)
    s_ref, i_ref = cosine_topk_torch(W, min(k, n - 1 if exclude_self else n), exclude_self)
    torch.cuda.synchronize()
    assert COSINE_TOPK.launches == before + 1
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


@pytest.mark.parametrize("exclude_self", [True, False])
def test_cosine_kernel_near_plain_on_centred_data(card, exclude_self):
    rng = np.random.RandomState(4)
    W = rng.randn(260, 90).astype(np.float32)
    W[rng.rand(260, 90) >= 0.25] = 0.0
    for r in range(260):
        nz = W[r] != 0
        if nz.any():
            W[r, nz] -= W[r, nz].mean() - 1e-4
    W = torch.from_numpy(W).to(card)
    s, i = cosine_topk(W, 259, exclude_self=exclude_self)
    s_ref, i_ref = cosine_topk_torch(W, 259, exclude_self)
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-6)
    assert (s < 0).any()
    # an index may differ only where the plain similarities tie within tolerance
    bad = i != i_ref
    near = torch.zeros_like(bad)
    tol = 1e-6 + 1e-5 * s_ref.abs()
    near[:, 1:] |= (s_ref[:, 1:] - s_ref[:, :-1]).abs() <= tol[:, 1:]
    near[:, :-1] |= (s_ref[:, :-1] - s_ref[:, 1:]).abs() <= tol[:, :-1]
    assert bool(near[bad].all())


def test_cosine_kernel_refuses_bad_inputs(card):
    W = torch.zeros(10, 4, device=card)
    views = dense_views(W)
    for args in ((W, 3), (views._replace(row_val=views.row_val.double()), 3),
                 (views._replace(row_ptr=views.row_ptr[:-1]), 3),
                 (dense_views(W.cpu()), 3), (views, 10), (views, 0)):
        with pytest.raises(ValueError):
            COSINE_TOPK(*args)


def test_cosine_kernel_explicit_zeros_and_duplicates(card):
    # explicit zeros, duplicates summing to zero and a value that rounds to
    # 0 in float32 leave the support: the kernel on the scipy matrix's
    # entries equals the plain version on the dense float32 W
    rng = np.random.RandomState(8)
    rows, cols = rng.randint(400, size=6000), rng.randint(300, size=6000)
    vals = rng.randint(0, 6, size=6000).astype(np.float64)  # a sixth are explicit zeros
    rows = np.concatenate([rows, [1, 1, 2]])
    cols = np.concatenate([cols, [299, 299, 299]])
    vals = np.concatenate([vals, [2.0, -2.0, 1e-50]])
    mat = coo_matrix((vals, (rows, cols)), shape=(400, 300))
    before = COSINE_TOPK.launches
    s, i = cosine_topk_sparse(mat, 30, device=card)
    assert COSINE_TOPK.launches == before + 1
    s_ref, i_ref = cosine_topk_torch(scipy_views(mat, card).dense(), 30)
    assert torch.equal(i, i_ref) and torch.equal(s, s_ref)


def test_cosine_kernel_many_ranges(card):
    # n above the rows one pass of shared memory holds: the kernel walks
    # each row's support once per range of candidate rows. The density
    # rises across one range and falls across the next, so the warps' spans
    # (cut by work) do not line up from one range to the next
    n, m, k = 40_000, 32, 12
    C, _ = COSINE_TOPK.plan(n, card)
    ranges = -(-n // C)
    assert ranges >= 2
    starts = np.arange(ranges + 1) * n // ranges  # as ops.cosine_topk.partition cuts
    q = np.searchsorted(starts, np.arange(n), side="right") - 1
    t = (np.arange(n) - starts[q]) / (starts[q + 1] - starts[q])
    density = 0.02 + 0.4 * np.where(q % 2 == 0, t, 1.0 - t)
    W = torch.from_numpy(_star_weights(n, m, density[:, None], seed=5)).to(card)
    s, i = cosine_topk(W, k)
    # the plain version a block of rows at a time: (n, n) is too large to sort whole
    for r0 in range(0, n, 4096):
        rows = torch.arange(r0, min(r0 + 4096, n), device=card)
        sim = co_support_cosine(W[rows], W)
        sim[rows - r0, rows] = NEG_INF
        s_ref, i_ref = torch.sort(sim, dim=1, descending=True, stable=True)
        assert torch.equal(i[rows], i_ref[:, :k].int()) and torch.equal(s[rows], s_ref[:, :k])


def test_cosine_kernel_is_deterministic(card):
    # centred data, where the float32 sums are inexact: the order of the
    # sums is fixed (ascending column), so two launches give the same bits
    rng = np.random.RandomState(9)
    W = rng.randn(700, 900).astype(np.float32)
    W[rng.rand(700, 900) >= 0.2] = 0.0
    views = dense_views(torch.from_numpy(W).to(card))
    first = COSINE_TOPK(views, 50)
    second = COSINE_TOPK(views, 50)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_knn_neighbours_on_the_card_match_the_cpu(card):
    rng = np.random.RandomState(6)
    rows = [(f"u{rng.randint(200)}", f"i{rng.randint(150)}", float(rng.randint(1, 6)))
            for _ in range(3000)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train = Dataset.from_uir(rows, seed=1)
    for cls in (UserKNN, ItemKNN):
        on_card = cls(k=10, verbose=False, device=card).fit(train)
        on_cpu = cls(k=10, verbose=False, device="cpu").fit(train)
        np.testing.assert_array_equal(on_card.sim_mat, on_cpu.sim_mat)
        before = COSINE_TOPK.launches
        ids, sims = on_card.neighbors(num_neighbors=12)
        assert COSINE_TOPK.launches == before + 1
        cpu_ids, cpu_sims = on_cpu.neighbors(num_neighbors=12)
        np.testing.assert_array_equal(ids, cpu_ids)
        np.testing.assert_array_equal(sims, cpu_sims)
        np.testing.assert_allclose(on_card.score_batch(np.arange(20)),
                                   on_cpu.score_batch(np.arange(20)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R,B,d", [
    (17_700, 16_384, 33), (480_000, 16_384, 51), (943, 4_096, 11),
    (300, 20_000, 200),  # long runs, columns past one pass of a warp
    (50, 3_000, None),   # a 1-D table
])
def test_accumulate_kernel_matches_plain(card, R, B, d):
    # the kernel sums each run in batch order and adds the sum once, the
    # plain version's arithmetic on the CPU: the same bits; index_add_ on
    # the card sums with atomics, so there only within the float32 bound of
    # recursive summation, (n + 1) * 2^-24 * (|t| + sum |u|) for n updates
    rng = np.random.RandomState(R + B)
    shape = (R,) if d is None else (R, d)
    table = rng.randn(*shape).astype(np.float32)
    ids = np.where(rng.rand(B) < 0.3, rng.randint(20, size=B), rng.randint(R, size=B))
    updates = rng.randn(B, *shape[1:]).astype(np.float32)
    want = accumulate_rows_torch(torch.from_numpy(table.copy()), torch.from_numpy(ids),
                                 torch.from_numpy(updates))
    got = []
    for _ in range(2):
        t, i, u = _on(card, table.copy(), ids, updates)
        before = ACCUMULATE_ROWS.launches
        got.append(accumulate_rows(t, i, u).cpu())
        assert ACCUMULATE_ROWS.launches == before + 1
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], want)
    t, i, u = _on(card, table.copy(), ids, updates)
    plain = accumulate_rows(t, i, u, force="torch").cpu().numpy().astype(np.float64)
    exact = table.astype(np.float64)
    np.add.at(exact, ids, updates.astype(np.float64))
    count = np.bincount(ids, minlength=R).astype(np.float64)
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, ids, np.abs(updates).astype(np.float64))
    count = count if d is None else count[:, None]
    assert np.all(np.abs(plain - exact) <= 1.01 * (count + 1) * 2.0**-24 * mag)


def test_accumulate_kernel_refuses_bad_inputs(card):
    table = torch.zeros(10, 4, device=card)
    ids = torch.zeros(3, dtype=torch.int32, device=card)
    order = torch.arange(3, device=card)
    upd = torch.zeros(3, 4, device=card)
    for args in ((table.double(), ids, order, upd.double()), (table, ids.long(), order, upd),
                 (table, ids, order.int(), upd), (table, ids, order, upd[:, :2]),
                 (table.cpu(), ids, order, upd), (table, ids[:2], order, upd)):
        with pytest.raises(ValueError):
            ACCUMULATE_ROWS(*args)


@pytest.mark.parametrize("cls", [BPR, WBPR, MMMF, MF, BaselineOnly])
def test_seeded_fits_on_the_card_are_identical(card, cls):
    rng = np.random.RandomState(2)
    pairs = sorted({(rng.randint(300), rng.randint(200)) for _ in range(6000)})
    train = Dataset.from_uir([(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs],
                             seed=1)
    fits = []
    for verbose in (False, True):
        before = ACCUMULATE_ROWS.launches
        fits.append(cls(max_iter=5, batch_size=512, seed=4, verbose=verbose,
                        device=card).fit(train))
        assert ACCUMULATE_ROWS.launches > before
    for name in ("u_factors", "i_factors", "u_biases", "i_biases"):
        if hasattr(fits[0], name):
            np.testing.assert_array_equal(getattr(fits[0], name), getattr(fits[1], name))


def test_epochs_never_sync_with_the_host(card):
    # torch raises on any operation that waits for the card while the sync
    # debug mode is "error": one BPR epoch (bulk and per-minibatch draws,
    # the binary-search membership) and one MF epoch run without one
    from scipy.sparse import csr_matrix

    from cornac_tpu_torch.models import bpr as bpr_mod, mf as mf_mod
    from cornac_tpu_torch.ops.membership import build_membership
    from cornac_tpu_torch.utils.checkpoint import epoch_generator

    rng = np.random.RandomState(1)
    n_users, n_items, n, k = 500, 300, 20_000, 8
    rid, cid = rng.randint(n_users, size=n), rng.randint(n_items, size=n)
    csr = csr_matrix((np.ones(n), (rid, cid)), shape=(n_users, n_items))
    pairs = torch.as_tensor(np.stack([rid, cid], 1), device=card)
    val = torch.as_tensor(rng.randint(1, 6, size=n).astype(np.float32), device=card)
    U, V = rng.randn(n_users, k) * 0.1, rng.randn(n_items, k) * 0.1
    Bu, Bi = np.zeros(n_users), np.zeros(n_items)
    for bitmap_max_bytes, bulk_max in ((None, 1 << 24), (0, 1)):
        membership = build_membership(csr, bitmap_max_bytes=bitmap_max_bytes, device=card)
        tU, tV, gate = bpr_mod._extended_tables(U, V, Bi, True, card)
        old, bpr_mod._BULK_SAMPLING_MAX = bpr_mod._BULK_SAMPLING_MAX, bulk_max
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            draws = bpr_mod._bpr_draws(epoch_generator(5, 0, card), n, 20_480, 1024, n_items, None)
            correct, skipped = bpr_mod._bpr_epoch(tU, tV, draws, pairs, membership, n, 0.01,
                                                  0.01, 1024, gate, "bpr")
        finally:
            torch.cuda.set_sync_debug_mode("default")
            bpr_mod._BULK_SAMPLING_MAX = old
        assert 0 < int(correct) and 480 <= int(skipped)
    mU, mV, u_gate, v_gate = mf_mod._extended_tables(U, V, Bu, Bi, True, card)
    mask = torch.ones(n, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        perm = mf_mod._epoch_permutation(n, epoch_generator(5, 0, card))
        loss = mf_mod._mf_epoch(mU, mV, perm, mask, pairs, val, 0.01, 0.02, 3.0, 1000,
                                u_gate, v_gate)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.isfinite(float(loss))
