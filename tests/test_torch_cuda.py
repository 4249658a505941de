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
from cornac_tpu_torch.models import COE, EASE, IBPR, NMF, PMF, WMF, ItemKNN, OnlineIBPR, UserKNN
from cornac_tpu_torch.models import GMF, MLP, NGCF, BiVAECF, LightGCN, NeuMF, RecVAE, VAECF
from cornac_tpu_torch.models import FM, HPF, SANSA, SKMeans
from scipy.sparse import coo_matrix

from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows, accumulate_rows_torch
from cornac_tpu_torch.ops.canary import CANARY, scale2, scale2_torch
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
    for args in ((U.double(), V.double(), 3), (U, V[:, :4], 3), (U, V, 17), (U, V.T, 3),
                 (U.cpu(), V, 3), (U, V.cpu(), 3), (U, V, 3, torch.zeros(16))):
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


@pytest.mark.parametrize("R,B,d,kind", [
    (17_700, 16_384, 33, "dup"), (480_000, 16_384, 51, "dup"), (943, 4_096, 11, "dup"),
    (300, 20_000, 200, "dup"),  # long runs, four column blocks
    (50, 3_000, None, "dup"),   # a 1-D table
    (64, 40_000, 11, "zipf"),   # a run of ~10,000 ids: longer than a round and the stage
    (1_000_000, 4_096, 33, "dup"),  # hundreds of row ranges
])
def test_accumulate_kernel_matches_plain(card, R, B, d, kind):
    # the kernel sums each row's updates in batch order and adds the sum
    # once, the plain version's arithmetic on the CPU: the same bits;
    # index_add_ on the card sums with atomics, so there only within the
    # float32 bound of recursive summation, (n + 1) * 2^-24 * (|t| + sum |u|)
    # for n updates
    rng = np.random.RandomState(R + B)
    shape = (R,) if d is None else (R, d)
    table = rng.randn(*shape).astype(np.float32)
    if kind == "zipf":
        ids = rng.permutation(R)[np.minimum(rng.zipf(1.3, size=B) - 1, R - 1)]
    else:
        ids = np.where(rng.rand(B) < 0.3, rng.randint(20, size=B), rng.randint(R, size=B))
    if R >= 1_000_000:
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        assert ACCUMULATE_ROWS.plan(R, B, d, card).grid[0] > 4 * sms
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


def test_accumulate_kernel_strided_and_out_of_range_ids(card):
    # a column of (user, item) pairs, as the trainers hand the user ids, with
    # ids outside [0, R) among them: those are dropped, the rest summed as
    # the plain version sums them
    rng = np.random.RandomState(7)
    R, B, d = 5_000, 9_000, 33
    table = rng.randn(R, d).astype(np.float32)
    pairs = np.stack([rng.randint(R, size=B), rng.randint(R, size=B)], 1)
    bad = rng.rand(B) < 0.05
    pairs[bad, 0] = rng.choice([-1, -9, R, R + 5, 2**40], size=int(bad.sum()))
    updates = rng.randn(B, d).astype(np.float32)
    keep = (pairs[:, 0] >= 0) & (pairs[:, 0] < R)
    want = accumulate_rows_torch(torch.from_numpy(table.copy()), torch.from_numpy(pairs[keep, 0]),
                                 torch.from_numpy(updates[keep]))
    t, p, u = _on(card, table.copy(), pairs, updates)
    ids = p[:, 0]
    assert ids.stride(0) == 2
    before = ACCUMULATE_ROWS.launches
    got = accumulate_rows(t, ids, u).cpu()
    assert ACCUMULATE_ROWS.launches == before + 1
    assert torch.equal(got, want)


def test_accumulate_kernel_refuses_bad_inputs(card):
    table = torch.zeros(10, 4, device=card)
    ids = torch.zeros(3, dtype=torch.int64, device=card)
    upd = torch.zeros(3, 4, device=card)
    for args in ((table.double(), ids, upd.double()), (table, ids.int(), upd),
                 (table, ids, upd[:, :2]), (table.cpu(), ids, upd), (table, ids.cpu(), upd),
                 (table, ids[:2], upd), (table[:, ::2], ids, upd[:, :2])):
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


@pytest.mark.parametrize("shape", [(128, 128), (1,), (257,), (3, 1000, 7)])
def test_canary_is_x_times_two(card, shape):
    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(1), device=card)
    before = CANARY.launches
    y = scale2(x)
    torch.cuda.synchronize()
    assert CANARY.launches == before + 1
    assert y.device == x.device and torch.equal(y, scale2_torch(x))
    for bad in (x.double(), x.cpu(), torch.randn(4, 6, device=card).T):
        with pytest.raises(ValueError):
            CANARY(bad)


def test_kernels_launch_on_the_current_stream(card):
    # the wrappers hand C the device index and the current raw stream: on a
    # side stream, each kernel's answer is there once that stream is done
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(300, 70, generator=gen, device=card)
    V = torch.randn(2000, 70, generator=gen, device=card)
    W = (torch.rand(64, 40, generator=gen, device=card) < 0.3).float()
    table = torch.randn(50, 70, generator=gen, device=card)
    ids = torch.randint(50, (300,), generator=gen, device=card)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        doubled = scale2(x)
        top = fused_topk(x, V, 10)
        near = cosine_topk(W, 5)
        summed = accumulate_rows(table.clone(), ids, x)
    side.synchronize()
    assert torch.equal(doubled, scale2_torch(x))
    ref = fused_topk_torch(x, V, 10)
    torch.testing.assert_close(top[0], ref[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(near[1], cosine_topk_torch(W, 5)[1])
    assert torch.equal(summed, accumulate_rows(table.clone(), ids, x))


@pytest.mark.parametrize("bias", [False, True])
def test_inexact_variants_run_the_kernel(card, bias):
    # bf16: the kernel on rounded operands; recall_target: the exact kernel
    rng = np.random.RandomState(4)
    U, V, b = _on(card, rng.randn(33, 40).astype(np.float32), rng.randn(2500, 40).astype(np.float32),
                  rng.randn(2500).astype(np.float32) if bias else None)
    rU, rV = (t.to(torch.bfloat16).float() for t in (U, V))
    before = FUSED_TOPK.launches
    s, i = fused_topk(U, V, 50, bias=b, precision="bf16")
    s_ref, i_ref = fused_topk_torch(rU, rV, 50, b)
    assert FUSED_TOPK.launches == before + 1
    torch.testing.assert_close(s, s_ref, rtol=1e-5, atol=1e-5)
    assert (i != i_ref).float().mean() < 0.01
    for precision in ("f32", "bf16"):  # the variant's launch and the exact one's
        s, i = fused_topk(U, V, 50, bias=b, recall_target=0.95, precision=precision)
        assert torch.equal(i, fused_topk(U, V, 50, bias=b)[1])
    assert FUSED_TOPK.launches == before + 5


def _star_train(seed=2, n_users=300, n_items=200, n=6000):
    rng = np.random.RandomState(seed)
    pairs = sorted({(rng.randint(n_users), rng.randint(n_items)) for _ in range(n)})
    return Dataset.from_uir([(f"u{u}", f"i{i}", float(rng.randint(1, 6))) for u, i in pairs],
                            seed=1)


@pytest.mark.parametrize("make,attrs", [
    (lambda **kw: PMF(max_iter=5, batch_size=512, **kw), ("U", "V")),
    (lambda **kw: NMF(max_iter=5, **kw), ("u_factors", "i_factors", "u_biases", "i_biases")),
    (lambda **kw: WMF(k=8, max_iter=3, **kw), ("U", "V")),
    (lambda **kw: IBPR(k=8, max_iter=3, batch_size=512, **kw), ("U", "V")),
    (lambda **kw: OnlineIBPR(k=8, max_iter=3, batch_size=512, **kw), ("U", "V")),
    (lambda **kw: COE(k=8, max_iter=3, **kw), ("U", "V")),
    (lambda **kw: MF(max_iter=3, optimizer="adam", dropout=0.1, **kw),
     ("u_factors", "i_factors", "u_biases", "i_biases")),
    (lambda **kw: MF(max_iter=3, optimizer="rmsprop", **kw), ("u_factors", "i_factors")),
    (lambda **kw: MF(max_iter=3, optimizer="adagrad", use_bias=False, **kw),
     ("u_factors", "i_factors")),
])
def test_new_seeded_fits_on_the_card_are_identical(card, make, attrs):
    # one chunk, then one-epoch chunks (verbose): the same bits; the
    # gathers' gradients and the SGD updates go through the kernel
    train = _star_train()
    fits = []
    for verbose in (False, True):
        before = ACCUMULATE_ROWS.launches
        fits.append(make(seed=4, verbose=verbose, device=card).fit(train))
        if not isinstance(fits[-1], WMF):
            assert ACCUMULATE_ROWS.launches > before
    for name in attrs:
        assert np.isfinite(getattr(fits[0], name)).all()
        np.testing.assert_array_equal(getattr(fits[0], name), getattr(fits[1], name))


def test_ease_on_the_card_matches_the_cpu(card):
    train = _star_train()
    on_card = EASE(lamb=50, verbose=False, device=card).fit(train)
    again = EASE(lamb=50, verbose=False, device=card).fit(train)
    on_cpu = EASE(lamb=50, verbose=False, device="cpu").fit(train)
    np.testing.assert_array_equal(on_card.B, again.B)
    np.testing.assert_allclose(on_card.B, on_cpu.B, rtol=1e-4, atol=1e-6)
    users = np.arange(0, 300, 7)
    np.testing.assert_allclose(on_card.score_batch(users), on_cpu.score_batch(users),
                               rtol=1e-4, atol=1e-5)


def test_new_epochs_never_sync_with_the_host(card):
    # PMF, MF's optax path with dropout, the triplet models' steps, NMF and
    # the WMF sweeps run under the sync debug mode "error"
    from scipy.sparse import csr_matrix

    from cornac_tpu_torch.models import ibpr as ibpr_mod, mf as mf_mod, nmf as nmf_mod
    from cornac_tpu_torch.models import pmf as pmf_mod, wmf as wmf_mod
    from cornac_tpu_torch.ops.membership import build_membership
    from cornac_tpu_torch.ops.optim import adam
    from cornac_tpu_torch.utils.checkpoint import epoch_generator

    rng = np.random.RandomState(1)
    n_users, n_items, n, k = 500, 300, 20_000, 8
    rid, cid = rng.randint(n_users, size=n), rng.randint(n_items, size=n)
    csr = csr_matrix((np.ones(n, np.float32), (rid, cid)), shape=(n_users, n_items))
    csr.sum_duplicates()
    pairs = torch.as_tensor(np.stack([rid, cid], 1), device=card)
    val = torch.as_tensor(rng.randint(1, 6, size=n).astype(np.float32), device=card)
    mask = torch.ones(n, device=card)
    U = torch.as_tensor(rng.randn(n_users, k).astype(np.float32) * 0.1, device=card)
    V = torch.as_tensor(rng.randn(n_items, k).astype(np.float32) * 0.1, device=card)
    membership = build_membership(csr, device=card)
    groups = [wmf_mod._bucketed_csr(m, k, card) for m in (csr, csr.T.tocsr())]
    counts = [torch.as_tensor(np.bincount(a, minlength=m).astype(np.float32), device=card)
              for a, m in ((rid, n_users), (cid, n_items))]
    params = {name: t.clone().requires_grad_(True) for name, t in (
        ("U", U), ("V", V), ("Bu", torch.zeros(n_users, device=card)),
        ("Bi", torch.zeros(n_items, device=card)))}
    opt = adam(0.01)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gen = epoch_generator(5, 0, card)
        perm = mf_mod._epoch_permutation(n, gen)
        pmf_loss = pmf_mod._pmf_epoch(U.clone(), V.clone(), torch.zeros_like(U),
                                      torch.zeros_like(V), perm, mask, pairs, val / 5, 0.01,
                                      0.01, 0.9, 1000, True)
        state, mf_loss = mf_mod._mf_optax_epoch(params, opt, opt.init(params), perm, mask,
                                                pairs, val, 0.02, 3.0, 1000, True, 0.1, gen)
        tparams = {"U": params["U"], "V": params["V"]}
        tstate = opt.init(tparams)
        m = (~membership.query(pairs[:1000, 0], pairs[1000:2000, 1])).float()
        for distance in ("angular", "euclidean"):
            tstate, tloss = ibpr_mod._triplet_step(tparams, opt, tstate, pairs[:1000, 0],
                                                   pairs[:1000, 1], pairs[1000:2000, 1], m,
                                                   0.001, distance, True)
        nmf_out = nmf_mod._nmf_epochs(U.abs(), V.abs(), torch.zeros(n_users, device=card),
                                      torch.zeros(n_items, device=card), pairs[:, 0],
                                      pairs[:, 1], val, *counts, 0.005, 0.06, 0.06, 0.02, 0.02,
                                      3.0, 2, True)
        wU, wV = wmf_mod._als_sweeps_bucketed(U, V, *groups, 1.0, 0.01, 0.01, 0.01, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for t in (pmf_loss, mf_loss, tloss, *nmf_out, wU, wV):
        assert torch.isfinite(t).all()


NEURAL = [
    (lambda **kw: VAECF(k=8, autoencoder_structure=[32], n_epochs=3, batch_size=64, **kw),
     lambda m: [p for p in m.params.parameters()]),
    (lambda **kw: RecVAE(hidden_dim=32, latent_dim=8, n_epochs=2, batch_size=64, **kw),
     lambda m: [*m.enc.parameters(), *m.dec.parameters()]),
    (lambda **kw: BiVAECF(k=8, n_epochs=3, batch_size=64, **kw),
     lambda m: [torch.as_tensor(m.mu_theta), torch.as_tensor(m.mu_beta)]),
    (lambda **kw: GMF(num_factors=8, num_epochs=2, batch_size=512, **kw),
     lambda m: list(m.params.parameters())),
    (lambda **kw: MLP(layers=(16, 8), num_epochs=2, batch_size=512, **kw),
     lambda m: list(m.params.parameters())),
    (lambda **kw: NeuMF(num_factors=8, layers=(16, 8), num_epochs=2, batch_size=512, **kw),
     lambda m: list(m.params.parameters())),
    (lambda **kw: LightGCN(emb_size=16, num_epochs=2, batch_size=512, **kw),
     lambda m: list(m.params.parameters())),
    (lambda **kw: NGCF(emb_size=16, layer_sizes=[16, 16], num_epochs=2, batch_size=512, **kw),
     lambda m: list(m.params.parameters())),
]


@pytest.mark.parametrize("make,params", NEURAL)
def test_neural_seeded_fits_on_the_card_are_identical(card, make, params):
    # one chunk, then one-epoch chunks (verbose): the same bits; the
    # embedding gathers' gradients go through accumulate_rows
    train = _star_train()
    fits = []
    for verbose in (False, True):
        before = ACCUMULATE_ROWS.launches
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fits.append(make(seed=4, verbose=verbose, device=card).fit(train))
        if isinstance(fits[-1], (GMF, MLP, NeuMF, LightGCN)):
            assert ACCUMULATE_ROWS.launches > before
    for a, b in zip(params(fits[0]), params(fits[1])):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


def test_vaecf_data_modes_on_the_card_are_identical(card, monkeypatch):
    from cornac_tpu_torch.models import vaecf as vaecf_mod

    train = _star_train()
    kw = dict(k=8, autoencoder_structure=[32], n_epochs=2, batch_size=64, seed=4, device=card)
    fits = [VAECF(**kw).fit(train)]
    monkeypatch.setattr(vaecf_mod, "_RESIDENT_BYTES", 0)
    fits.append(VAECF(**kw).fit(train))
    monkeypatch.setattr(vaecf_mod, "_SPARSE_RESIDENT_BYTES", 0)
    fits.append(VAECF(**kw).fit(train))
    assert [f.data_mode for f in fits] == ["resident", "index-resident", "streamed"]
    for other in fits[1:]:
        for a, b in zip(fits[0].params.parameters(), other.params.parameters()):
            assert torch.equal(a, b)


def test_edge_propagation_on_the_card_matches_plain(card):
    # the edge form's forward and backward through gather_rows and
    # accumulate_rows, twice the same bits, within float32 rounding of the
    # plain version (index_add_ and autograd's gather, atomic on the card)
    from cornac_tpu_torch.ops.graph import NormAdjacency, propagate_torch

    train = _star_train()
    adj = NormAdjacency(train, budget_elems=0, device=card)
    gen = torch.Generator(device=card).manual_seed(2)
    ue = torch.randn(train.num_users, 64, generator=gen, device=card)
    ie = torch.randn(train.num_items, 64, generator=gen, device=card)
    outs = []
    for fn in (adj.propagate, adj.propagate,
               lambda u, i: propagate_torch(u, i, adj.edge_u, adj.edge_i, adj.edge_norm)):
        u, i = ue.clone().requires_grad_(True), ie.clone().requires_grad_(True)
        before = ACCUMULATE_ROWS.launches
        a, b = fn(u, i)
        grads = torch.autograd.grad((a * a).sum() + (b * 3).sum(), [u, i])
        outs.append((a.detach(), b.detach(), *grads, ACCUMULATE_ROWS.launches - before))
    assert outs[0][4] == 4 and outs[2][4] == 0
    for x, y in zip(outs[0][:4], outs[1][:4]):
        assert torch.equal(x, y)
    for x, y in zip(outs[0][:4], outs[2][:4]):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("make,attrs", [
    (lambda **kw: HPF(k=5, max_iter=20, **kw), ("Gs", "Gr", "Ls", "Lr")),
    (lambda **kw: HPF(k=5, max_iter=20, hierarchical=False, **kw), ("Gs", "Gr", "Ls", "Lr")),
    (lambda **kw: FM(k2=8, max_iter=3, method="sgd", **kw), ("w", "V")),
    (lambda **kw: FM(k2=8, max_iter=5, method="als", **kw), ("w", "V")),
    (lambda **kw: FM(k2=8, max_iter=5, method="mcmc", **kw), ("w", "V")),
    (lambda **kw: SKMeans(k=5, max_iter=50, **kw), ("centroids", "final_par")),
])
def test_factor_rest_seeded_fits_on_the_card_are_identical(card, make, attrs):
    train = _star_train()
    fits = []
    for _ in range(2):
        before = ACCUMULATE_ROWS.launches
        fits.append(make(seed=4, verbose=False, device=card).fit(train))
        if isinstance(fits[-1], HPF) or getattr(fits[-1], "method", None) == "sgd":
            assert ACCUMULATE_ROWS.launches > before
    for name in attrs:
        assert np.isfinite(getattr(fits[0], name)).all()
        np.testing.assert_array_equal(getattr(fits[0], name), getattr(fits[1], name))


@pytest.mark.parametrize("hierarchical", [True, False])
def test_hpf_on_the_card_matches_the_cpu(card, hierarchical):
    train = _star_train()
    on_card = HPF(k=5, max_iter=3, seed=2, hierarchical=hierarchical, device=card).fit(train)
    on_cpu = HPF(k=5, max_iter=3, seed=2, hierarchical=hierarchical, device="cpu").fit(train)
    for name in ("Gs", "Gr", "Ls", "Lr"):
        np.testing.assert_allclose(getattr(on_card, name), getattr(on_cpu, name), rtol=1e-5,
                                   atol=1e-7)


def test_sansa_scores_on_the_card_match_the_cpu(card):
    train = _star_train()
    on_card = SANSA(l2=20.0, weight_matrix_density=0.05, verbose=False, device=card).fit(train)
    on_cpu = SANSA(l2=20.0, weight_matrix_density=0.05, verbose=False, device="cpu").fit(train)
    users = np.arange(0, 300, 7)
    np.testing.assert_allclose(on_card.score_batch(users), on_cpu.score_batch(users), rtol=1e-9,
                               atol=1e-12)


def test_factor_rest_sweeps_never_sync_with_the_host(card):
    # HPF's CAVI sweeps and FM's SGD epoch, ALS and MCMC sweeps run under
    # the sync debug mode "error"
    from cornac_tpu_torch.models import fm as fm_mod, hpf as hpf_mod
    from cornac_tpu_torch.utils.checkpoint import epoch_generator

    rng = np.random.RandomState(1)
    n_users, n_items, n, k = 500, 300, 20_000, 5
    rid = torch.as_tensor(rng.randint(n_users, size=n), device=card)
    cid = torch.as_tensor(rng.randint(n_items, size=n), device=card)
    val = torch.as_tensor(rng.randint(1, 6, size=n).astype(np.float32), device=card)
    tables = [torch.as_tensor(rng.gamma(0.3, 1.0, size=(rows, k)).astype(np.float32),
                              device=card) for rows in (n_users, n_users, n_items, n_items)]
    ones = [torch.ones(n_users, device=card), torch.ones(n_items, device=card)]
    n_feat = n_users + n_items
    blocks = fm_mod.make_blocks(rid.cpu().numpy(), cid.cpu().numpy() + n_users, n_feat, card)
    w = torch.zeros(n_feat, device=card)
    V = torch.as_tensor(rng.normal(0, 0.1, (n_feat, 8)).astype(np.float32), device=card)
    perm = torch.randperm(n, device=card)
    mask = torch.ones(n, device=card)
    draws = fm_mod.draw_mcmc(epoch_generator(3, 0, card), n, n_feat, 8, card)
    w0 = torch.zeros((), device=card)
    state = fm_mod.mcmc_initial_state(w0, w.clone(), V.clone(), 0.0, 0.0)  # once a fit
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = []
        for hierarchical in (True, False):
            outs += hpf_mod._hpf_cavi(*[t.clone() for t in tables + ones], rid, cid, val, 2,
                                      hierarchical)
        outs += fm_mod._fm_sgd_epoch(w0, w.clone(), V.clone(), perm, blocks[0].ids,
                                     blocks[1].ids, val, mask, 0.01, (0.0, 0.0, 0.0), 1024,
                                     True, True, True)
        outs += fm_mod._fm_als(w0, w.clone(), V.clone(), val, blocks, 0.0, 0.1, 0.1, True, True,
                               True, 1)
        outs += fm_mod._fm_mcmc_sweep(state, draws, val, blocks, 0.0, True, True, True, n_feat)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for t in outs:
        assert torch.isfinite(t).all()


def test_fm_segment_sums_are_deterministic(card):
    # the cumulative sum of 80,000 rows, one and two columns, gives the
    # same bits on every call (a whole-tensor CUDA scan does not)
    from cornac_tpu_torch.models import fm as fm_mod

    rng = np.random.RandomState(3)
    ids = rng.randint(1_700, size=80_000)
    block = fm_mod.make_blocks(ids, ids, 1_700, card)[0]
    for cols in (1, 2):
        x = torch.as_tensor(rng.normal(size=(80_000, cols)).astype(np.float32), device=card)
        first = fm_mod._seg_sum(x, block.perm, block.starts, block.ends)
        for _ in range(20):
            assert torch.equal(fm_mod._seg_sum(x, block.perm, block.starts, block.ends), first)
        exact = torch.zeros(1_700, cols, dtype=torch.float64, device=card).index_add_(
            0, block.ids, x.double())
        assert (first.double() - exact).abs().max().item() < 1e-3
