#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA card and hold its kernels to
their plain PyTorch versions.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # device, builds and kernel-vs-plain only (1-5)

Phases, each of which fails the run when it fails:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``cornac_tpu_torch/csrc/fused_topk.cu``,
   ``cosine_topk.cu`` and ``accumulate_rows.cu`` with nvcc, one process
   each, in parallel, and prints ptxas's registers and spills;
3. fused_topk vs plain: the fused score + top-k kernel against
   ``fused_topk_torch`` on the card, with and without bias, for k in
   {1, 100, 128, 1000, N} and k > N, ties across distant chunks, the
   full serving shape, and small batches whose catalog is split across
   blocks and merged (k above a slice's items, integer ties across
   slices);
4. cosine_topk vs plain: the sparse co-support cosine + top-k kernel
   against ``cosine_topk_torch`` on binary, integer and half-star data
   (exact, index for index), mean-centred data with negative similarities
   (within rtol 1e-5 / atol 1e-6, indices up to near-ties), k = n - 1 and
   k past n, m = 1, all-zero rows, a scipy matrix with explicit zeros and
   duplicates, n above one shared-memory range, and a half-dense matrix
   at the ML-1M widths;
5. accumulate_rows vs plain: the deterministic row-accumulation kernel
   against ``accumulate_rows_torch`` on the card, on duplicate-heavy
   batches (16,384 ids into 17,700 and into 480,000 rows, 4,096 ids into
   943 rows, at d = 11, 33 and 51) and at the four shapes the trainers
   hand it (the U and V updates at the bench shape and at full width),
   within a float32 bound of a float64 sum; two launches must give the
   same bits;
6. BPR serving slice: a BPR model (k=50 + item bias, so d=51) over
   480,000 users and 17,700 items, random factors from the seed, wrapped
   in TPUExactANN, saved, loaded by ``load_model`` and served by the
   standalone HTTP server on localhost (/recommend, /feedback, /evaluate),
   then ``recommend_batch`` for 8,192 users; every answer is checked
   against lists computed from the same vectors with the plain version;
7. KNN slice at the MovieLens 1M widths (6,040 users x 3,706 items,
   1,000,209 seeded whole-star ratings): RatioSplit -> Experiment with
   ItemKNN(k=50) and UserKNN(k=50) on Recall@10, NDCG@10 and AUC ->
   nearest_items / nearest_users (kernel launches, held exactly to the
   plain version) -> the ItemKNN saved and served by the standalone server;
8. related items at the MovieLens 10M widths (69,878 users x 10,677 items,
   10,000,054 seeded half-star ratings): ItemKNN(k=50).fit and
   nearest_items(50) (which builds no dense W: its peak device memory is
   checked), held exactly to the plain version;
9. trainers at the bench.py shape (``make_ml100k_like(seed=7)``, 943 users
   x 1,682 items, 100,000 ratings): RatioSplit(0.2, 4.0, seed=123) ->
   BPR(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01,
   seed=123, batch_size=4096).fit -> ranking_eval (AUC, MAP, NDCG@10, P@10,
   R@10), timed after a one-epoch warm-up; AUC and NDCG@10 must fall in the
   band of the JAX package's CPU runs (``tools/bpr_quality_band.py``); a
   second fit with the same seed and verbose=True must give the same
   factors, bit for bit; then one Experiment with BPR, MMMF, WBPR,
   MF(k=10, max_iter=20), BaselineOnly, GlobalAvg and MostPop on those
   metrics and RMSE, MAE;
10. trainer at full width (``benchmarks/scale_10m.py``'s configuration:
   100,000 users x 10,000 items, about 10M unique seeded pairs, so the
   membership test is the CSR binary search): BPR(k=32, batch_size=16384,
   seed=123), one warm epoch, then 10 timed epochs; samples/s beside the
   byte bound of a sample, launches per minibatch and the device-busy
   share; then ``recommend_batch`` for 8,192 users at k=100 through
   fused_topk, every list held to the plain version;
11. times: each kernel, its plain version and library yardsticks
   (``torch.matmul`` + ``torch.topk``; for the cosine also cuSPARSE
   products through ``torch.sparse``; ``index_add_`` for accumulate_rows)
   with CUDA events, beside the bound; fused_topk at B = 1, 256 and 8192,
   cosine_topk at both ML-1M shapes, a half-dense ML-1M-wide matrix and
   ML-10M, where two launches must give the same bits; accumulate_rows at
   the trainers' four shapes, on the inputs phase 5 checked.

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers (fused_topk once per batch size, B = 8192 first),
and ``{"ok": true, "device": {...}}``. The
script imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

N_USERS, N_ITEMS, FACTORS, TOPK, SERVE_BATCH = 480_000, 17_700, 50, 100, 8192
N_INTERACTIONS = 1_000_000  # Netflix has ~100M; cut so Dataset.build stays quick
RTOL = ATOL = 1e-5
DEV = "cuda"
# benchmarks/scale_10m.py's configuration, the full-width trainer phase
FULL_USERS, FULL_ITEMS, FULL_DRAWS, FULL_K, FULL_BATCH = 100_000, 10_000, 10_000_000, 32, 16_384


def log(msg):
    print(msg, flush=True)


# a copy of bench.py's generator (tests/test_torch_bpr_train.py holds the two
# byte-identical): the script imports nothing of the JAX package's tree
def make_ml100k_like(seed=7):
    """Seeded implicit-feedback data, ML-100K shape, with popularity and
    preference structure (exposure correlates with preference so ranking
    models have signal)."""
    rng = np.random.RandomState(seed)
    n_users, n_items, n_ratings = 943, 1682, 100_000

    item_pop = rng.zipf(1.3, size=n_items).astype(np.float64)
    item_pop /= item_pop.sum()
    u_f = rng.normal(0, 1.0, (n_users, 6))
    i_f = rng.normal(0, 1.0, (n_items, 6))

    data = []
    seen = set()
    while len(data) < n_ratings:
        m = (n_ratings - len(data)) * 2
        users = rng.randint(n_users, size=m)
        items = rng.choice(n_items, size=m, p=item_pop)
        affinity = np.einsum("ij,ij->i", u_f[users], i_f[items])
        keep = rng.rand(m) < 1.0 / (1.0 + np.exp(-affinity))  # exposure ~ preference
        for u, i, a in zip(users[keep], items[keep], affinity[keep]):
            if len(data) == n_ratings:
                break
            if (u, i) in seen:
                continue
            seen.add((u, i))
            r = float(np.clip(np.round(3.5 + a + rng.normal(0, 0.8)), 1, 5))
            data.append((f"u{u}", f"i{i}", r))
    return data


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Clock:
    """Host-clock seconds of named steps, each ending in a synchronise."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn):
        import torch

        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.perf_counter() - t
        return out

    def report(self, what):
        for name, sec in self.seconds.items():
            log(f"  {what}, host clock: {name}: {sec:.3f} s")


def plain_scores(U, V, bias=None):
    """Full float32 (B, N) scores, TF32 off."""
    from cornac_tpu_torch.ops.dispatch import full_f32

    with full_f32():
        s = U @ V.T
    return s if bias is None else s + bias


def compare_topk(ks, ki, ps, pi, S, what, exact=False, rtol=RTOL, atol=ATOL):
    """Hold the kernel's (scores, items) to the plain version's. Unless
    ``exact``, index equality is relaxed only where the plain scores next
    to the position lie within the score tolerance of each other and the
    kernel's item scores (by the plain product ``S``) within it of the
    plain item's. Returns (max abs score error, relaxed positions)."""
    import torch

    k = ki.shape[1]
    if ks.shape != ps[:, :k].shape or not torch.isfinite(ks).all():
        raise AssertionError(f"{what}: bad kernel output {tuple(ks.shape)}")
    err = (ks - ps[:, :k]).abs()
    if exact and not (torch.equal(ks, ps[:, :k]) and torch.equal(ki, pi[:, :k])):
        raise AssertionError(f"{what}: kernel differs from the plain version on exact data "
                             f"(max |err| {err.max().item():.3e})")
    if not torch.all(err <= atol + rtol * ps[:, :k].abs()):
        raise AssertionError(f"{what}: scores differ by up to {err.max().item():.3e}")
    if (torch.sort(ki.long(), dim=1).values.diff(dim=1) == 0).any():
        raise AssertionError(f"{what}: an item appears twice in a row")
    bad = ki != pi[:, :k]
    n_bad = int(bad.sum())
    if n_bad and exact:
        raise AssertionError(f"{what}: {n_bad} item mismatches where scores tie exactly")
    if n_bad:
        tol = atol + rtol * ps.abs()
        near = torch.zeros_like(bad)
        near[:, 1:] |= (ps[:, 1:k] - ps[:, : k - 1]).abs() <= tol[:, 1:k]
        if ps.shape[1] > k:
            near |= (ps[:, : k] - ps[:, 1 : k + 1]).abs() <= tol[:, :k]
        else:
            near[:, : k - 1] |= (ps[:, : k - 1] - ps[:, 1:k]).abs() <= tol[:, : k - 1]
        true_s = S.gather(1, ki.long())
        same = (true_s - ps[:, :k]).abs() <= tol[:, :k]
        if not torch.all(near[bad] & same[bad]):
            raise AssertionError(f"{what}: {n_bad} item mismatches beyond near-ties")
    return err.max().item(), n_bad


def phase_kernel(gen):
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

    def rand(*shape, ints=False):
        if ints:  # entries in {-1, 0, 1}: small integer scores, ties everywhere
            return torch.randint(-1, 2, shape, generator=gen, device=DEV).float()
        return 0.5 * torch.randn(*shape, generator=gen, device=DEV)

    N, d = N_ITEMS, FACTORS + 1
    # (label, B, N, d, k, bias, duplicated vectors, integer entries)
    cases = []
    for bias in (True, False):
        cases.append((f"bias={bias} B=300 k=100", 300, N, d, 100, bias, False, False))
    for k in (1, 100, 128, 1000, N):
        cases.append((f"k={k} B=77", 77, N, d, k, True, False, False))
    cases += [
        ("k>N (k=N+5) B=40", 40, N, d, N + 5, True, False, False),
        ("ties across chunks, k=N B=13", 13, N, d, N, True, True, False),
        ("ties across chunks N=1400 d=16 k=N B=6", 6, 1400, 16, 1400, False, True, False),
        ("integer scores (exact ties) d=4 k=100 B=64", 64, N, 4, 100, False, False, True),
        ("integer scores (exact ties) d=4 k=N B=5", 5, N, 4, N, True, False, True),
        ("N below one chunk N=50 k=200 B=9", 9, 50, d, 200, True, False, False),
        ("d=1 B=33 k=10", 33, N, 1, 10, True, False, False),
        ("d=300 B=40 k=64", 40, N, 300, 64, False, False, False),
        ("B=1 k=100", 1, N, d, TOPK, False, False, False),
        (f"serving shape B={SERVE_BATCH} k={TOPK}", SERVE_BATCH, N, d, TOPK, False, False, False),
        # split across blocks, then merged: one-chunk slices hold 512 items
        ("split B=1 k=600, k above a slice", 1, N, d, 600, True, False, False),
        ("split B=5 integer ties across slices d=4 k=600", 5, N, 4, 600, False, False, True),
        ("split B=17 duplicated vectors k=300", 17, N, d, 300, True, True, False),
        ("split B=16 N=3000 k=N//5, last slice short", 16, 3000, d, 600, False, False, False),
        ("split B=256 k=100", 256, N, d, TOPK, True, False, False),
    ]

    max_err, relaxed = 0.0, 0
    for what, B, n, dd, k, bias, dup, ints in cases:
        U, V = rand(B, dd, ints=ints), rand(n, dd, ints=ints)
        b = rand(n, ints=ints) if bias else None
        if dup:  # the same vector in chunks far apart: exact score ties
            V[n - 100] = V[70]
            V[n // 2 + 3] = V[70]
            if b is not None:
                b[n - 100] = b[n // 2 + 3] = b[70]
        before = FUSED_TOPK.launches
        ks, ki = fused_topk(U, V, k, bias=b, force="kernel")
        torch.cuda.synchronize()
        if FUSED_TOPK.launches != before + 1:
            raise AssertionError(f"{what}: the kernel was not launched")
        k_eff = min(k, n)
        ps, pi = fused_topk_torch(U, V, min(k_eff + 1, n), b)
        S = plain_scores(U, V, b)
        err, n_rel = compare_topk(ks, ki, ps, pi, S, what, exact=ints)
        slices = FUSED_TOPK.plan(U, n, k_eff)
        if what.startswith("split") and slices < 2:
            raise AssertionError(f"{what}: split_plan did not split the catalog")
        if dup and k_eff == n:
            row = ki[0].tolist()
            order = [row.index(i) for i in sorted((70, n // 2 + 3, n - 100))]
            if order != sorted(order):
                raise AssertionError(f"{what}: tied items out of index order")
        max_err, relaxed = max(max_err, err), relaxed + n_rel
        log(f"  {what}: ok (S={slices}, max |err| {err:.3e}, "
            f"near-tie index swaps {n_rel})")
        del U, V, b, ks, ki, ps, pi, S
    log(f"kernel vs plain: ok, {len(cases)} cases, max |err| {max_err:.3e}, "
        f"positions relaxed as near-ties: {relaxed} (tolerance rtol={RTOL} atol={ATOL})")
    return max_err


SIM_RTOL, SIM_ATOL = 1e-5, 1e-6  # similarities on inexact data: f32 sums in another order


def star_weights(n, m, density, kind, gen):
    """(n, m) sparse weights on the card: ``binary`` (every co-rated pair
    has similarity 1.0), ``integer`` 1-5 or ``half_star`` 0.5-5.0, on
    which every sum of the cosine is exact in float32; ``centred``: random
    normals, mean-centred per row, so negative similarities occur."""
    import torch

    mask = torch.rand(n, m, generator=gen, device=DEV) < density
    if kind == "binary":
        vals = torch.ones(n, m, device=DEV)
    elif kind == "integer":
        vals = torch.randint(1, 6, (n, m), generator=gen, device=DEV).float()
    elif kind == "half_star":
        vals = torch.randint(1, 11, (n, m), generator=gen, device=DEV).float() / 2
    else:
        vals = torch.randn(n, m, generator=gen, device=DEV)
    W = torch.where(mask, vals, 0.0)
    if kind == "centred":
        cnt = mask.sum(1, keepdim=True).clamp_min(1)
        W = torch.where(mask, W - (W.sum(1, keepdim=True) / cnt - 1e-4), 0.0)
    return W.contiguous()


def check_cosine(W, k, exclude_self, what, exact):
    """One kernel launch on W against the plain version; returns
    (max abs error, positions relaxed as near-ties)."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import (
        COSINE_TOPK, all_pairs_cosine, cosine_topk, cosine_topk_torch)

    n = W.shape[0]
    cap = n - 1 if exclude_self else n
    before = COSINE_TOPK.launches
    ks, ki = cosine_topk(W, k, exclude_self=exclude_self, force="kernel")
    torch.cuda.synchronize()
    if COSINE_TOPK.launches != before + 1:
        raise AssertionError(f"{what}: the kernel was not launched")
    k_eff = min(k, cap)
    if ks.shape != (n, k_eff):
        raise AssertionError(f"{what}: kernel gave {tuple(ks.shape)}, want {(n, k_eff)}")
    if exclude_self and (ki == torch.arange(n, device=DEV)[:, None]).any():
        raise AssertionError(f"{what}: a row is its own neighbour")
    ps, pi = cosine_topk_torch(W, min(k_eff + 1, cap), exclude_self)
    return compare_topk(ks, ki, ps, pi, all_pairs_cosine(W, exclude_self), what, exact=exact,
                        rtol=SIM_RTOL, atol=SIM_ATOL)


def check_cosine_entries(gen):
    """The sparse entry point on a scipy matrix with explicit zeros,
    duplicates (some summing to 0) and a value that rounds to 0 in
    float32, held exactly to the plain version on the dense float32 W."""
    import torch
    from scipy.sparse import coo_matrix

    from cornac_tpu_torch.models.knn import dense_f32
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK, cosine_topk_sparse, cosine_topk_torch

    rng = np.random.RandomState(int(torch.randint(2**31 - 1, (1,), generator=gen, device=DEV)))
    n, m, nnz = 2000, 1500, 150_000
    rows, cols = rng.randint(n, size=nnz), rng.randint(m, size=nnz)
    vals = rng.randint(0, 6, size=nnz).astype(np.float64)  # a sixth are explicit zeros
    rows = np.concatenate([rows, [1, 1, 2]])
    cols = np.concatenate([cols, [m - 1, m - 1, m - 1]])
    vals = np.concatenate([vals, [2.0, -2.0, 1e-50]])
    mat = coo_matrix((vals, (rows, cols)), shape=(n, m))
    before = COSINE_TOPK.launches
    ks, ki = cosine_topk_sparse(mat, KNN_K, device=DEV)
    torch.cuda.synchronize()
    if COSINE_TOPK.launches != before + 1:
        raise AssertionError("explicit zeros: the kernel was not launched")
    ps, pi = cosine_topk_torch(dense_f32(mat, torch.device(DEV)), KNN_K)
    if not (torch.equal(ks, ps) and torch.equal(ki, pi)):
        raise AssertionError("explicit zeros and duplicates: kernel differs from the plain version")
    log(f"  scipy entries with explicit zeros and duplicates (n={n} m={m} k={KNN_K}): ok, "
        "exact index for index")
    return (ks - ps).abs().max().item()


def plain_topk_by_rows(W, k, block=2048):
    """``cosine_topk_torch(W, k)`` a block of rows at a time, for an n
    whose (n, n) similarity matrix is too large to sort whole: the same
    co-support cosine, diagonal and stable descending sort per row."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import NEG_INF, co_support_cosine

    n = W.shape[0]
    parts_s, parts_i = [], []
    for s in range(0, n, block):
        rows = torch.arange(s, min(s + block, n), device=W.device)
        sim = co_support_cosine(W[rows], W)
        sim[rows - s, rows] = NEG_INF
        v, i = torch.sort(sim, dim=1, descending=True, stable=True)
        parts_s.append(v[:, :k])
        parts_i.append(i[:, :k].to(torch.int32))
    return torch.cat(parts_s), torch.cat(parts_i)


def check_cosine_ranges(gen):
    """n = 40,000 candidate rows, more than one pass of shared memory
    holds, so the kernel walks each row's support once per range. The
    density rises across one range and falls across the next, so the warps'
    spans (cut by work) do not line up from one range to the next. Held
    exactly to the plain version."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK, cosine_topk

    n, m, k = 40_000, 32, 12
    C, _ = COSINE_TOPK.plan(n, DEV)
    ranges = -(-n // C)
    if ranges < 2:
        raise AssertionError(f"n={n} fits one range of C={C} rows: the case tests nothing")
    r = torch.arange(n, device=DEV)
    starts = torch.arange(ranges + 1, device=DEV) * n // ranges  # as ops.cosine_topk.partition cuts
    q = torch.searchsorted(starts, r, right=True) - 1  # the range of row r
    t = (r - starts[q]).float() / (starts[q + 1] - starts[q]).float()
    density = 0.02 + 0.4 * torch.where(q % 2 == 0, t, 1.0 - t)
    mask = torch.rand(n, m, generator=gen, device=DEV) < density[:, None]
    W = torch.where(mask, torch.randint(1, 6, (n, m), generator=gen, device=DEV).float(), 0.0)
    ks, ki = cosine_topk(W, k, force="kernel")
    ps, pi = plain_topk_by_rows(W, k)
    if not (torch.equal(ks, ps) and torch.equal(ki, pi)):
        bad = int((ki != pi).any(1).sum())
        raise AssertionError(f"{ranges} ranges: {bad} rows differ from the plain version")
    log(f"  n={n} m={m} k={k} over {ranges} shared-memory ranges of at most {C} rows, spans "
        "misaligned between ranges: ok, exact index for index")
    return (ks - ps).abs().max().item()


def phase_cosine(gen):
    import torch

    # (label, n, m, density, kind, k, exclude_self)
    cases = [
        ("binary, sims mostly 1.0", 1000, 700, 0.05, "binary", 50, True),
        ("integer 1-5", 1000, 700, 0.05, "integer", 50, True),
        ("half-star", 1000, 700, 0.05, "half_star", 50, True),
        ("integer, exclude_self=False", 1000, 700, 0.05, "integer", 50, False),
        ("centred, negatives, exclude_self=True", 777, 300, 0.2, "centred", 776, True),
        ("centred, negatives, exclude_self=False", 777, 300, 0.2, "centred", 777, False),
        ("k = n - 1", 300, 200, 0.1, "half_star", 299, True),
        ("k past n (capped)", 300, 200, 0.1, "integer", 1000, True),
        ("n = 161", 161, 97, 0.1, "integer", 40, True),
        ("m = 45", 500, 45, 0.1, "integer", 30, True),
        ("m = 1", 400, 1, 0.5, "integer", 20, True),
        ("n = 20, fewer rows than a block has warps x 3", 20, 64, 0.2, "integer", 8, True),
        ("ML-1M item side 3706 x 6040, k=50", 3706, 6040, 0.045, "integer", 50, True),
        ("half dense at the ML-1M item widths", 3706, 6040, 0.5, "integer", 50, True),
    ]
    max_err, relaxed = 0.0, 0
    for what, n, m, density, kind, k, excl in cases:
        W = star_weights(n, m, density, kind, gen)
        W[min(5, n - 1)] = 0.0  # an all-zero row: the first k other rows, similarity 0
        err, n_rel = check_cosine(W, k, excl, what, exact=kind != "centred")
        max_err, relaxed = max(max_err, err), relaxed + n_rel
        log(f"  {what} (n={n} m={m} k={k}): ok (max |err| {err:.3e}, near-tie index swaps {n_rel})")
        del W
    max_err = max(max_err, check_cosine_entries(gen), check_cosine_ranges(gen))
    torch.cuda.empty_cache()
    log(f"cosine kernel vs plain: ok, {len(cases) + 2} cases, max |err| {max_err:.3e}, exact index "
        f"for index on star data, near-tie swaps elsewhere: {relaxed} "
        f"(tolerance rtol={SIM_RTOL} atol={SIM_ATOL})")
    return max_err


def popular_ids(R, B, gen):
    """B row ids in [0, R), duplicate-heavy: rank r comes with probability
    proportional to 1 / (r + 1) (a Zipf-like popularity, as item ids of
    the negatives and positives are), the ranks scattered over the rows."""
    import torch

    p = 1.0 / torch.arange(1, R + 1, device=DEV, dtype=torch.float64)
    ranks = torch.multinomial(p, B, replacement=True, generator=gen)
    return torch.randperm(R, generator=gen, device=DEV)[ranks]


def float32_bound(table, ids, updates):
    """(exact sums in float64, per-entry bound): summing a row's n updates
    in float32 in any order and adding the sum to the table entry t errs by
    at most (n + 1) * 2^-24 * (|t| + sum |u|) (the standard bound of
    recursive summation, with 1% to spare for its second-order term)."""
    import torch

    R = table.shape[0]
    exact = table.double().index_add_(0, ids, updates.double())
    count = torch.zeros(R, dtype=torch.float64, device=DEV).index_add_(
        0, ids, torch.ones(ids.shape[0], dtype=torch.float64, device=DEV))
    mag = table.double().abs().index_add_(0, ids, updates.double().abs())
    return exact, 1.01 * (count + 1)[:, None] * 2.0**-24 * mag


# label (the trainers' shapes, timed later on the same inputs), rows, ids,
# d, the ids' distribution
ACC_CASES = [
    *((None, R, B, d, "popular") for R, B in ((17_700, 16_384), (480_000, 16_384))
      for d in (11, 33, 51)),
    (None, 943, 4_096, 33, "popular"),
    (None, 943, 4_096, 51, "popular"),
    ("full width, V update (positives + negatives)", FULL_ITEMS, 2 * FULL_BATCH, FULL_K + 1,
     "uniform"),
    ("full width, U update", FULL_USERS, FULL_BATCH, FULL_K + 1, "uniform"),
    ("bench shape, V update", 1_682, 2 * 4_096, 11, "popular"),
    ("bench shape, U update", 943, 4_096, 11, "popular"),
]


def phase_accumulate(gen):
    """The row-accumulation kernel against its plain version, both within
    the float32 bound of a float64 sum, on duplicate-heavy batches and at
    the trainers' shapes; two launches must give the same bits. Returns the
    largest |kernel - plain| and the labelled cases' inputs, for timing."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows

    max_err = 0.0
    timed = {}
    for label, R, B, d, kind in ACC_CASES:
        what = f"{B} ids into {R} rows, d={d}" + (f" ({label})" if label else "")
        table = torch.randn(R, d, generator=gen, device=DEV)
        ids = (torch.randint(R, (B,), generator=gen, device=DEV) if kind == "uniform"
               else popular_ids(R, B, gen))
        upd = torch.randn(B, d, generator=gen, device=DEV)
        before = ACCUMULATE_ROWS.launches
        got = [accumulate_rows(table.clone(), ids, upd) for _ in range(2)]
        torch.cuda.synchronize()
        if ACCUMULATE_ROWS.launches != before + 2:
            raise AssertionError(f"{what}: the kernel was not launched")
        if not torch.equal(got[0], got[1]):
            raise AssertionError(f"{what}: two launches of the kernel differ")
        plain = accumulate_rows(table.clone(), ids, upd, force="torch")
        exact, bound = float32_bound(table, ids, upd)
        for name, out in (("kernel", got[0]), ("plain version", plain)):
            over = ((out.double() - exact).abs() - bound).max().item()
            if over > 0:
                raise AssertionError(f"{what}: the {name} is {over:.3e} beyond the float32 bound")
        err = (got[0] - plain).abs().max().item()
        max_err = max(max_err, err)
        runs = torch.unique(ids, return_counts=True)[1]
        log(f"  {what}: ok ({runs.numel()} runs, the longest {int(runs.max())} ids; max |kernel - "
            f"plain| {err:.3e}, both within the float32 bound; two launches bit-identical)")
        if label:
            timed[label] = (table, ids, upd)
        del got, plain, exact, bound
    log(f"accumulate_rows vs plain: ok, {len(ACC_CASES)} cases, max |err| {max_err:.3e}")
    return max_err, timed


def make_slice(seed, work):
    """Seeded BPR factors at the serving width and a train set that holds
    every user and item, then both models saved under ``work``."""
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.models import BPR, TPUExactANN

    rng = np.random.RandomState(seed)
    U = (0.5 * rng.standard_normal((N_USERS, FACTORS))).astype(np.float32)
    V = (0.5 * rng.standard_normal((N_ITEMS, FACTORS))).astype(np.float32)
    Bi = rng.standard_normal(N_ITEMS).astype(np.float32)
    # every user once (in index order), every item once, then random pairs
    users = np.concatenate([
        np.arange(N_USERS), rng.randint(N_USERS, size=N_ITEMS),
        rng.randint(N_USERS, size=N_INTERACTIONS - N_USERS - N_ITEMS),
    ])
    items = np.concatenate([
        rng.randint(N_ITEMS, size=N_USERS), rng.permutation(N_ITEMS),
        rng.randint(N_ITEMS, size=N_INTERACTIONS - N_USERS - N_ITEMS),
    ])
    ratings = rng.randint(1, 6, size=N_INTERACTIONS).astype(float)
    uids = [f"u{u}" for u in range(N_USERS)]
    iids = [f"i{i}" for i in range(N_ITEMS)]
    data = [(uids[u], iids[i], r) for u, i, r in zip(users, items, ratings)]
    t0 = time.perf_counter()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # duplicate pairs are dropped, as designed
        train = Dataset.build(data, seed=seed)
    log(f"  Dataset.build: {train.num_ratings} interactions over {train.num_users} users x "
        f"{train.num_items} items in {time.perf_counter() - t0:.1f} s "
        f"(cut from Netflix's ~100M interactions to keep the build quick)")
    if (train.num_users, train.num_items) != (N_USERS, N_ITEMS):
        raise AssertionError("train set does not cover every user and item")
    # index i of the train set is raw id u{i}/i{i}: the factors line up
    perm_u = np.array([int(u[1:]) for u in train.uid_map])
    perm_i = np.array([int(i[1:]) for i in train.iid_map])
    bpr = BPR(k=FACTORS, trainable=False, seed=seed,
              init_params={"U": U[perm_u], "V": V[perm_i], "Bi": Bi[perm_i]}).fit(train)
    ann = TPUExactANN(bpr)
    ann.build_index()
    paths = {
        "bpr": bpr.save(str(work), save_trainset=True),
        "ann": ann.save(str(work), save_trainset=True),
    }
    # held-out triples for /evaluate: known users and items, unseen pairs
    eu = rng.randint(N_USERS, size=3000)
    ei = rng.randint(N_ITEMS, size=3000)
    csr = train.csr_matrix
    test = [
        (train.user_ids[u], train.item_ids[i], float(rng.randint(1, 6)))
        for u, i in zip(eu, ei) if csr[u, i] == 0
    ][:2000]
    return bpr, ann, train, paths, test


class Served:
    """The port's standalone server for one saved model, on localhost."""

    def __init__(self, model_path, model_class):
        from http.server import ThreadingHTTPServer

        from cornac_tpu_torch.serving.core import load_model
        from cornac_tpu_torch.serving.standalone import make_handler

        os.environ["MODEL_PATH"] = model_path
        os.environ["MODEL_CLASS"] = model_class
        os.environ.pop("TRAIN_SET", None)
        self.model, self.train_set = load_model(".")
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(self.model, self.train_set))
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=600) as resp:
            return json.loads(resp.read())

    def post(self, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            return json.loads(resp.read())

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def reference_lists(U_rows, V, k, seen_rows):
    """Item-index lists from the plain version with the models' seen-item
    filter (over-fetch k + max seen, drop seen, keep k)."""
    import torch

    from cornac_tpu_torch.ops.fused_topk import fused_topk_torch

    fetch = min(k + max((len(s) for s in seen_rows), default=0), V.shape[0])
    _, idx = fused_topk_torch(U_rows, V, fetch)
    out = []
    for row, seen in zip(idx.cpu().numpy(), seen_rows):
        out.append([i for i in row if i not in seen][:k])
    torch.cuda.synchronize()
    return out


def check_lists(got, want, S, what):
    """Item lists equal, up to swaps of items whose plain scores tie within
    the tolerance. Returns the number of relaxed positions."""
    relaxed = 0
    for b, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, dtype=np.int64), np.asarray(w, dtype=np.int64)
        if len(g) != len(w) or len(set(g.tolist())) != len(g):
            raise AssertionError(f"{what}: row {b} has {len(g)} items, want {len(w)} distinct")
        diff = np.flatnonzero(g != w)
        if len(diff):
            sg, sw = S[b, g[diff]], S[b, w[diff]]
            if not np.all(np.abs(sg - sw) <= ATOL + RTOL * np.abs(sw)):
                raise AssertionError(f"{what}: row {b} differs beyond near-ties")
            relaxed += len(diff)
    return relaxed


def phase_slice(seed, work):
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    t0 = time.perf_counter()
    bpr, ann, train, paths, test = make_slice(seed, work)
    log(f"  models built and saved in {time.perf_counter() - t0:.1f} s")
    os.chdir(work)  # /feedback appends to data/feedback.csv under the cwd
    servers = [Served(paths["ann"], "cornac_tpu_torch.models.TPUExactANN"),
               Served(paths["bpr"], "cornac_tpu_torch.models.BPR")]
    ann_srv, bpr_srv = servers
    csr = train.csr_matrix
    rng = np.random.RandomState(seed + 1)
    ask = [train.user_ids[u] for u in rng.randint(N_USERS, size=3)]
    batch_users = [train.user_ids[u] for u in rng.choice(N_USERS, SERVE_BATCH, replace=False)]
    try:
        # ---- the main path, counted ----
        timed = Clock()
        FUSED_TOPK.launches = 0
        answers = {
            "k100": timed("ANN /recommend k=100",
                          lambda: ann_srv.get(f"/recommend?uid={ask[0]}&k={TOPK}")),
            "k100_seen": timed("ANN /recommend k=100 remove_seen", lambda: ann_srv.get(
                f"/recommend?uid={ask[1]}&k={TOPK}&remove_seen=true")),
            "all": timed("ANN /recommend (no k: whole catalog)",
                         lambda: ann_srv.get(f"/recommend?uid={ask[2]}")),
            "bpr": timed("BPR /recommend k=100",
                         lambda: bpr_srv.get(f"/recommend?uid={ask[0]}&k={TOPK}")),
        }
        feedback = timed("BPR /feedback", lambda: bpr_srv.post(
            f"/feedback?uid={ask[0]}&iid={train.item_ids[0]}&rating=5"))
        evaluated = timed("BPR /evaluate", lambda: bpr_srv.post(
            "/evaluate", {"metrics": ["RMSE()", "Recall(k=10)"], "data": test}))
        batch_recs = timed(f"BPR.recommend_batch {SERVE_BATCH} users k={TOPK}",
                           lambda: bpr.recommend_batch(batch_users, k=TOPK))
        launches = FUSED_TOPK.launches
        timed.report("main path")
        log(f"  main path: {sum(timed.seconds.values()):.2f} s, fused_topk launches {launches}")
        if launches <= 0:
            raise AssertionError("the main path never launched the fused_topk kernel")
    finally:
        for s in servers:
            s.close()

    # ---- check every answer against the plain version ----
    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(bpr.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(bpr.get_item_vectors(), np.float32), device=dev)
    iid = train.iid_map
    relaxed = 0

    def seen_of(u):
        return set(csr.getrow(u).indices.tolist())

    for key, uid, k, remove in (("k100", ask[0], TOPK, False), ("k100_seen", ask[1], TOPK, True),
                                ("all", ask[2], N_ITEMS, False), ("bpr", ask[0], TOPK, False)):
        u = train.uid_map[uid]
        got = [[iid[i] for i in answers[key]["recommendations"]]]
        want = reference_lists(Ud[[u]], Vd, k, [seen_of(u) if remove else set()])
        S = plain_scores(Ud[[u]], Vd).cpu().numpy()
        relaxed += check_lists(got, want, S, f"/recommend {key}")
    users = np.array([train.uid_map[u] for u in batch_users])
    got = [[iid[i] for i in row] for row in batch_recs]
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    S = plain_scores(Ud[users], Vd).cpu().numpy()
    relaxed += check_lists(got, want, S, "recommend_batch")
    if feedback.get("message") != "Feedback added":
        raise AssertionError(f"/feedback answered {feedback}")
    res = evaluated["result"]
    recall, rmse = res["Recall@10"], res["RMSE"]
    want_recall = reference_recall(bpr, csr, test, train, 10)
    if not (np.isfinite(rmse) and rmse > 0 and abs(recall - want_recall) <= 1e-6):
        raise AssertionError(f"/evaluate answered {res}, plain Recall@10 {want_recall}")
    log(f"  /evaluate: RMSE {rmse:.4f}, Recall@10 {recall:.6f} (plain {want_recall:.6f}) "
        f"over {len(evaluated['user_result']['RMSE'])} users")
    log(f"slice: ok, answers match the plain version (positions relaxed as near-ties: {relaxed})")
    device_share(f"recommend_batch {SERVE_BATCH} users",
                 lambda: bpr.recommend_batch(batch_users, k=TOPK))
    return launches, bpr, users


def profile_call(fn):
    """One call of ``fn`` under torch.profiler: (host-clock ms, summed time
    of the device-side events (kernels, copies) in ms, their count, the
    events). Host-side ops (``aten::topk``) are left out, since their
    device time is that of the kernels they launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    return wall_ms, busy_ms, sum(e.count for e in events), events


def top_ops(events, n=4):
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
    return ", ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms" for e in top)


def device_share(label, fn):
    """Device-busy share of one warm call of ``fn``: the device-side time
    the profiler saw over the call's host-clock duration."""
    fn()  # warm
    wall_ms, busy_ms, _, events = profile_call(fn)
    if not events:
        log(f"  profile, {label}: the profiler saw no device time (device share not measured)")
        return
    log(f"  profile, {label}: {wall_ms:.1f} ms host clock, "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.2f}%); top device ops: "
        + top_ops(events))


def reference_recall(bpr, csr, test, train, k):
    """Recall@k per test user, averaged, from plain scores with train items
    excluded (the eval loop's candidate rule, rating threshold 1)."""
    import torch

    by_user = {}
    for uid, iid, _ in test:
        by_user.setdefault(train.uid_map[uid], set()).add(train.iid_map[iid])
    users = sorted(by_user)
    U, V, Bi = (torch.as_tensor(a, device=DEV)
                for a in (bpr.u_factors[users], bpr.i_factors, bpr.i_biases))
    S = plain_scores(U, V, Bi)
    for b, u in enumerate(users):
        S[b, torch.as_tensor(csr.getrow(u).indices, device=S.device, dtype=torch.long)] = -torch.inf
    top = torch.sort(S, dim=1, descending=True, stable=True).indices[:, :k].cpu().numpy()
    return float(np.mean([len(set(top[b].tolist()) & by_user[u]) / len(by_user[u])
                          for b, u in enumerate(users)]))


# MovieLens 1M and 10M widths; the ratings are generated from the seed
ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS, ML1M_MAX_DEGREE = 6_040, 3_706, 1_000_209, 2_314
ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS = 69_878, 10_677, 10_000_054
KNN_K = 50


def ml1m_triples(seed):
    """(user, item, whole-star rating) triples at the MovieLens 1M widths:
    every user rates at least 20 items (heavy-tailed activity, at most
    2,314 as in ML-1M), items are drawn by a Zipf-like popularity without
    replacement per user (Gumbel top-k), ratings 1-5 from user and item
    offsets plus noise."""
    rng = np.random.RandomState(seed)
    n_u, n_i, total = ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS
    weights = rng.lognormal(0.0, 1.2, n_u)
    deg = 20 + np.floor(weights / weights.sum() * (total - 20 * n_u)).astype(np.int64)
    deg = np.minimum(deg, ML1M_MAX_DEGREE)
    while deg.sum() < total:
        room = np.flatnonzero(deg < ML1M_MAX_DEGREE)
        deg[rng.choice(room, size=min(total - deg.sum(), len(room)), replace=False)] += 1
    logp = -0.8 * np.log(np.arange(1, n_i + 1))
    users, items = [], []
    for s0 in range(0, n_u, 512):
        block = np.arange(s0, min(s0 + 512, n_u))
        order = np.argsort(-(logp[None, :] + rng.gumbel(size=(len(block), n_i))), axis=1)
        for b, u in enumerate(block):
            items.append(order[b, : deg[u]])
            users.append(np.full(deg[u], u))
    users, items = np.concatenate(users), np.concatenate(items)
    ub, ib = rng.normal(0, 0.5, n_u), rng.normal(0, 0.6, n_i)
    r = np.clip(np.rint(3.6 + ub[users] + ib[items] + rng.normal(0, 0.9, total)), 1, 5)
    perm = rng.permutation(total)
    uids = [f"u{u}" for u in range(n_u)]
    iids = [f"i{i}" for i in range(n_i)]
    return [(uids[u], iids[i], float(x)) for u, i, x in zip(users[perm], items[perm], r[perm])]


def ml10m_dataset(seed):
    """A ``Dataset`` at the MovieLens 10M widths straight from seeded numpy
    arrays: 10,000,054 distinct (user, item) pairs (duplicates dropped
    in draw order), heavy-tailed user activity, Zipf-like item popularity,
    half-star ratings 0.5-5.0."""
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    rng = np.random.RandomState(seed + 10)
    n_u, n_i, n_r = ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS
    act = rng.lognormal(0.0, 1.0, n_u)
    pop = np.arange(1, n_i + 1) ** -0.8
    draw = int(n_r * 1.4)  # about 1 in 6 of the first draws repeats a pair
    u = rng.choice(n_u, size=draw, p=act / act.sum())
    i = rng.choice(n_i, size=draw, p=pop / pop.sum())
    _, first = np.unique(u.astype(np.int64) * n_i + i, return_index=True)
    if len(first) < n_r:
        raise AssertionError(f"only {len(first)} distinct pairs drawn")
    keep = np.sort(first)[:n_r]
    return Dataset(
        num_users=n_u, num_items=n_i,
        uid_map=OrderedDict((x, x) for x in range(n_u)),
        iid_map=OrderedDict((x, x) for x in range(n_i)),
        uir_tuple=(u[keep].astype(np.int64), i[keep].astype(np.int64),
                   rng.randint(1, 11, size=n_r) / 2.0),
        seed=seed,
    )


def check_neighbours(model, ids, sims, what):
    """A model's neighbour table (from the kernel) equal, index for index
    and bit for bit, to the plain version on the same weight matrix;
    returns that matrix, on the card."""
    import torch

    from cornac_tpu_torch.models.knn import dense_f32
    from cornac_tpu_torch.ops.cosine_topk import cosine_topk_torch

    W = dense_f32(model._weight_mat, torch.device(DEV))
    ps, pi = cosine_topk_torch(W, ids.shape[1])
    if not np.array_equal(ids, pi.cpu().numpy()):
        raise AssertionError(f"{what}: {int((ids != pi.cpu().numpy()).sum())} neighbour "
                             "indices differ from the plain version")
    if not np.array_equal(sims, ps.cpu().numpy().astype(np.float64)):
        raise AssertionError(f"{what}: neighbour similarities differ from the plain version")
    log(f"  {what}: {ids.shape[0]} x {ids.shape[1]} table equal to the plain version, "
        f"index for index")
    return W


def phase_knn_ml1m(seed, work):
    """RatioSplit -> Experiment(ItemKNN, UserKNN) -> nearest_items /
    nearest_users -> save -> the standalone server, at the ML-1M widths."""
    import torch

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, NDCG, Recall
    from cornac_tpu_torch.models import ItemKNN, UserKNN
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    data = clock("generate 1,000,209 ratings (set-up)", lambda: ml1m_triples(seed))
    iknn, uknn = ItemKNN(k=KNN_K, verbose=False), UserKNN(k=KNN_K, verbose=False)

    # ---- the main path, counted ----
    COSINE_TOPK.launches = FUSED_TOPK.launches = 0
    split = clock("RatioSplit", lambda: RatioSplit(
        data, test_size=0.2, rating_threshold=4.0, exclude_unknowns=True, seed=123))
    exp = Experiment(split, [iknn, uknn], [Recall(k=10), NDCG(k=10), AUC()])
    clock("Experiment.run (fit + ranking eval, both models)", exp.run)
    item_nn = clock("ItemKNN.nearest_items(50)", lambda: iknn.nearest_items(num_neighbors=KNN_K))
    user_nn = clock("UserKNN.nearest_users(50)", lambda: uknn.nearest_users(num_neighbors=KNN_K))
    path = clock("ItemKNN.save", lambda: iknn.save(str(work / "knn")))
    rng = np.random.RandomState(seed + 2)
    ask = [iknn.user_ids[u] for u in rng.choice(iknn.num_users, 4, replace=False)]
    srv = clock("load_model + start the server", lambda: Served(path, "cornac_tpu_torch.models.ItemKNN"))
    try:
        answers = [clock(f"ItemKNN /recommend uid={uid} k=10",
                         lambda uid=uid: srv.get(f"/recommend?uid={uid}&k=10")) for uid in ask]
    finally:
        srv.close()
    launches, fused = COSINE_TOPK.launches, FUSED_TOPK.launches
    clock.report("KNN main path")
    log(f"  KNN main path (ML-1M): {sum(clock.seconds.values()):.2f} s, cosine_topk launches "
        f"{launches}, fused_topk launches {fused}")
    if launches < 2:
        raise AssertionError("nearest_items / nearest_users did not launch the cosine kernel")

    # ---- check what came out ----
    for res in exp.result:
        vals = [v for k, v in res.metric_avg_results.items() if "(s)" not in k]
        if len(vals) != 3 or not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"{res.model_name}: bad metrics {res.metric_avg_results}")
    log("  metric table (ML-1M widths, seeded ratings):\n" + str(exp.result).rstrip())
    W_items = check_neighbours(iknn, *item_nn, "ItemKNN.nearest_items")
    W_users = check_neighbours(uknn, *user_nn, "UserKNN.nearest_users")
    inv = {v: k for k, v in iknn.iid_map.items()}
    for uid, ans in zip(ask, answers):
        scores = iknn.score_batch(np.array([iknn.uid_map[uid]]))[0]
        got = np.array([iknn.iid_map[i] for i in ans["recommendations"]])
        want = np.argsort(-scores, kind="stable")[:10]
        # np.argsort in rank() is not stable: equal scores may come in any order
        if len(set(got.tolist())) != 10 or not np.array_equal(scores[got], scores[want]):
            raise AssertionError(f"/recommend uid={uid}: {[inv[i] for i in got]} is not a "
                                 f"best-10 ranking of score_batch")
    log(f"  served ItemKNN: {len(ask)} /recommend answers equal to a stable ranking of score_batch")
    batch = np.arange(256)  # one eval batch scores users like this, 16 per device call
    for model in (iknn, uknn):
        device_share(f"{model.name}.score_batch of 256 users", lambda m=model: m.score_batch(batch))
    log(f"KNN slice (ML-1M): ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, W_items, W_users


def phase_knn_ml10m(seed):
    """ItemKNN(k=50).fit + nearest_items(50) at the ML-10M widths."""
    import torch

    from cornac_tpu_torch.models import ItemKNN
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK

    clock = Clock()
    train = clock("Dataset from numpy (set-up)", lambda: ml10m_dataset(seed))
    model = ItemKNN(k=KNN_K, verbose=False)

    # ---- the main path, counted ----
    COSINE_TOPK.launches = 0
    clock("ItemKNN.fit", lambda: model.fit(train))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ids, sims = clock("ItemKNN.nearest_items(50)", lambda: model.nearest_items(num_neighbors=KNN_K))
    peak = torch.cuda.max_memory_allocated() - held
    launches = COSINE_TOPK.launches
    clock.report("related items")
    dense_bytes = 4 * train.num_items * train.num_users
    log(f"  nearest_items(50): peak device memory {peak / 1e9:.3f} GB above what the fit left, "
        f"against {dense_bytes / 1e9:.3f} GB for a dense float32 W")
    if peak >= dense_bytes:
        raise AssertionError("nearest_items built a dense W on the card")
    log(f"  related items (ML-10M): {train.num_ratings} ratings, {train.num_users} users x "
        f"{train.num_items} items, ui_centered {model.ui_centered.nbytes / 1e9:.2f} GB and "
        f"sim_mat {model.sim_mat.nbytes / 1e9:.2f} GB float64 on the host; cosine_topk launches "
        f"{launches}")
    if launches < 1:
        raise AssertionError("nearest_items did not launch the cosine kernel")
    W = check_neighbours(model, ids, sims, "ItemKNN.nearest_items (ML-10M)")
    log(f"related items (ML-10M): ok in {sum(clock.seconds.values()):.1f} s")
    from cornac_tpu_torch.models.knn import compute_similarity

    part = Clock()  # where the fit's time goes: the similarity matrix alone
    part("compute_similarity (dense W on the card, 6 x 3 products, to host f64)",
         lambda: compute_similarity(model._weight_mat))
    part.report("ItemKNN.fit part")
    return launches, W


# tools/bpr_quality_band.py on a CPU: the JAX package's fits of bench.py's
# configuration with BPR seeds 123-127, the mean and spread (sample
# standard deviation) of each metric. The port's fit must land within three
# spreads of the mean.
QUALITY_BAND = {"AUC": (0.9336642863641741, 5.575300253011466e-05),
                "NDCG@10": (0.1627065971857164, 0.0029556236688647887)}
BENCH_R05 = {"AUC": 0.9331, "NDCG@10": 0.1694}  # BENCH_r05.json: the TPU run, its W16 path
BENCH_BPR = dict(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01, seed=123,
                 batch_size=4096)


def ranking_quality(model, split):
    """bench.py's metrics of ``model`` on the split's test users."""
    from cornac_tpu_torch.eval_methods.base_method import ranking_eval
    from cornac_tpu_torch.metrics import AUC, MAP, NDCG, Precision, Recall

    metrics = [AUC(), MAP(), NDCG(k=10), Precision(k=10), Recall(k=10)]
    avg, _ = ranking_eval(model, metrics, split.train_set, split.test_set,
                          rating_threshold=4.0, exclude_unknowns=True)
    return {m.name: float(a) for m, a in zip(metrics, avg)}


def epoch_profile(fit, n_batches, epochs):
    """Device-busy share and device events per minibatch of ``epochs``
    epochs: profiles of a fit of ``epochs`` epochs and of one of none
    (the fit's set-up alone), differenced."""
    one = profile_call(lambda: fit(0))
    more = profile_call(lambda: fit(epochs))
    wall, busy = more[0] - one[0], more[1] - one[1]
    return dict(wall_ms=wall, busy_ms=busy, share=busy / wall,
                launches_per_minibatch=(more[2] - one[2]) / (epochs * n_batches),
                top=top_ops(more[3]))


def phase_trainer_bench(bench_data):
    """RatioSplit -> BPR.fit -> ranking_eval at the bench.py shape, the
    quality band, a verbose refit bit for bit, then an Experiment with the
    other trainers and the baselines. ``bench_data()`` gives
    ``make_ml100k_like(seed=7)``'s triples."""
    import contextlib
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, MAE, MAP, NDCG, RMSE, Precision, Recall
    from cornac_tpu_torch.models import BPR, MF, MMMF, WBPR, BaselineOnly, GlobalAvg, MostPop
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    clock = Clock()
    data = clock("make_ml100k_like(seed=7) (set-up; what is left of it, made in a second "
                 "process)", bench_data)
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        data, test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    clock("BPR.fit, 1 epoch (warm-up)", lambda: BPR(**{**BENCH_BPR, "max_iter": 1}).fit(train))
    bpr = clock("BPR.fit", lambda: BPR(**BENCH_BPR).fit(train))
    quality = clock("ranking_eval (AUC, MAP, NDCG@10, P@10, R@10)",
                    lambda: ranking_quality(bpr, split))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        again = clock("BPR.fit, verbose=True",
                      lambda: BPR(**BENCH_BPR, verbose=True).fit(train))
    exp = Experiment(split, [
        BPR(**BENCH_BPR), MMMF(**{**BENCH_BPR, "lambda_reg": 0.001}), WBPR(**BENCH_BPR),
        MF(k=10, max_iter=20, seed=123),
        BaselineOnly(seed=123), GlobalAvg(), MostPop(),
    ], [AUC(), MAP(), NDCG(k=10), Precision(k=10), Recall(k=10), RMSE(), MAE()])
    clock("Experiment.run (7 models)", exp.run)
    launches = ACCUMULATE_ROWS.launches
    clock.report("trainers at the bench shape")
    train_s = clock.seconds["BPR.fit"]
    test_s = clock.seconds["ranking_eval (AUC, MAP, NDCG@10, P@10, R@10)"]
    log(f"  BPR at the bench shape: train {train_s:.3f} s, test {test_s:.3f} s (host clock, after "
        f"a 1-epoch warm-up); " + ", ".join(f"{k} {v:.4f}" for k, v in quality.items())
        + f"; accumulate_rows launches {launches}")
    if launches <= 0:
        raise AssertionError("the trainers never launched the accumulate_rows kernel")

    # ---- check what came out ----
    for name in ("AUC", "NDCG@10"):
        mean, spread = QUALITY_BAND[name]
        lo, hi = mean - 3 * spread, mean + 3 * spread
        log(f"  {name} {quality[name]:.6f}: band [{lo:.6f}, {hi:.6f}] (JAX package on a CPU, "
            f"mean {mean:.6f} +/- 3 x {spread:.3e}); BENCH_r05.json (TPU) {BENCH_R05[name]} is "
            + ("inside" if lo <= BENCH_R05[name] <= hi else "outside") + " the band")
        if not lo <= quality[name] <= hi:
            raise AssertionError(f"bench-shape {name} {quality[name]:.6f} is outside its band")
    for name in ("u_factors", "i_factors", "i_biases"):
        if not np.array_equal(getattr(bpr, name), getattr(again, name)):
            raise AssertionError(f"two seeded fits differ in {name} (one verbose)")
    lines = out.getvalue().strip().splitlines()
    epochs = BENCH_BPR["max_iter"]
    if len(lines) != epochs + 1 or not lines[-2].startswith(f"Epoch {epochs}/{epochs}, correct: "):
        raise AssertionError(f"verbose fit printed {len(lines)} lines, the last {lines[-2:]}")
    log(f"  two seeded fits, one verbose (chunks of one epoch): factors identical, bit for bit; "
        f"its last report: {lines[-2]}")
    for res in exp.result:
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        bad = [k for k, v in vals.items() if not np.isfinite(v)
               or (k not in ("RMSE", "MAE") and not 0.0 <= v <= 1.0)]
        if len(vals) != 7 or bad:
            raise AssertionError(f"{res.model_name}: bad metrics {res.metric_avg_results}")
    n_batches = -(-train.num_ratings // BENCH_BPR["batch_size"])
    prof = epoch_profile(lambda e: BPR(**{**BENCH_BPR, "max_iter": e}).fit(train), n_batches, 10)
    log(f"  profile, 10 BPR epochs at the bench shape (a 10-epoch fit minus a 0-epoch fit): "
        f"{prof['wall_ms']:.1f} ms host clock, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['share']:.2f}%), {prof['launches_per_minibatch']:.1f} device events per "
        f"minibatch; top device ops: {prof['top']}")
    log(f"trainers at the bench shape: ok in {sum(clock.seconds.values()):.1f} s")
    return launches, dict(quality=quality, train_s=train_s, test_s=test_s, **prof)


def scale_10m_dataset():
    """``benchmarks/scale_10m.py``'s data: 10M uniform (user, item) draws
    from RandomState(0) over 100,000 x 10,000, duplicates dropped."""
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    rng = np.random.RandomState(0)
    u = rng.randint(FULL_USERS, size=FULL_DRAWS)
    i = rng.randint(FULL_ITEMS, size=FULL_DRAWS)
    _, first = np.unique(u.astype(np.int64) * FULL_ITEMS + i, return_index=True)
    u, i = u[first], i[first]
    return Dataset(
        num_users=FULL_USERS, num_items=FULL_ITEMS,
        uid_map=OrderedDict((x, x) for x in range(FULL_USERS)),
        iid_map=OrderedDict((x, x) for x in range(FULL_ITEMS)),
        uir_tuple=(u.astype(np.int64), i.astype(np.int64), np.ones(len(u))),
        seed=0,
    )


def sample_bytes(csr, k):
    """The least bytes one BPR sample moves: the (user, item) pair (8), the
    membership probe (the user's row bounds, 8, and one 4-byte index per
    step of a binary search over the row, averaged over samples, which
    pick users in proportion to their degree), and the three factor rows
    (k + 1 floats with the bias) read and written once each."""
    deg = np.diff(csr.indptr).astype(np.float64)
    steps = np.ceil(np.log2(deg + 1))
    probe = 8.0 + 4.0 * float((deg * steps).sum() / deg.sum())
    return 8.0 + probe + 3 * 2 * (k + 1) * 4.0, probe


def phase_trainer_full(seed):
    """BPR at benchmarks/scale_10m.py's configuration: one warm epoch, ten
    timed, samples/s beside the byte bound, the busy share of an epoch;
    then recommend_batch for 8,192 users through fused_topk, held to the
    plain version."""
    import torch

    from cornac_tpu_torch.models import BPR
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    ds = clock("scale_10m data (set-up)", scale_10m_dataset)
    n = ds.num_ratings
    kw = dict(k=FULL_K, batch_size=FULL_BATCH, seed=123)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    clock("BPR.fit, 1 epoch (warm)", lambda: BPR(max_iter=1, **kw).fit(ds))
    clock("BPR.fit, 1 epoch", lambda: BPR(max_iter=1, **kw).fit(ds))
    model = clock("BPR.fit, 11 epochs", lambda: BPR(max_iter=11, **kw).fit(ds))
    rng = np.random.RandomState(seed + 3)
    users = rng.choice(FULL_USERS, SERVE_BATCH, replace=False)
    recs = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                 lambda: model.recommend_batch(list(users), k=TOPK))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("trainer at full width")
    if launches <= 0 or fused <= 0:
        raise AssertionError("the full-width path did not launch accumulate_rows and fused_topk")

    # ---- check and measure ----
    epoch_s = (clock.seconds["BPR.fit, 11 epochs"] - clock.seconds["BPR.fit, 1 epoch"]) / 10
    n_batches = -(-n // FULL_BATCH)
    per_sample, probe = sample_bytes(ds.csr_matrix, FULL_K)
    bound_s = n_batches * FULL_BATCH * per_sample / PEAK_BYTES
    if not all(np.isfinite(getattr(model, a)).all() for a in ("u_factors", "i_factors", "i_biases")):
        raise AssertionError("the full-width fit has non-finite factors")
    prof = epoch_profile(lambda e: BPR(max_iter=e, **kw).fit(ds), n_batches, 1)
    stats = dict(samples_per_s=n / epoch_s, epoch_s=epoch_s, bound_s=bound_s,
                 bytes_per_sample=per_sample, setup_s=clock.seconds["BPR.fit, 1 epoch"] - epoch_s,
                 **prof)
    log(f"  BPR k={FULL_K} batch {FULL_BATCH} over {n:,} pairs ({FULL_USERS:,} users x "
        f"{FULL_ITEMS:,} items, membership by binary search): {epoch_s:.3f} s per epoch (10 "
        f"epochs: an 11-epoch fit minus a 1-epoch fit), {n / epoch_s / 1e6:.3f} M samples/s; "
        f"fit set-up {stats['setup_s']:.3f} s")
    log(f"  byte bound: {per_sample:.1f} B per sample (8 pair + {probe:.1f} probe + 3 x 2 x "
        f"{FULL_K + 1} x 4 rows) over {PEAK_BYTES / 1e12:.2f} TB/s = {bound_s * 1e3:.3f} ms per "
        f"epoch ({PEAK_BYTES / per_sample / 1e6:,.0f} M samples/s): "
        f"{100 * bound_s / epoch_s:.3f}% of it")
    log(f"  profile, one epoch (a 1-epoch fit minus a 0-epoch fit): {prof['wall_ms']:.1f} ms host "
        f"clock, device busy {prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
        f"{prof['launches_per_minibatch']:.1f} device events per minibatch; top device ops: "
        f"{prof['top']}")
    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    got = [[model.iid_map[i] for i in row] for row in recs]
    relaxed = check_lists(got, want, plain_scores(Ud[users], Vd).cpu().numpy(), "trained recommend_batch")
    log(f"  recommend_batch of the trained model ({SERVE_BATCH} users, k={TOPK}): equal to the plain "
        f"version (positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}")
    log(f"trainer at full width: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, stats


def time_ms(fn, reps, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(bpr, users):
    """CUDA-event times of fused_topk at B = 1, 256 and 8192 users, each
    with its split S, against its plain version and ``matmul`` + ``topk``
    timed in turn (plain, kernel, library), beside the bound."""
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk_torch

    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(bpr.get_user_vectors()[users], np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(bpr.get_item_vectors(), np.float32), device=dev)
    N, d = Vd.shape
    rows = {}
    for B in (1, 256, SERVE_BATCH):
        U = Ud[:B].contiguous()
        reps = 20 if B == SERVE_BATCH else 200
        plain_ms = time_ms(lambda: fused_topk_torch(U, Vd, TOPK), reps)
        ms = time_ms(lambda: FUSED_TOPK(U, Vd, TOPK), reps)
        library_ms = time_ms(lambda: torch.topk(torch.matmul(U, Vd.T), TOPK, dim=1), reps)
        flops = 2.0 * B * N * d
        nbytes = 4.0 * (B * d + N * d) + 8.0 * B * TOPK
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        S = FUSED_TOPK.plan(U, N, TOPK)
        rows[B] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by, slices=S)
        log(f"  times B={B} N={N} d={d} k={TOPK} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"matmul+topk {library_ms:.4f} ms ({library_ms / ms:.2f}x the kernel), bound "
            f"{bound_ms:.4f} ms ({bound_by}), {B / ms * 1e3:,.0f} users/s, "
            f"{100 * bound_ms / ms:.2f}% of bound")
    return rows


def library_cosine_topk(W, k):
    """The dense library yardstick: two ``torch.matmul`` (TF32 off), the
    elementwise step and ``torch.topk``. Timed only; the port never calls
    it. It is not ``co_support_cosine``: that follows the JAX formula with
    three products, where ``d2 = B·(W∘W)ᵀ`` is just ``d1ᵀ``, and the
    yardstick should be the least library work for the same function."""
    import torch

    from cornac_tpu_torch.ops.dispatch import full_f32

    with full_f32():
        num, d1 = torch.matmul(W, W.T), torch.matmul(W * W, (W != 0).float().T)
    sim = torch.where(num != 0, num / torch.clamp_min(torch.sqrt(d1) * torch.sqrt(d1.T), 1e-12), 0.0)
    sim.fill_diagonal_(-3e38)
    return torch.topk(sim, k, dim=1)


def sparse_library_cosine_topk(A, A2, Wt, Bt, k):
    """The sparse library yardstick: ``num = A·Wᵀ`` and ``d1 = (A∘A)·Bᵀ``
    as CSR x dense products (cuSPARSE SpMM through ``torch.sparse``), then
    the elementwise step and ``torch.topk``. ``A`` and ``A2`` are CSR
    tensors, ``Wt`` and ``Bt`` (``[W ≠ 0]ᵀ``) dense, all built once outside
    the time. CSR x CSR (SpGEMM) ran out of cuSPARSE's resources on the
    half-dense matrix, so it is not the yardstick. Timed only; the port
    never calls it."""
    import torch

    num = torch.sparse.mm(A, Wt)
    d1 = torch.sparse.mm(A2, Bt)
    sim = torch.where(num != 0, num / torch.clamp_min(torch.sqrt(d1) * torch.sqrt(d1.T), 1e-12), 0.0)
    sim.fill_diagonal_(-3e38)
    return torch.topk(sim, k, dim=1)


def phase_cosine_times(shapes):
    """CUDA-event times of the sparse cosine kernel (on views built once),
    its plain version and the dense and sparse library yardsticks, beside
    the bound; two launches on one input must give the same bits.

    The bound counts what these inputs need, as for a sparse product: each
    co-rated pair of rows in a column is one update of three sums, so
    ``3·Σ_j c_j²`` operations for column counts ``c_j`` over 67 TFLOP/s,
    against the bytes the kernel reads once (the CSR: row pointers and 8
    bytes an entry; the CSC's 8 bytes an entry; the warps' split of every
    column, ``ops.cosine_topk.partition``) and the (n, k) table it writes
    (8 bytes an entry) over 3.35 TB/s; the larger of the two. The kernel's
    time includes building that split. Beside it, what a dense kernel
    would need: ``3·n²·m`` operations (``num = W·Wᵀ`` is symmetric,
    ``d2 = d1ᵀ``) and the dense W's bytes."""
    import torch

    from cornac_tpu_torch.ops.cosine_topk import (
        COSINE_TOPK, cosine_topk_torch, dense_views, partition)

    rows = {}
    for label, W in shapes:
        n, m = W.shape
        k = KNN_K
        t = time.perf_counter()
        views = dense_views(W)
        torch.cuda.synchronize()
        views_s = time.perf_counter() - t
        nnz = views.row_val.numel()
        dense_flops = 3.0 * n * n * m
        reps, warm = (3, 1) if dense_flops > 5e12 else (10, 2)
        first, second = COSINE_TOPK(views, k), COSINE_TOPK(views, k)
        if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
            raise AssertionError(f"{label}: two launches of the cosine kernel differ")
        del first, second
        plain_ms = time_ms(lambda: cosine_topk_torch(W, k), reps, warm)
        ms = time_ms(lambda: COSINE_TOPK(views, k), reps, warm)
        library_ms = time_ms(lambda: library_cosine_topk(W, k), reps, warm)
        A, A2 = W.to_sparse_csr(), (W * W).to_sparse_csr()
        Wt, Bt = W.T.contiguous(), (W != 0).float().T.contiguous()
        sparse_ms = time_ms(lambda: sparse_library_cosine_topk(A, A2, Wt, Bt, k), reps, warm)
        del A, A2, Wt, Bt
        torch.cuda.empty_cache()
        col_nnz = torch.diff(views.col_ptr.long()).double()
        flops = 3.0 * float((col_nnz * col_nnz).sum())
        bounds, split = partition(views, COSINE_TOPK.plan(n, W.device)[0])
        nbytes = 4.0 * (n + 1 + bounds.numel() + split.numel()) + 16.0 * nnz + 8.0 * n * k
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        dense_bytes = 4.0 * n * m + 8.0 * n * k
        dense_bound_ms = 1e3 * max(dense_flops / PEAK_F32_FLOPS, dense_bytes / PEAK_BYTES)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by, dense_bound_ms=dense_bound_ms,
                           sparse_library_ms=sparse_ms)
        log(f"  times {label} n={n} m={m} nnz={nnz} k={k} (reps {reps}): kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, 2 matmul + topk {library_ms:.3f} ms, 2 cuSPARSE CSR x dense "
            f"products + topk {sparse_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops:.3e} FLOP = 3 x sum of squared column counts, {nbytes / 1e6:.1f} MB), "
            f"{100 * bound_ms / ms:.2f}% of bound; a dense kernel's bound {dense_bound_ms:.3f} ms "
            f"({dense_flops:.3e} FLOP); views built from dense W in {views_s:.3f} s (host "
            f"clock); two launches bit-identical")
    return rows


def phase_accumulate_times(cases):
    """CUDA-event times of accumulate_rows at the trainers' shapes, on the
    inputs ``phase_accumulate`` checked: the wrapper (stable sort + kernel),
    the kernel alone on sorted ids, the plain version and ``index_add_``
    (one library call, atomics), timed in turn, beside the bound. The bound
    counts what the function must move: the ids (8 bytes each) and the
    updates read once, each touched table row read and written once; its
    B * d additions are far below the float32 peak."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows, accumulate_rows_torch

    rows = {}
    for label, (table, ids, upd) in cases.items():
        (R, d), B = table.shape, ids.shape[0]
        ids_sorted, order = torch.sort(ids.to(torch.int32), stable=True)
        reps = 200
        plain_ms = time_ms(lambda: accumulate_rows_torch(table, ids, upd), reps)
        ms = time_ms(lambda: accumulate_rows(table, ids, upd), reps)
        kernel_ms = time_ms(lambda: ACCUMULATE_ROWS(table, ids_sorted, order, upd), reps)
        library_ms = time_ms(lambda: table.index_add_(0, ids, upd), reps)
        touched = torch.unique(ids).numel()
        nbytes = 8.0 * B + 4.0 * B * d + 8.0 * touched * d
        flops = float(B * d)
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        rows[label] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, shape=f"{B} ids into {R} x {d}")
        log(f"  times accumulate_rows, {label}: {B} ids into {R} rows x {d} ({touched} touched): "
            f"sort + kernel {ms:.4f} ms (kernel alone {kernel_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"index_add_ {library_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}, "
            f"{nbytes / 1e6:.3f} MB), {100 * bound_ms / ms:.2f}% of bound")
        del ids_sorted, order
    return rows


def build_all():
    """Build every kernel library at once: one nvcc per source, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    libs = [FUSED_TOPK.library, COSINE_TOPK.library, ACCUMULATE_ROWS.library]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.build) for lib in libs]:
            future.result()
    for lib in libs:
        log(f"build: ok, {lib.path().name} in {lib.build_seconds or 0.0:.1f} s")
        for line in lib.compiler_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas: {line.strip()}")
    log(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true",
                        help="stop after the kernel-vs-plain phases")
    args = parser.parse_args()

    if not (ROOT / "cornac_tpu_torch").is_dir():
        sys.exit("chip_smoke: run it from a checkout that holds cornac_tpu_torch/")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    t_start = time.perf_counter()
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    build_all()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    max_err = phase_kernel(gen)
    cos_err = phase_cosine(gen)
    acc_err, acc_cases = phase_accumulate(gen)
    if args.quick:
        log(f"quick run done in {time.perf_counter() - t_start:.1f} s")
        return

    def lap(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what}: done")

    lap("device, build and kernel-vs-plain phases")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    # bench.py's generator is pure Python (about 15 s): a second process
    # makes the data while the earlier paths run
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        bench_data = pool.submit(make_ml100k_like)
        launches, bpr, users = phase_slice(args.seed, work)
        lap("BPR serving slice")
        knn_launches, W_items, W_users = phase_knn_ml1m(args.seed, work)
        lap("KNN slice")
        ml10m_launches, W10 = phase_knn_ml10m(args.seed)
        lap("related items")
        bench_launches, bench = phase_trainer_bench(bench_data.result)
        lap("trainers at the bench shape")
    finally:
        pool.shutdown(cancel_futures=True)
    full_launches, full_fused, full = phase_trainer_full(args.seed)
    lap("trainer at full width")
    rows = phase_times(bpr, users)
    cos_rows = phase_cosine_times([
        ("ML-1M item side", W_items),
        ("ML-1M user side", W_users),
        ("half dense, ML-1M item widths", star_weights(3706, 6040, 0.5, "integer", gen)),
        ("ML-10M item side", W10),
    ])
    acc_rows = phase_accumulate_times(acc_cases)
    lap("times")
    kernels = [{
        "name": "fused_topk",
        "batch": B,
        "slices": row["slices"],
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/fused_topk.cu",
        "replaces": "cornac_tpu/ops/pallas_ranking.py:38",
        "launches": launches + full_fused,
        "max_abs_err": max_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for B, row in sorted(rows.items(), reverse=True)]
    cos = cos_rows["ML-10M item side"]
    kernels.append({
        "name": "cosine_topk",
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/cosine_topk.cu",
        "replaces": "cornac_tpu/ops/pallas_similarity.py:43",
        "launches": knn_launches + ml10m_launches,
        "max_abs_err": cos_err,
        "ms": cos["ms"],
        "plain_ms": cos["plain_ms"],
        "bound_ms": cos["bound_ms"],
        "bound_by": cos["bound_by"],
        "library_ms": cos["library_ms"],
        "dense_bound_ms": cos["dense_bound_ms"],
        "sparse_library_ms": cos["sparse_library_ms"],
    })
    acc = acc_rows["full width, V update (positives + negatives)"]
    kernels.append({
        "name": "accumulate_rows",
        "shape": acc["shape"],
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/accumulate_rows.cu",
        "replaces": "cornac_tpu/ops/accumulate.py:26",
        "launches": bench_launches + full_launches,
        "max_abs_err": acc_err,
        "ms": acc["ms"],
        "plain_ms": acc["plain_ms"],
        "bound_ms": acc["bound_ms"],
        "bound_by": acc["bound_by"],
        "library_ms": acc["library_ms"],
        "kernel_only_ms": acc["kernel_ms"],
    })
    log(f"trainers: bench shape AUC {bench['quality']['AUC']:.4f} NDCG@10 "
        f"{bench['quality']['NDCG@10']:.4f}, train {bench['train_s']:.3f} s, test "
        f"{bench['test_s']:.3f} s, busy {100 * bench['share']:.2f}%; full width "
        f"{full['samples_per_s'] / 1e6:.3f} M samples/s, {100 * full['bound_s'] / full['epoch_s']:.3f}% "
        f"of the byte bound, busy {100 * full['share']:.2f}%")
    log(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
