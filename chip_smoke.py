#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA card and hold its kernels to
their plain PyTorch versions.

Run from the root of a checkout:

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --quick    # device, builds and kernel-vs-plain only (1-6)

Phases, each of which fails the run when it fails:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``cornac_tpu_torch/csrc/fused_topk.cu``,
   ``cosine_topk.cu``, ``accumulate_rows.cu`` and ``canary.cu`` with nvcc,
   one process each, in parallel, and prints ptxas's registers and spills;
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
   against ``accumulate_rows_torch`` on the CPU, on duplicate-heavy
   batches (16,384 ids into 17,700 and into 480,000 rows, 4,096 ids into
   943 rows, at d = 11, 33 and 51), a 1-D table, d = 200 (column blocks),
   R < B with a run longer than a round of ids, R >> B (over a thousand
   row ranges), ids outside [0, R) (dropped) and strided ids, at the
   four shapes the BPR trainers hand it (the U and V updates at the bench
   shape and at full width) and at the factor family's (NMF's 80,000 ids
   into 943 and 789 rows at d = 15 and 1-D, PMF's 1,024, IBPR's 100 and
   200, COE's 1,000 and 2,000, MF-adam's 256 at d = 10 and 1-D), at the
   neural family's (NeuMF's 256 ids at d = 16 and 8, LightGCN's 1,024 at
   d = 64), at LightGCN's edge form at the ML-10M widths (10,000,054
   ids into 69,878 and into 10,677 rows at d = 64), at HPF's (the same ids
   at d = 5; 80,000 ids into 943 and 789 rows at the bench shape) and at
   FM-SGD's (2,048 ids over the user and the offset item block into 1,732
   feature rows, 1-D and d = 8), bit for bit (on the
   CPU, ``index_add_`` sums each row's updates in batch order and adds
   the sum once, as the kernel does; the gap to the plain version on the
   card, whose ``index_add_`` is atomic, is printed); two launches must
   give the same bits, and the
   profiler must see one kernel per call and nothing else (its device
   time per launch, at the four BPR shapes, is taken here, early: late in
   the process the profiler loses a short kernel's events);
6. canary vs plain: ``csrc/canary.cu`` against ``x * 2``, bit for bit, at
   (128, 128) and at sizes that end inside a block or span 64M elements;
7. on-silicon probe (the canary's path): ``tools/cuda_on_silicon.py``'s
   three steps, canary, fused_topk and cosine_topk, each cold and warm
   under its own timeout and held to its plain version;
8. BPR serving slice: a BPR model (k=50 + item bias, so d=51) over
   480,000 users and 17,700 items, random factors from the seed, wrapped
   in TPUExactANN, saved, loaded by ``load_model`` and served by the
   standalone HTTP server on localhost (/recommend, /feedback, /evaluate),
   then ``recommend_batch`` for 8,192 users; every answer is checked
   against lists computed from the same vectors with the plain version;
9. KNN slice at the MovieLens 1M widths (6,040 users x 3,706 items,
   1,000,209 seeded whole-star ratings): RatioSplit -> Experiment with
   ItemKNN(k=50) and UserKNN(k=50) on Recall@10, NDCG@10 and AUC ->
   nearest_items / nearest_users (kernel launches, held exactly to the
   plain version) -> the ItemKNN saved and served by the standalone server;
10. related items at the MovieLens 10M widths (69,878 users x 10,677 items,
   10,000,054 seeded half-star ratings): ItemKNN(k=50).fit and
   nearest_items(50) (which builds no dense W: its peak device memory is
   checked), held exactly to the plain version;
10b. LightGCN's edge form at those widths (``NormAdjacency`` of that train
   set, 10,000,054 edges, d = 64): one propagation step forward and
   backward (4 accumulate_rows launches) and the 3-layer mean forward and
   backward; the step's four outputs held bit for bit to the same step on
   the CPU (where accumulate_rows is its plain version), two calls bit for
   bit; times beside the plain version on the card (``index_add_``), four
   cuSPARSE products and the bound;
10c. HPF at those widths (``examples/hpf_movielens.py``: k = 5, seed 123)
   on phase 10's train set: fits of 1 and 3 sweeps held to the same fits
   on the CPU (rtol 3e-5), the first sweep's two accumulate_rows inputs
   held bit for bit to the plain version on the CPU and timed, a second
   3-sweep fit bit for bit, the 100-sweep fit timed (seconds per sweep
   beside the byte bound, the busy share, peak device memory), then
   recommend_batch of 8,192 users at k = 100 through fused_topk at d = 5,
   every list held to the plain version;
11. trainers at the bench.py shape (``make_ml100k_like(seed=7)``, 943 users
   x 1,682 items, 100,000 ratings): RatioSplit(0.2, 4.0, seed=123) ->
   BPR(k=10, max_iter=200, learning_rate=0.001, lambda_reg=0.01,
   seed=123, batch_size=4096).fit -> ranking_eval (AUC, MAP, NDCG@10, P@10,
   R@10), timed after a one-epoch warm-up; AUC and NDCG@10 must fall in the
   band of the JAX package's CPU runs (``tools/bpr_quality_band.py``); a
   second fit with the same seed and verbose=True must give the same
   factors, bit for bit; then one Experiment with BPR, MMMF, WBPR,
   MF(k=10, max_iter=20), BaselineOnly, GlobalAvg and MostPop on those
   metrics and RMSE, MAE;
12. factor family at the bench shape: one Experiment with
   ``benchmarks/model_sweep.py``'s PMF, NMF, WMF, EASE, IBPR, COE and
   MF(optimizer="adam", dropout=0.1) on AUC, NDCG@10, Recall@10, RMSE and
   MAE: each model's AUC and NDCG@10 in the band of the JAX package's CPU
   fits (``tools/bpr_quality_band.py --model``), fit seconds per model,
   fused_topk behind each model's serving entry point held to the plain
   version, a second seeded fit of each (verbose) bit for bit, whose
   accumulate_rows inputs (the first at each shape) are held to the plain
   version on the CPU, bit for bit (IBPR's and MF-adam's second fits, and
   the first they are held to, run 2 epochs); the profile of one IBPR
   epoch over the first 5,000 ratings;
12b. neural family at the bench shape: one Experiment with
   ``benchmarks/model_sweep.py``'s VAECF, RecVAE, BiVAECF and NeuMF, GMF
   and MLP at NeuMF's depth, LightGCN, and NGCF at LightGCN's, on AUC,
   NDCG@10 and Recall@10, each AUC and NDCG@10 in the band of the JAX
   package's CPU fits, fit seconds per model, fused_topk behind
   BiVAECF's recommend_batch held to the plain version, VAECF's
   recommend_batch(k > 0) refused as the JAX package refuses it; two
   seeded fits of each at 2 epochs (the second verbose) bit for bit,
   whose accumulate_rows inputs are held to the plain version on the CPU; the
   profile of one NeuMF epoch over the first 5,000 ratings;
13. trainer at full width (``benchmarks/scale_10m.py``'s configuration:
   100,000 users x 10,000 items, about 10M unique seeded pairs, so the
   membership test is the CSR binary search): BPR(k=32, batch_size=16384,
   seed=123), one warm epoch, then 10 timed epochs; samples/s beside the
   byte bound of a sample, launches per minibatch and the device-busy
   share; then ``recommend_batch`` for 8,192 users at k=100 through
   fused_topk, every list held to the plain version;
14. WMF at the Netflix widths (``benchmarks/scale_netflix.py:130-157``:
   480,000 x 17,700, k=64, cut to 20M seeded pairs): a 3-sweep fit, then
   one warm and two timed sweeps beside the FLOP bound, peak device
   memory, recommend_batch of 8,192 users at k=100, TPUExactANN with
   recall_target=0.95 and the bf16 route, each held to the plain version;
14b. VAECF at the Netflix widths (``benchmarks/vaecf_sparse_stream.py:38-39``:
   k=32, [100], batch 1,024, lr 0.001, seed 1) on phase 14's 20M pairs, in
   the index-resident mode: fits of 1 and of 4 epochs, seconds per steady
   epoch ((4 - 1) / 3) beside the FP32 FLOP bound, peak device memory;
   score_batch of 8,192 users, their top-100 held to a float64 scoring of
   the same parameters, and recommend for one user;
12c. the factor family's rest at the bench shape: one Experiment with
   ``benchmarks/model_sweep.py``'s HPF, SKMeans and FM (als), PF, FM's sgd
   and mcmc learners at ``examples/fm_example.py``'s settings and
   ``examples/sansa_movielens.py``'s SANSA on AUC, NDCG@10, Recall@10, RMSE
   and MAE: each AUC and NDCG@10 (and FM's RMSE) in the band of the JAX
   package's CPU fits, fit seconds per model, fused_topk behind HPF's, PF's
   and SANSA's recommend_batch held to the plain version, a second seeded
   fit of each bit for bit, whose accumulate_rows inputs are held to the
   plain version on the CPU; one FM-ALS sweep held to the CPU's and
   ``_seg_sum`` beside accumulate_rows (error against float64, time);
12d. the protocols at the bench shape, in the same process:
   CrossValidation(5 folds, seed 123) over MF(k=10, max_iter=25) and
   PMF(k=10, max_iter=100) on MAE and RMSE; StratifiedSplit (by user,
   chronological) and TimestampSplit (ratio mode) on the bench data with
   seeded timestamps and PropensityStratifiedEvaluation (2 strata), each an
   Experiment with HPF and MostPop; GridSearch and RandomSearch (4 trials)
   over HPF's k and hierarchical on validation AUC. The folds, splits and
   strata are held to the same protocols built on the CPU, each search's
   trials (within 1e-4) and best_params to the same search on the CPU;
15. times: each kernel, its plain version and library yardsticks
   (``torch.matmul`` + ``torch.topk``; for the cosine also cuSPARSE
   products through ``torch.sparse``; for accumulate_rows ``index_add_``,
   atomic, and ``index_add_`` in PyTorch's deterministic mode, whose bits
   over two launches and whether it runs without a sync are recorded)
   with CUDA events, beside the bound; fused_topk at B = 1, 256 and 8192,
   fused_topk also at HPF's d = 5 (B = 8192 over the ML-10M catalog),
   cosine_topk at both ML-1M shapes, a half-dense ML-1M-wide matrix and
   ML-10M, where two launches must give the same bits; accumulate_rows at
   the labelled shapes of phase 5 (the BPR trainers' four, NeuMF's and
   LightGCN's at the bench shape, LightGCN's and HPF's two each at ML-10M),
   on the inputs
   phase 5 checked; the canary at (128, 128) beside ``torch.mul``.

Phases 12, 12b and 12c-12d run last, after 15, in five spawned processes
at once (the factor family, three groups of the neural family, and the
factor family's rest with the protocols): the card
time-slices between processes and they share the host's cores, so no
time this process takes is taken beside them, while their own fit seconds
and busy shares carry each other's load.

The last three lines are the card's name and power limit, one JSON object
with the kernels' numbers (fused_topk once per batch size, B = 8192 first,
then at HPF's d = 5; accumulate_rows at the full-width V update and
LightGCN's and HPF's two ML-10M shapes each),
and ``{"ok": true, "device": {...}}``. The
script imports nothing of JAX or of the JAX package.
"""

import argparse
import contextlib
import copy
import functools
import json
import multiprocessing
import os
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))
try:
    from card_measure import (PEAK_BYTES, PEAK_F32_FLOPS, card_line, compare_topk,
                              library_cosine_topk, plain_scores, time_ms)
    from quality_bands import band
except ImportError:
    sys.exit("chip_smoke: run it from a checkout that holds tools/ and cornac_tpu_torch/")

N_USERS, N_ITEMS, FACTORS, TOPK, SERVE_BATCH = 480_000, 17_700, 50, 100, 8192
N_INTERACTIONS = 1_000_000  # Netflix has ~100M; cut so Dataset.build stays quick
RTOL = ATOL = 1e-5
DEV = "cuda"
# benchmarks/scale_10m.py's configuration, the full-width trainer phase
FULL_USERS, FULL_ITEMS, FULL_DRAWS, FULL_K, FULL_BATCH = 100_000, 10_000, 10_000_000, 32, 16_384
ML10M_USERS, ML10M_ITEMS, ML10M_RATINGS = 69_878, 10_677, 10_000_054


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


def launches_per_call(fn, calls=4):
    """What the profiler sees per call of ``fn`` (warmed once): the host's
    launches of device work (the CUDA runtime's kernel launches, memsets
    and copies), the device-side events, the device events' names, and
    their mean device time in ms (None if it kept none). The host count is
    the exact one: the device side has been seen to miss an event of a
    short kernel."""
    from torch.autograd import DeviceType

    fn()
    _, busy_ms, count, events, prof = profile_call(lambda: [fn() for _ in range(calls)],
                                                   with_prof=True)
    host = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CPU
               and e.key.startswith("cu") and any(w in e.key for w in ("Launch", "Memset", "Memcpy")))
    return host / calls, count / calls, sorted({e.key for e in events}), (
        busy_ms / count if count else None)


# label (the trainers' shapes, timed later on the same inputs), rows, ids,
# d (None: a 1-D table), the ids' distribution, their stride (2: a column
# of (user, item) pairs, as the trainers' user ids are)
ACC_CASES = [
    *((None, R, B, d, "popular", 1) for R, B in ((17_700, 16_384), (480_000, 16_384))
      for d in (11, 33, 51)),
    (None, 943, 4_096, 33, "popular", 1),
    (None, 943, 4_096, 51, "popular", 1),
    (None, 50, 3_000, None, "popular", 1),  # a 1-D table, as the baselines' biases
    (None, 5_000, 16_384, 200, "popular", 2),  # four column blocks
    (None, 64, 32_768, 11, "popular", 1),  # R < B: a run longer than a round and the stage
    (None, 2_000_000, 4_096, 33, "uniform", 1),  # R >> B: over a thousand row ranges
    (None, 100_000, 16_384, 33, "out of range", 2),  # 5% of the ids outside [0, R)
    ("full width, V update (positives + negatives)", FULL_ITEMS, 2 * FULL_BATCH, FULL_K + 1,
     "uniform", 1),
    ("full width, U update", FULL_USERS, FULL_BATCH, FULL_K + 1, "uniform", 2),
    ("bench shape, V update", 1_682, 2 * 4_096, 11, "popular", 1),
    ("bench shape, U update", 943, 4_096, 11, "popular", 2),
    # the factor family's shapes at the bench shape, whose train set holds
    # 943 users and 789 items (phase 12 also holds the kernel to the plain
    # version on the inputs the trainers hand it)
    (None, 943, 80_000, 15, "popular", 1),  # NMF's U numerator and denominator
    (None, 789, 80_000, 15, "popular", 1),  # NMF's V sums
    (None, 789, 80_000, None, "popular", 1),  # NMF's item biases (use_bias)
    (None, 943, 1_024, 10, "popular", 2),  # PMF's U update
    (None, 789, 1_024, 10, "popular", 2),  # PMF's V update
    (None, 943, 100, 10, "popular", 2),  # IBPR's U gradient
    (None, 789, 200, 10, "popular", 1),  # IBPR's V gradient (positives + negatives)
    (None, 943, 1_000, 10, "popular", 2),  # COE's U gradient
    (None, 789, 2_000, 10, "popular", 1),  # COE's V gradient
    (None, 943, 256, 10, "popular", 2),  # MF-adam's U gradient
    (None, 789, 256, None, "popular", 2),  # MF-adam's item-bias gradient
    # the neural family (phase 12b also holds the kernel to the plain
    # version on the inputs its trainers hand it): the embedding gradients
    # of a NeuMF minibatch (256 ids, the MLP tower's 16 columns; GMF's 8)
    # and of LightGCN's gathers from its propagated tables (1,024 ids at
    # d = 64), then LightGCN's edge-form propagation at the ML-10M widths,
    # every edge into the user rows and into the item rows (phase 10b)
    ("NeuMF, bench shape, MLP user embeddings", 943, 256, 16, "popular", 1),
    (None, 1_682, 256, 8, "popular", 1),  # NeuMF's GMF item embeddings
    ("LightGCN, bench shape, propagated item rows", 1_682, 1_024, 64, "popular", 1),
    ("LightGCN edge form, ML-10M, into user rows", ML10M_USERS, ML10M_RATINGS, 64, "popular", 1),
    ("LightGCN edge form, ML-10M, into item rows", ML10M_ITEMS, ML10M_RATINGS, 64, "popular", 1),
    # the factor family's rest: HPF's two scatters a sweep at the ML-10M
    # widths (phase 10c, every rating into the user rows and into the item
    # rows, k = 5) and at the bench shape (phase 12c), and FM-SGD's w and V
    # updates (a minibatch of 1,024 ratings: its user ids, then its item ids
    # offset by the 943 users, into the 943 + 789 feature rows)
    ("HPF, ML-10M, into user rows", ML10M_USERS, ML10M_RATINGS, 5, "popular", 1),
    ("HPF, ML-10M, into item rows", ML10M_ITEMS, ML10M_RATINGS, 5, "popular", 1),
    (None, 943, 80_000, 5, "popular", 1),  # HPF's user shapes at the bench shape
    (None, 789, 80_000, 5, "popular", 1),  # HPF's item shapes
    (None, 1_732, 2_048, None, "feature blocks", 1),  # FM-SGD's w
    (None, 1_732, 2_048, 8, "feature blocks", 1),  # FM-SGD's V
]
FM_USERS = 943  # the bench shape's train users: the first feature block of FM's ids


def accumulate_inputs(R, B, d, kind, stride, gen):
    """A seeded (table, ids, updates) of one ``ACC_CASES`` case; ids with
    ``stride`` 2 are the first column of a (B, 2) tensor."""
    import torch

    shape = (R,) if d is None else (R, d)
    table = torch.randn(*shape, generator=gen, device=DEV)
    if kind == "feature blocks":  # FM's users, then its items past the users
        half = B // 2
        ids = torch.cat([popular_ids(FM_USERS, half, gen),
                         FM_USERS + popular_ids(R - FM_USERS, B - half, gen)])
    elif kind == "popular":
        ids = popular_ids(R, B, gen)
    else:
        ids = torch.randint(R, (B,), generator=gen, device=DEV)
    if kind == "out of range":
        bad = torch.tensor([-1, -7, R, R + 3, 2**40], device=DEV)
        pick = torch.rand(B, generator=gen, device=DEV) < 0.05
        ids = torch.where(pick, bad[torch.randint(5, (B,), generator=gen, device=DEV)], ids)
    if stride == 2:
        ids = torch.stack([ids, torch.zeros_like(ids)], 1)[:, 0]
    upd = torch.randn(B, *shape[1:], generator=gen, device=DEV)
    return table, ids, upd


def check_accumulate(what, table, ids, upd, calls=4):
    """Hold one accumulate_rows call to its plain version: two launches
    give the same bits, and those are the bits of the plain version on the
    CPU, whose ``index_add_`` sums each row's updates in batch order and
    adds the sum once, as the kernel does (ids outside [0, R), which the
    kernel drops and the plain version refuses, left out of the latter);
    the profiler sees one kernel and nothing else per call over ``calls``
    calls (none: not profiled). ``table`` is left as it was. Returns (max
    |kernel - plain on the CPU|, 0 when it passes; max |kernel - plain on
    the card|, where ``index_add_`` sums with atomics in no fixed order;
    launches per call; the kernel's mean device ms per event the profiler
    kept, and kept per call, both None unprofiled)."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows

    R = table.shape[0]
    before = ACCUMULATE_ROWS.launches
    got = [accumulate_rows(table.clone(), ids, upd) for _ in range(2)]
    torch.cuda.synchronize()
    if ACCUMULATE_ROWS.launches != before + 2:
        raise AssertionError(f"{what}: the kernel was not launched")
    if not torch.equal(got[0], got[1]):
        raise AssertionError(f"{what}: two launches of the kernel differ")
    per_call, device_per_call, device_ms = 1, None, None
    if calls:
        scratch = table.clone()
        for _ in range(2):  # once more when the profiler kept no device event at all
            per_call, device_per_call, names, device_ms = launches_per_call(
                lambda: accumulate_rows(scratch, ids, upd), calls)
            if device_per_call:
                break
        if (per_call != 1 or not 0 < device_per_call <= 1
                or not all("accumulate_rows_kernel" in k for k in names)):
            raise AssertionError(f"{what}: {per_call} launches and {device_per_call} device "
                                 f"events per call ({names}), not one kernel")
        del scratch
    keep = (ids >= 0) & (ids < R)
    ok_ids, ok_upd = (ids, upd) if bool(keep.all()) else (ids[keep], upd[keep])
    want = accumulate_rows(table.to("cpu", copy=True), ok_ids.cpu(), ok_upd.cpu())
    kernel = got[0].cpu()
    err = (kernel - want).abs().max().item()
    if not torch.equal(kernel, want):
        raise AssertionError(f"{what}: the kernel differs from the plain version on the CPU, "
                             f"max |kernel - plain| {err:.3e}")
    del want, kernel
    card_err = (got[0] - accumulate_rows(table.clone(), ok_ids, ok_upd, force="torch")
                ).abs().max().item()
    runs = torch.unique(ok_ids, return_counts=True)[1]
    log(f"  {what}: ok ({runs.numel()} runs, the longest {int(runs.max())} ids"
        + (f"; {ids.numel() - ok_ids.numel()} ids outside [0, R) dropped"
           if ok_ids.numel() < ids.numel() else "")
        + f"; the plain version's bits on the CPU; max |kernel - plain on the card| "
        f"{card_err:.3e}; two launches "
        + ("bit-identical)" if not calls else f"bit-identical; per call {per_call:g} launch, "
           f"{device_per_call:g} device event, the kernel)"))
    return err, card_err, per_call, device_ms, device_per_call


def phase_accumulate(gen):
    """The row-accumulation kernel against its plain version on the CPU,
    bit for bit, on duplicate-heavy batches, a 1-D table, column blocks, R
    below and far above B, strided and out-of-range ids (held to the plain
    version on the in-range ids) and the trainers' shapes; two launches
    must give the same bits, and the profiler must see one kernel and
    nothing else per call. Returns the largest |kernel - plain on the CPU|
    and, for the labelled cases, their inputs, launches per call, the
    kernel's device time per launch (profiled over 20 calls here, before
    the later phases' long profiles) and their own max |kernel - plain|
    on the CPU and on the card, for timing."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_err, max_card_err, most_ranges = 0.0, 0.0, 0
    timed = {}
    for label, R, B, d, kind, stride in ACC_CASES:
        table, ids, upd = accumulate_inputs(R, B, d, kind, stride, gen)
        plan = ACCUMULATE_ROWS.plan(R, B, 1 if d is None else d, table.device)
        most_ranges = max(most_ranges, plan.grid[0])
        what = (f"{B} ids into {R} rows, d={d}, {kind}, id stride {stride}"
                + (f" ({label})" if label else "")
                + f", grid {plan.grid[0]} x {plan.grid[1]} of {plan.rows} rows x {plan.cols}")
        err, card_err, per_call, device_ms, kept = check_accumulate(
            what, table, ids, upd, calls=20 if label else 4)
        max_err, max_card_err = max(max_err, err), max(max_card_err, card_err)
        if label:
            timed[label] = (table, ids, upd, per_call, device_ms, kept, err, card_err)
    if most_ranges <= 4 * sms:
        raise AssertionError(f"no case planned more than {4 * sms} row ranges")
    torch.cuda.empty_cache()
    log(f"accumulate_rows vs plain: ok, {len(ACC_CASES)} cases, the plain version's bits on the "
        f"CPU (max |err| {max_err:.3e}; against the plain version on the card, atomic, "
        f"{max_card_err:.3e}), up to {most_ranges} row ranges, one kernel per call")
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


def profile_call(fn, with_prof=False):
    """One call of ``fn`` under torch.profiler: (host-clock ms, summed time
    of the device-side events (kernels, copies) in ms, their count, the
    events, and the profiler itself if ``with_prof``). Host-side ops
    (``aten::topk``) are left out, since their device time is that of the
    kernels they launched."""
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
    out = wall_ms, busy_ms, sum(e.count for e in events), events
    return (*out, prof) if with_prof else out


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
    return launches, W, train


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
        lo, hi, mean, spread = band("BPR", name)
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


def phase_canary(gen):
    """The canary kernel against ``x * 2`` on the card, bit for bit, at the
    probe's (128, 128) and at sizes that end inside a block or span many."""
    import torch

    from cornac_tpu_torch.ops.canary import CANARY, scale2, scale2_torch

    shapes = [(128, 128), (1,), (255,), (257,), (3, 1000, 7), (64 * 1024 * 1024 + 3,)]
    for shape in shapes:
        x = torch.randn(shape, generator=gen, device=DEV)
        before = CANARY.launches
        y = scale2(x, force="kernel")
        torch.cuda.synchronize()
        if CANARY.launches != before + 1:
            raise AssertionError(f"canary {shape}: the kernel was not launched")
        if not torch.equal(y, scale2_torch(x)):
            raise AssertionError(f"canary {shape}: differs from x * 2")
        del x, y
    log(f"canary vs plain: ok, {len(shapes)} shapes up to {shapes[-1][0]:,} elements, "
        f"bit for bit x * 2")
    return 0.0


def load_probe():
    """``tools/cuda_on_silicon.py`` as a module (``tools/`` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("cuda_on_silicon",
                                                  ROOT / "tools" / "cuda_on_silicon.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_probe():
    """The canary's path: the on-silicon probe (``tools/cuda_on_silicon.py``),
    canary, fused_topk and cosine_topk, each cold and warm under its own
    timeout, held to their plain versions; it writes
    ``build/cuda_silicon.json``."""
    from cornac_tpu_torch.ops.canary import CANARY
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    probe = load_probe()
    # ---- the main path, counted ----
    CANARY.launches = FUSED_TOPK.launches = COSINE_TOPK.launches = 0
    record = probe.probe(timeout=240)
    launches = dict(canary=CANARY.launches, fused_topk=FUSED_TOPK.launches,
                    cosine_topk=COSINE_TOPK.launches)
    for name, step in record["steps"].items():
        log(f"  probe {name}: cold {step.get('cold_s', float('nan')):.4f} s (host clock: load "
            f"or build, first launch, synchronise), warm {step.get('ms', float('nan')):.4f} ms "
            f"(CUDA events), plain {step.get('plain_ms', float('nan')):.4f} ms, library "
            f"{step.get('library_ms', float('nan')):.4f} ms; error {step['error']}")
    if not record["ok"]:
        raise AssertionError(f"the on-silicon probe failed: {record['steps']}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the probe did not launch every kernel: {launches}")
    log(f"on-silicon probe: ok, launches {launches}, wrote build/cuda_silicon.json")
    return launches, record


def phase_canary_times():
    """CUDA-event times of the canary at the probe's (128, 128), its plain
    version and ``torch.mul``, beside its bound: 64 KiB read and 64 KiB
    written over 3.35 TB/s (a launch takes far longer)."""
    import torch

    from cornac_tpu_torch.ops.canary import CANARY, scale2_torch

    x = torch.randn(128, 128, device=DEV)
    reps = 500
    plain_ms = time_ms(lambda: scale2_torch(x), reps)
    ms = time_ms(lambda: CANARY(x), reps)
    library_ms = time_ms(lambda: torch.mul(x, 2), reps)
    bound_ms = 1e3 * 2 * 4.0 * x.numel() / PEAK_BYTES
    log(f"  times canary (128, 128): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.mul "
        f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms (bytes), {100 * bound_ms / ms:.3f}% of "
        f"bound: launch-bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by="bytes")


def factor_configs():
    """(band name, maker, fitted attributes) of ``benchmarks/model_sweep.py``'s
    configurations of the factor family, and MF with adam and dropout."""
    from cornac_tpu_torch import models as M

    return [
        ("PMF", lambda **kw: M.PMF(k=10, max_iter=100, seed=123, **kw), ("U", "V")),
        ("NMF", lambda **kw: M.NMF(k=15, max_iter=50, seed=123, **kw),
         ("u_factors", "i_factors")),
        ("WMF", lambda **kw: M.WMF(k=50, max_iter=30, seed=123, **kw), ("U", "V")),
        ("EASE", lambda **kw: M.EASE(lamb=500, **kw), ("B",)),
        ("IBPR", lambda **kw: M.IBPR(**{"k": 10, "max_iter": 20, "seed": 123, **kw}), ("U", "V")),
        ("COE", lambda **kw: M.COE(k=10, max_iter=20, seed=123, **kw), ("U", "V")),
        ("MF-adam", lambda **kw: M.MF(**{"k": 10, "max_iter": 20, "optimizer": "adam",
                                         "dropout": 0.1, "seed": 123, **kw}),
         ("u_factors", "i_factors", "u_biases", "i_biases")),
    ]


# the second seeded fits that hold a trainer's bits run this many epochs
# (or sweeps) where a whole fit's eager steps take tens of seconds
SHORT_DEPTH = 2
SHORT_REFITS = ("IBPR", "MF-adam")


def serve_factor_model(model, train, users, k=10):
    """B1 behind the model's serving entry point, held to the plain
    version: ``recommend_batch`` for a dot-measure model, else
    ``TPUExactANN(recall_target=0.95).knn_query`` (COE's L2). Returns the
    positions relaxed as near-ties."""
    import torch

    from cornac_tpu_torch.models import MEASURE_DOT, TPUExactANN

    dev = torch.device(DEV)
    U = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32)[users], device=dev)
    V = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    if model.get_vector_measure() == MEASURE_DOT:
        recs = model.recommend_batch([train.user_ids[u] for u in users], k=k)
        got = [[model.iid_map[i] for i in row] for row in recs]
        S = plain_scores(U, V)
    else:
        ann = TPUExactANN(model, recall_target=0.95)
        ann.build_index()
        got, _ = ann.knn_query(U.cpu().numpy(), k)
        S = -((U[:, None, :] - V[None, :, :]) ** 2).sum(-1)
    _, want = torch.sort(S, dim=1, descending=True, stable=True)
    return check_lists(got, want[:, :k].cpu().numpy(), S.cpu().numpy(),
                       f"{model.name} serving")


@contextlib.contextmanager
def recording_accumulate(store):
    """While open, the accumulate_rows wrapper keeps in ``store`` a copy of
    the inputs of its first call at each (table shape, ids, id stride) --
    the table as it was before the call -- and then launches as always."""
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, AccumulateRowsKernel

    class Recording(AccumulateRowsKernel):
        def __call__(self, table, ids, updates):
            key = (tuple(table.shape), ids.shape[0], ids.stride(0))
            if key not in store:
                store[key] = (table.clone(), ids.clone(), updates.clone())
            return super().__call__(table, ids, updates)

    ACCUMULATE_ROWS.__class__ = Recording
    try:
        yield store
    finally:
        ACCUMULATE_ROWS.__class__ = AccumulateRowsKernel


def check_recorded_accumulate(name, store):
    """Hold accumulate_rows to its plain version on the inputs a trainer
    handed it (``recording_accumulate``), with the ids at the stride the
    trainer gave them; not profiled (phase 5 sees one kernel a call at
    these shapes, and this late in the process the profiler loses a short
    kernel's events). Returns the largest |kernel - plain on the CPU|."""
    import torch

    max_err = 0.0
    for (shape, B, stride), (table, ids, upd) in store.items():
        if stride != 1:  # the first column of a (B, stride) tensor
            ids = torch.stack([ids, *[torch.zeros_like(ids)] * (stride - 1)], 1)[:, 0]
        err = check_accumulate(f"{name}'s own input, {B} ids into {shape}, id stride {stride}",
                               table, ids, upd, calls=0)[0]
        max_err = max(max_err, err)
    return max_err


def phase_factor_bench(bench_data):
    """RatioSplit -> Experiment with the factor family at the bench shape:
    each model's AUC and NDCG@10 in its band, fit seconds per model, B1
    behind each model's serving entry point, then a second seeded fit of
    each (verbose: one epoch or sweep a chunk) bit for bit, whose
    accumulate_rows inputs (the first at each shape) are held to the plain
    version."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set
    configs = factor_configs()
    users = np.random.RandomState(5).choice(train.num_users, 512, replace=False)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    exp = Experiment(split, [make(verbose=False) for _, make, _ in configs],
                     [AUC(), NDCG(k=10), Recall(k=10), RMSE(), MAE()])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clock("Experiment.run (7 factor models)", exp.run)
    relaxed = clock("B1 behind each model's serving entry point", lambda: [
        serve_factor_model(m, train, users) for m in exp.models if m.name != "EASEᴿ"])
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("factor family at the bench shape")
    if launches <= 0 or fused <= 0:
        raise AssertionError(f"the factor family launched accumulate_rows {launches} and "
                             f"fused_topk {fused} times")

    # ---- check what came out ----
    fit_s = {}
    for (name, _, _), model, res in zip(configs, exp.models, exp.result):
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{res.model_name}: non-finite metrics {vals}")
        fit_s[name] = res.metric_avg_results["Train (s)"]
        checks = []
        for metric in ("AUC", "NDCG@10"):
            lo, hi, _, spread = band(name, metric)
            value = vals[metric]
            inside = lo <= value <= hi
            checks.append(inside)
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] "
                f"({'one deterministic JAX fit +/- 1e-3' if spread is None else '5 JAX seeds'})"
                f" {'inside' if inside else 'OUTSIDE'}")
        log(f"  {name}: fit {fit_s[name]:.3f} s, test {res.metric_avg_results['Test (s)']:.3f} s "
            f"(host clock); " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(checks):
            raise AssertionError(f"{name}: outside its quality band")
    acc_err, recorded = 0.0, 0
    refits = Clock()
    for (name, make, attrs), model in zip(configs, exp.models):
        # IBPR's and MF-adam's eager steps took 40.8 and 42.4 s a fit: their
        # bits are held at a depth of 2 epochs, two fits of it
        short = {"max_iter": SHORT_DEPTH} if name in SHORT_REFITS else {}
        if short:
            model = refits(f"{name}.fit, {SHORT_DEPTH} epochs", lambda: make(**short).fit(train))
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = refits(f"{name}.fit, verbose=True" + (f", {SHORT_DEPTH} epochs" if short
                                                            else ""),
                           lambda: make(verbose=True, **short).fit(train))
        for attr in attrs:
            if not np.array_equal(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr} (one verbose)")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    refits.report("factor family, second fits")
    if recorded == 0:
        raise AssertionError("no trainer of the factor family handed accumulate_rows an input")
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.models import IBPR

    # a whole epoch of 800 minibatches would give the profiler about 160,000
    # device events, which costs a minute and makes later profiles in this
    # process lose events: one epoch over the first 5,000 ratings instead
    part = Dataset.from_uir(bench_data()[:5_000], seed=123)
    n_batches = -(-part.num_ratings // 100)
    prof = epoch_profile(lambda e: IBPR(k=10, max_iter=e, seed=123).fit(part), n_batches, 1)
    log(f"  profile, one IBPR epoch over the first {part.num_ratings} ratings ({n_batches} "
        f"minibatches of 100; a 1-epoch fit minus a 0-epoch fit): {prof['wall_ms']:.1f} ms host "
        f"clock, device busy {prof['busy_ms']:.3f} ms "
        f"({100 * prof['share']:.2f}%), {prof['launches_per_minibatch']:.1f} device events per "
        f"minibatch; top device ops: {prof['top']}")
    log(f"  every model: two seeded fits (the second verbose, in chunks of one epoch or sweep) "
        f"identical, bit for bit; accumulate_rows on the trainers' own inputs ({recorded} "
        f"shapes) equal to the plain version on the CPU, bit for bit (max |err| "
        f"{acc_err:.3e}); serving lists equal to the plain version (positions relaxed as "
        f"near-ties: {sum(relaxed)}); accumulate_rows launches {launches}, fused_topk "
        f"launches {fused}")
    log(f"factor family at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} s, "
        f"second fits {sum(refits.seconds.values()):.1f} s")
    return launches, fused, fit_s, acc_err


def factor_rest_configs():
    """(band name, maker, fitted attributes) of the factor family's rest:
    ``benchmarks/model_sweep.py``'s HPF, SKMeans and FM (als), PF (HPF with
    ``hierarchical=False``), FM's sgd and mcmc learners at
    ``examples/fm_example.py``'s settings, and ``examples/sansa_movielens.py``'s
    SANSA."""
    from cornac_tpu_torch import models as M

    fm = dict(k0=1, k1=1, k2=8, max_iter=100, learning_rate=0.01, seed=123)
    hpf = ("Gs", "Gr", "Ls", "Lr")
    return [
        ("HPF", lambda **kw: M.HPF(k=5, max_iter=100, seed=123, **kw), hpf),
        ("PF", lambda **kw: M.HPF(k=5, max_iter=100, seed=123, hierarchical=False, name="PF",
                                  **kw), hpf),
        ("SKMeans", lambda **kw: M.SKMeans(k=5, max_iter=100, seed=123, **kw),
         ("centroids", "final_par")),
        ("FM-als", lambda **kw: M.FM(k2=8, max_iter=50, method="als", seed=123, name="FM-als",
                                     **kw), ("w", "V")),
        ("FM-sgd", lambda **kw: M.FM(method="sgd", name="FM-sgd", **fm, **kw), ("w", "V")),
        ("FM-mcmc", lambda **kw: M.FM(method="mcmc", name="FM-mcmc", **fm, **kw), ("w", "V")),
        ("SANSA", lambda **kw: M.SANSA(l2=500.0, weight_matrix_density=0.01, **kw),
         ("W1", "W2")),
    ]


def same_bits(a, b):
    """Two fitted arrays (numpy or scipy sparse) equal bit for bit."""
    import scipy.sparse as sp

    if sp.issparse(a):
        a, b = a.tocsr(), b.tocsr()
        return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
                and np.array_equal(a.indices, b.indices) and np.array_equal(a.data, b.data))
    return np.array_equal(a, b)


def phase_factor_rest_bench(bench_data):
    """Phase 12c, RatioSplit -> Experiment with the factor family's rest at
    the bench shape: each model's AUC and NDCG@10 (and FM's RMSE) in its
    band, fit seconds per model, B1 behind HPF's, PF's and SANSA's
    recommend_batch held to the plain version, then a second seeded fit of
    each bit for bit, whose accumulate_rows inputs (the first at each
    shape) are held to the plain version on the CPU. Then phase 12d, the
    protocols (``phase_protocols_bench``), in the same process."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.eval_methods import RatioSplit, rating_eval
    from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set
    configs = factor_rest_configs()
    users = np.random.RandomState(5).choice(train.num_users, 512, replace=False)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    exp = Experiment(split, [make(verbose=False) for _, make, _ in configs],
                     [AUC(), NDCG(k=10), Recall(k=10), RMSE(), MAE()])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clock(f"Experiment.run ({len(configs)} models)", exp.run)
    relaxed = clock("B1 behind HPF's, PF's and SANSA's recommend_batch", lambda: [
        serve_factor_model(m, train, users) for m in exp.models if m.name in ("HPF", "PF", "SANSA")])
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("factor family's rest at the bench shape")
    if launches <= 0 or fused < 3:
        raise AssertionError(f"the factor family's rest launched accumulate_rows {launches} and "
                             f"fused_topk {fused} times")

    # ---- check what came out ----
    fit_s = {}
    for (name, _, _), model, res in zip(configs, exp.models, exp.result):
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{res.model_name}: non-finite metrics {vals}")
        fit_s[name] = res.metric_avg_results["Train (s)"]
        if name.startswith("FM"):
            # the band's RMSE is over the test ratings (the Experiment's
            # averages each user's first)
            vals["RMSE over ratings"] = rating_eval(model, [RMSE()], split.test_set)[0][0]
        checks = []
        for metric in ("AUC", "NDCG@10") + (("RMSE",) if name.startswith("FM") else ()):
            lo, hi, _, spread = band(name, metric)
            value = vals["RMSE over ratings" if metric == "RMSE" else metric]
            inside = lo <= value <= hi
            checks.append(inside)
            log(f"  {name}: {metric} {value:.6f}, band [{lo:.6f}, {hi:.6f}] "
                f"({'one deterministic JAX fit +/- 1e-3' if spread is None else '5 JAX seeds'})"
                f" {'inside' if inside else 'OUTSIDE'}")
        log(f"  {name}: fit {fit_s[name]:.3f} s, test {res.metric_avg_results['Test (s)']:.3f} s "
            f"(host clock); " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(checks):
            raise AssertionError(f"{name}: outside its quality band")
    acc_err, recorded = 0.0, 0
    refits = Clock()
    for (name, make, attrs), model in zip(configs, exp.models):
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = refits(f"{name}.fit", lambda: make(verbose=False).fit(train))
        for attr in attrs:
            if not same_bits(getattr(model, attr), getattr(again, attr)):
                raise AssertionError(f"{name}: two seeded fits differ in {attr}")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    refits.report("factor family's rest, second fits")
    seg = seg_sum_probe(train)
    if recorded < 4:  # HPF's and PF's two shapes, FM-sgd's w and V
        raise AssertionError(f"the factor family's rest recorded {recorded} accumulate_rows shapes")
    log(f"  every model: two seeded fits identical, bit for bit; accumulate_rows on the trainers' "
        f"own inputs ({recorded} shapes) equal to the plain version on the CPU, bit for bit (max "
        f"|err| {acc_err:.3e}); serving lists equal to the plain version (positions relaxed as "
        f"near-ties: {sum(relaxed)}); accumulate_rows launches {launches}, fused_topk launches "
        f"{fused}")
    log(f"factor family's rest at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} "
        f"s, second fits {sum(refits.seconds.values()):.1f} s")
    proto = phase_protocols_bench(bench_data)
    proto["seg_sum"] = seg
    return (launches + proto["launches"], fused + proto["fused"], fit_s, acc_err, proto)


def seg_sum_probe(train):
    """FM-ALS's ``_seg_sum`` at the bench shape: the segment sums of 80,000
    rows of two columns into the user block on the card, held to the same
    sums on the CPU and to a float64 sum (atol 1e-3: a float32 prefix sum's
    error grows with its running total), beside ``accumulate_rows``' sums
    (batch order), both timed with CUDA events; and, reported, how far one
    float32 ALS sweep on the card lies from the same sweep in float64 on the
    CPU (with no regularisation a feature of few ratings divides by a small
    sum of squares). Returns the numbers."""
    import torch

    from cornac_tpu_torch.models import fm as fm_mod
    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    rid, cid, val = train.uir_tuple
    n_feat = train.num_users + train.num_items
    cid_off = np.asarray(cid, np.int64) + train.num_users
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (len(rid), 2)).astype(np.float32)
    blocks = {dev: fm_mod.make_blocks(rid, cid_off, n_feat, dev)[0] for dev in (DEV, "cpu")}
    sums = {dev: fm_mod._seg_sum(torch.as_tensor(x, device=dev), b.perm, b.starts, b.ends)
            for dev, b in blocks.items()}
    exact = torch.zeros(n_feat, 2, dtype=torch.float64).index_add_(
        0, torch.as_tensor(rid, dtype=torch.long), torch.as_tensor(x, dtype=torch.float64))
    seg_err = (sums[DEV].cpu().double() - exact).abs().max().item()
    cpu_err = (sums[DEV].cpu() - sums["cpu"]).abs().max().item()
    if seg_err > 1e-3 or cpu_err > 1e-3:
        raise AssertionError(f"_seg_sum on the card: {seg_err:.3e} from a float64 sum, "
                             f"{cpu_err:.3e} from the CPU's")
    x_d, block = torch.as_tensor(x, device=DEV), blocks[DEV]
    acc = accumulate_rows(torch.zeros(n_feat, 2, device=DEV), block.ids, x_d)
    out = dict(seg_err=seg_err, cpu_err=cpu_err,
               acc_err=(acc.cpu().double() - exact).abs().max().item(),
               seg_ms=time_ms(lambda: fm_mod._seg_sum(x_d, block.perm, block.starts, block.ends),
                              200),
               acc_ms=time_ms(lambda: accumulate_rows(torch.zeros(n_feat, 2, device=DEV),
                                                      block.ids, x_d), 200))
    w = rng.normal(0, 0.1, n_feat).astype(np.float32)
    V = rng.normal(0, 0.1, (n_feat, 8)).astype(np.float32)
    sweeps = {}
    for dev, dt in ((DEV, torch.float32), ("cpu", torch.float64)):
        blocks = [b._replace(cnt=b.cnt.to(dt)) for b in fm_mod.make_blocks(rid, cid_off, n_feat,
                                                                           dev)]
        t = [torch.as_tensor(a, dtype=dt, device=dev) for a in (np.float32(0.0), w, V.copy(),
                                                                np.asarray(val, np.float32))]
        sweeps[dev] = fm_mod._fm_als(*t[:3], t[3], blocks, 0.0, 0.0, 0.0, True, True, True, 1)[2]
    out["sweep_v_err"] = (sweeps[DEV].cpu().double() - sweeps["cpu"]).abs().max().item()
    out["sweep_v_max"] = sweeps["cpu"].abs().max().item()
    log(f"  FM-ALS's _seg_sum, 80,000 x 2 into {n_feat} feature rows (the user block): "
        f"{out['seg_ms']:.4f} ms, max |err| {seg_err:.3e} against a float64 sum, "
        f"{cpu_err:.3e} from the CPU's (both within 1e-3); accumulate_rows (batch order) "
        f"{out['acc_ms']:.4f} ms, max |err| {out['acc_err']:.3e} (CUDA events); one float32 "
        f"ALS sweep (no regularisation) on the card lies {out['sweep_v_err']:.3e} from the "
        f"float64 sweep in V (largest |V| {out['sweep_v_max']:.3e})")
    return out


def bench_quadruples(bench_data, seed=123):
    """The bench data with seeded timestamps: (user, item, rating, time)."""
    data = bench_data()
    times = np.random.RandomState(seed).randint(0, 10**6, size=len(data))
    return [(u, i, r, int(t)) for (u, i, r), t in zip(data, times)]


def same_sets(a, b, what):
    """Two eval methods' train/test/val sets hold the same triples."""
    for split in ("train_set", "test_set", "val_set"):
        x, y = getattr(a, split), getattr(b, split)
        if (x is None) != (y is None) or (x is not None and not all(
                np.array_equal(p, q) for p, q in zip(x.uir_tuple, y.uir_tuple))):
            raise AssertionError(f"{what}: the {split}s differ")


def search_trials(search):
    return [(params, float(score)) for params, score in search.trial_results]


def phase_protocols_bench(bench_data):
    """Phase 12d, the protocols at the bench shape: CrossValidation(5 folds,
    seed 123) over MF(k=10, max_iter=25) and PMF(k=10, max_iter=100) on MAE
    and RMSE (``examples/cross_validation_example.py``); StratifiedSplit
    (by user, chronological) and TimestampSplit (ratio mode) on the bench
    data with seeded timestamps, and PropensityStratifiedEvaluation, each
    an Experiment with HPF and MostPop; GridSearch and RandomSearch (4
    trials) over HPF's k and hierarchical. The folds, splits and strata
    are held to the same protocol built again with the port on the CPU,
    and each search's best_params and per-trial validation scores (within
    1e-4) to the same search run on the CPU."""
    import io

    import cornac_tpu_torch
    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch import models as M
    from cornac_tpu_torch.eval_methods import (CrossValidation, PropensityStratifiedEvaluation,
                                               RatioSplit, StratifiedSplit, TimestampSplit)
    from cornac_tpu_torch.hyperopt import Discrete, GridSearch, RandomSearch
    from cornac_tpu_torch.metrics import AUC, MAE, NDCG, RMSE, Recall
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    data = bench_data()
    quads = bench_quadruples(bench_data)
    hpf = dict(k=5, max_iter=100, seed=123)
    protocols = {
        "CrossValidation": lambda: CrossValidation(data, n_folds=5, seed=123),
        "StratifiedSplit": lambda: StratifiedSplit(quads, group_by="user", chrono=True,
                                                   test_size=0.2, rating_threshold=4.0,
                                                   seed=123),
        "TimestampSplit": lambda: TimestampSplit(quads, test_size=0.2, val_size=0.1,
                                                 rating_threshold=4.0, seed=123),
        "PropensityStratifiedEvaluation": lambda: PropensityStratifiedEvaluation(
            data, n_strata=2, rating_threshold=4.0, seed=123),
    }
    built = {name: clock(f"{name} (set-up)", make) for name, make in protocols.items()}
    search_split = clock("RatioSplit(0.2, 4.0, val 0.1, seed=123)", lambda: RatioSplit(
        data, test_size=0.2, val_size=0.1, rating_threshold=4.0, seed=123))
    space = [Discrete("k", [5, 10]), Discrete("hierarchical", [True, False])]

    def searches(device):
        return [GridSearch(M.HPF(device=device, **hpf), space, AUC(), search_split),
                RandomSearch(M.HPF(device=device, **hpf), space, AUC(), search_split,
                             n_trails=4)]

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    results = {}
    with contextlib.redirect_stdout(io.StringIO()):
        for name in protocols:
            if name == "CrossValidation":
                models = [M.MF(k=10, max_iter=25, seed=123), M.PMF(k=10, max_iter=100, seed=123)]
                metrics = [MAE(), RMSE()]
            else:
                models = [M.HPF(**hpf), M.MostPop()]
                metrics = [AUC(), NDCG(k=10), Recall(k=10), RMSE()]
            exp = Experiment(built[name], models, metrics)
            clock(f"{name}: Experiment ({', '.join(m.name for m in models)})", exp.run)
            results[name] = exp.result
        on_card = [clock(f"{type(s).__name__}: 4 HPF trials", lambda s=s: s.fit(
            search_split.train_set, search_split.val_set)) for s in searches(None)]
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("the protocols at the bench shape")
    if launches <= 0:
        raise AssertionError("the protocols' fits launched no accumulate_rows")

    # ---- check what came out: the same protocols on the CPU ----
    cpu = Clock()
    cornac_tpu_torch.set_default_device("cpu")
    try:
        again = {name: cpu(f"{name} (set-up)", make) for name, make in protocols.items()}
        cv, cv_cpu = built["CrossValidation"], again["CrossValidation"]
        if not np.array_equal(cv._partition, cv_cpu._partition):
            raise AssertionError("CrossValidation: the fold labels differ from the CPU's")
        for fold in range(cv.n_folds):
            cv._build_fold(fold)
            cv_cpu._build_fold(fold)
            same_sets(cv, cv_cpu, f"CrossValidation fold {fold}")
        for name in ("StratifiedSplit", "TimestampSplit", "PropensityStratifiedEvaluation"):
            same_sets(built[name], again[name], name)
        pse, pse_cpu = built["PropensityStratifiedEvaluation"], again[
            "PropensityStratifiedEvaluation"]
        if list(pse.stratified_sets) != list(pse_cpu.stratified_sets) or not all(
                np.array_equal(p, q) for name, s in pse.stratified_sets.items()
                for p, q in zip(s.uir_tuple, pse_cpu.stratified_sets[name].uir_tuple)):
            raise AssertionError("PropensityStratifiedEvaluation: the strata differ from the CPU's")
        with contextlib.redirect_stdout(io.StringIO()):
            on_cpu = [cpu(f"{type(s).__name__} on the CPU: 4 HPF trials", lambda s=s: s.fit(
                search_split.train_set, search_split.val_set)) for s in searches("cpu")]
    finally:
        cornac_tpu_torch.set_default_device(None)
    cpu.report("the protocols on the CPU")
    for card_search, cpu_search in zip(on_card, on_cpu):
        what = type(card_search).__name__
        got, want = search_trials(card_search), search_trials(cpu_search)
        if [p for p, _ in got] != [p for p, _ in want]:
            raise AssertionError(f"{what}: the trial points differ from the CPU's")
        worst = max(abs(g - w) for (_, g), (_, w) in zip(got, want))
        if worst > 1e-4 or card_search.best_params != cpu_search.best_params:
            raise AssertionError(f"{what}: trials {got} on the card, {want} on the CPU")
        log(f"  {what} over HPF k and hierarchical (AUC on the validation set): best "
            f"{card_search.best_params} as on the CPU, trials within {worst:.2e} of the CPU's: "
            + ", ".join(f"{p} {s:.6f}" for p, s in got))
    for name, res in results.items():
        for model_res in res:
            rows = model_res if isinstance(model_res, list) else [model_res]
            for row in rows:
                vals = {k: v for k, v in row.metric_avg_results.items() if "(s)" not in k}
                if not all(np.isfinite(v) for v in vals.values()):
                    raise AssertionError(f"{name}, {row.model_name}: non-finite metrics {vals}")
        log(f"  {name}:\n" + "\n".join("    " + line for line in str(res).splitlines()))
    log(f"  folds, splits and strata equal to the CPU's: CrossValidation {cv.n_folds} folds, "
        f"StratifiedSplit, TimestampSplit, PropensityStratifiedEvaluation "
        f"({len(pse.stratified_sets)} strata); accumulate_rows launches {launches}")
    log(f"the protocols at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} s, "
        f"on the CPU {sum(cpu.seconds.values()):.1f} s")
    return dict(launches=launches, fused=fused, seconds=dict(clock.seconds))


# benchmarks/scale_netflix.py:130-157, WMF at the Netflix widths: the
# interactions cut from ~100M to 20M seeded uniform pairs (item degrees
# about 1,130 instead of 5,650) so that the host build fits the run
WMF_PAIRS, WMF_K, WMF_CHUNK = 20_000_000, 64, 256


def netflix_dataset():
    """20M uniform (user, item) draws from RandomState(0) over 480,000 x
    17,700, duplicates dropped, ratings 1, as ``scale_netflix.build_dataset``
    makes its data."""
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    rng = np.random.RandomState(0)
    u = rng.randint(N_USERS, size=WMF_PAIRS).astype(np.int64)
    i = rng.randint(N_ITEMS, size=WMF_PAIRS).astype(np.int64)
    _, first = np.unique(u * N_ITEMS + i, return_index=True)
    u, i = u[first], i[first]
    return Dataset(
        num_users=N_USERS, num_items=N_ITEMS,
        uid_map=OrderedDict((x, x) for x in range(N_USERS)),
        iid_map=OrderedDict((x, x) for x in range(N_ITEMS)),
        uir_tuple=(u, i, np.ones(len(u))), seed=0,
    )


def phase_wmf_full(seed, ds):
    """WMF(k=64, batch_size=256) at 480,000 x 17,700: a 3-sweep fit (set-up
    included), then one warm and two timed sweeps of the fit's own sweep
    function on its buckets, beside the FLOP bound; peak device memory;
    then recommend_batch of 8,192 users at k=100 through fused_topk, the
    recall_target and bf16 routes, each held to the plain version."""
    import torch

    from cornac_tpu_torch.models import WMF, TPUExactANN
    from cornac_tpu_torch.models import wmf as wmf_mod
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk, fused_topk_torch

    clock = Clock()
    nnz = ds.num_ratings
    dev = torch.device(DEV)

    # ---- the main path, counted ----
    FUSED_TOPK.launches = 0
    torch.cuda.reset_peak_memory_stats()
    model = clock("WMF.fit, 3 sweeps (set-up included)", lambda: WMF(
        k=WMF_K, batch_size=WMF_CHUNK, max_iter=3, seed=123, verbose=False).fit(ds))
    peak_fit = torch.cuda.max_memory_allocated()
    users = np.random.RandomState(seed + 5).choice(N_USERS, SERVE_BATCH, replace=False)
    recs = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                 lambda: model.recommend_batch(list(users), k=TOPK))
    Ud = torch.as_tensor(model.U[users], device=dev)
    Vd = torch.as_tensor(model.V, device=dev)
    ann = TPUExactANN(model, recall_target=0.95)
    ann.build_index()
    ann_ids, _ = clock("TPUExactANN(recall_target=0.95).knn_query", lambda: ann.knn_query(
        model.U[users], TOPK))
    bf16 = clock("fused_topk(precision='bf16')", lambda: fused_topk(Ud, Vd, TOPK,
                                                                   precision="bf16"))
    fused = FUSED_TOPK.launches
    if fused < 3:
        raise AssertionError(f"the WMF path launched fused_topk {fused} times, want 3")

    # ---- check and measure ----
    if not (np.isfinite(model.U).all() and np.isfinite(model.V).all()):
        raise AssertionError("the full-width WMF fit has non-finite factors")
    S = plain_scores(Ud, Vd)
    want = reference_lists(Ud, Vd, TOPK, [set()] * len(users))
    relaxed = check_lists([[model.iid_map[i] for i in row] for row in recs], want,
                          S.cpu().numpy(), "WMF recommend_batch")
    relaxed += check_lists(ann_ids, want, S.cpu().numpy(), "WMF TPUExactANN(recall_target=0.95)")
    rU, rV = (t.to(torch.bfloat16).float() for t in (Ud, Vd))
    ps, pi = fused_topk_torch(rU, rV, TOPK + 1)
    _, bf_rel = compare_topk(*bf16, ps, pi, plain_scores(rU, rV), "WMF bf16 route")
    del S, ps, pi
    csr = ds.csr_matrix
    groups = clock("the fit's buckets again (host)", lambda: [
        wmf_mod._bucketed_csr(m, WMF_K, dev) for m in (csr, csr.T.tocsr())])
    consts = tuple(float(np.float32(x)) for x in (model.a, model.b, model.lambda_u,
                                                  model.lambda_v))
    U, V = torch.as_tensor(model.U, device=dev), torch.as_tensor(model.V, device=dev)
    torch.cuda.reset_peak_memory_stats()
    U, V = clock("one warm sweep", lambda: wmf_mod._als_sweeps_bucketed(U, V, *groups,
                                                                          *consts, 1))
    sweep_s = []
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        U, V = wmf_mod._als_sweeps_bucketed(U, V, *groups, *consts, 1)
        end.record()
        torch.cuda.synchronize()
        sweep_s.append(start.elapsed_time(end) / 1e3)
    peak_sweep = torch.cuda.max_memory_allocated()
    wall_ms, busy_ms, events, ops = profile_call(
        lambda: wmf_mod._als_sweeps_bucketed(U, V, *groups, *consts, 1))
    flops = 2 * 2 * nnz * WMF_K**2 + (N_USERS + N_ITEMS) * WMF_K**3 / 3
    bound_s = flops / PEAK_F32_FLOPS
    clock.report("WMF at the Netflix widths")
    deg_items = np.diff(csr.tocsc().indptr)
    log(f"  WMF k={WMF_K} over {nnz:,} pairs ({N_USERS:,} users x {N_ITEMS:,} items, cut from "
        f"~100M; item degrees {deg_items.min()}-{deg_items.max()}): seconds per sweep "
        f"{sweep_s[0]:.4f}, {sweep_s[1]:.4f} (CUDA events); FLOP bound {flops:.4e} FLOP = "
        f"2*2*nnz*k^2 + (users + items)*k^3/3 over {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = "
        f"{bound_s:.5f} s, {100 * bound_s / min(sweep_s):.2f}% of it; "
        f"{len(groups[0])} user and {len(groups[1])} item buckets")
    log(f"  profile, one sweep: {wall_ms:.1f} ms host clock, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.2f}%), {events} device events; top device ops: "
        f"{top_ops(ops, 6)}")
    log(f"  peak device memory: the 3-sweep fit {peak_fit / 2**30:.3f} GiB, the timed sweeps "
        f"{peak_sweep / 2**30:.3f} GiB")
    log(f"  recommend_batch ({SERVE_BATCH} users, k={TOPK}) and TPUExactANN(recall_target=0.95):"
        f" the exact lists of the plain version (positions relaxed as near-ties: {relaxed}); "
        f"bf16 route equal to the plain version on rounded operands (relaxed {bf_rel}); "
        f"fused_topk launches {fused}")
    log(f"WMF at the Netflix widths: ok in {sum(clock.seconds.values()):.1f} s")
    del groups, U, V, Ud, Vd, ann
    torch.cuda.empty_cache()
    return fused, dict(sweep_s=sweep_s, bound_s=bound_s, peak_fit=peak_fit,
                       peak_sweep=peak_sweep, nnz=nnz)


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


def neural_configs():
    """(band name, the depth's keyword, maker) of ``benchmarks/model_sweep.py``'s
    configurations of the neural family, with GMF and MLP at NeuMF's depth
    and NGCF at LightGCN's."""
    from cornac_tpu_torch import models as M

    def make(cls, **fixed):
        return lambda **kw: cls(**{**fixed, **kw})

    return [
        ("VAECF", "n_epochs", make(M.VAECF, k=10, n_epochs=100, seed=123)),
        ("RecVAE", "n_epochs", make(M.RecVAE, n_epochs=20, seed=123)),
        ("BiVAECF", "n_epochs", make(M.BiVAECF, k=10, n_epochs=100, seed=123)),
        ("GMF", "num_epochs", make(M.GMF, num_factors=8, num_epochs=10, seed=123)),
        ("MLP", "num_epochs", make(M.MLP, layers=(32, 16, 8), num_epochs=10, seed=123)),
        ("NeuMF", "num_epochs", make(M.NeuMF, num_factors=8, layers=(32, 16, 8),
                                     num_epochs=10, seed=123)),
        ("LightGCN", "num_epochs", make(M.LightGCN, emb_size=64, num_layers=3, num_epochs=40,
                                        seed=2020)),
        ("NGCF", "num_epochs", make(M.NGCF, emb_size=64, num_epochs=40, seed=2020)),
    ]


def fitted_arrays(model):
    """A neural model's fitted state as {name: numpy array}: its modules'
    parameters (``params``, or RecVAE's ``enc`` and ``dec``) and its
    scoring tables (BiVAECF's means, LightGCN's propagated ``U``, ``V``)."""
    import torch

    out = {}
    for attr in ("params", "enc", "dec"):
        module = getattr(model, attr, None)
        if isinstance(module, torch.nn.Module):
            out.update({f"{attr}.{n}": p.detach().cpu().numpy()
                        for n, p in module.named_parameters()})
    for attr in ("mu_theta", "mu_beta", "U", "V"):
        if hasattr(model, attr):
            out[attr] = np.asarray(getattr(model, attr))
    return out


def phase_neural_bench(bench_data, names):
    """RatioSplit -> Experiment with the neural family's configurations
    ``names`` at the bench shape: each model's AUC and NDCG@10 in its band,
    fit seconds per model, B1 behind BiVAECF's recommend_batch, VAECF's
    recommend_batch(k > 0) refused as in the JAX package; then two seeded
    fits of each at a depth of 2 epochs (the second verbose) bit for bit,
    whose accumulate_rows inputs (the first at each shape) are held to the
    plain version; the profile of one NeuMF epoch over the first 5,000
    ratings. Returns (accumulate_rows launches, fused_topk launches, fit
    seconds by name, max |kernel - plain| of the recorded inputs, the
    profile or None)."""
    import io

    from cornac_tpu_torch import Experiment
    from cornac_tpu_torch.data import Dataset
    from cornac_tpu_torch.eval_methods import RatioSplit
    from cornac_tpu_torch.metrics import AUC, NDCG, Recall
    from cornac_tpu_torch.models import NeuMF
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    split = clock("RatioSplit(0.2, 4.0, seed=123)", lambda: RatioSplit(
        bench_data(), test_size=0.2, rating_threshold=4.0, seed=123, verbose=False))
    train = split.train_set
    configs = [c for c in neural_configs() if c[0] in names]
    users = np.random.RandomState(5).choice(train.num_users, 512, replace=False)
    gathers = set(names) & {"GMF", "MLP", "NeuMF", "LightGCN", "NGCF"}  # via gather_rows
    what = "neural family (" + ", ".join(names) + ")"

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    exp = Experiment(split, [make(verbose=False) for _, _, make in configs],
                     [AUC(), NDCG(k=10), Recall(k=10)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clock(f"Experiment.run ({len(configs)} neural models)", exp.run)
    models = dict(zip((name for name, _, _ in configs), exp.models))
    relaxed = 0
    if "BiVAECF" in models:
        relaxed = clock("B1 behind BiVAECF.recommend_batch",
                        lambda: serve_factor_model(models["BiVAECF"], train, users))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report(what)
    if (gathers and launches <= 0) or ("BiVAECF" in models and fused <= 0):
        raise AssertionError(f"{what} launched accumulate_rows {launches} and fused_topk "
                             f"{fused} times")

    # ---- check what came out ----
    if "VAECF" in models:
        try:  # the JAX package raises TypeError here: k=10 means against 20-wide item rows
            models["VAECF"].recommend_batch([train.user_ids[u] for u in users[:4]], k=10)
            raise AssertionError("VAECF.recommend_batch(k=10) with a 20-wide decoder answered")
        except ValueError as err:
            log(f"  VAECF.recommend_batch(k=10): refused as in the JAX package ({err})")
    fit_s = {}
    for (name, _, _), model, res in zip(configs, exp.models, exp.result):
        vals = {k: v for k, v in res.metric_avg_results.items() if "(s)" not in k}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"{res.model_name}: non-finite metrics {vals}")
        fit_s[name] = res.metric_avg_results["Train (s)"]
        checks = []
        for metric in ("AUC", "NDCG@10"):
            lo, hi, _, _ = band(name, metric)
            inside = lo <= vals[metric] <= hi
            checks.append(inside)
            log(f"  {name}: {metric} {vals[metric]:.6f}, band [{lo:.6f}, {hi:.6f}] (5 JAX "
                f"seeds) {'inside' if inside else 'OUTSIDE'}")
        log(f"  {name}: fit {fit_s[name]:.3f} s, test {res.metric_avg_results['Test (s)']:.3f} s "
            f"(host clock); " + ", ".join(f"{k} {v:.4f}" for k, v in vals.items()))
        if not all(checks):
            raise AssertionError(f"{name}: outside its quality band")
    acc_err, recorded = 0.0, 0
    refits = Clock()
    for name, depth, make in configs:
        short = {depth: SHORT_DEPTH}
        first = refits(f"{name}.fit, {SHORT_DEPTH} epochs", lambda: make(**short).fit(train))
        with contextlib.redirect_stdout(io.StringIO()), recording_accumulate({}) as store:
            again = refits(f"{name}.fit, verbose=True, {SHORT_DEPTH} epochs",
                           lambda: make(verbose=True, **short).fit(train))
        want, got = fitted_arrays(first), fitted_arrays(again)
        if not want or want.keys() != got.keys():
            raise AssertionError(f"{name}: fitted state {sorted(want)} vs {sorted(got)}")
        for key in want:
            if not np.array_equal(want[key], got[key]):
                raise AssertionError(f"{name}: two seeded fits differ in {key} (one verbose)")
        acc_err = max(acc_err, check_recorded_accumulate(name, store))
        recorded += len(store)
    refits.report(f"{what}, second fits")
    if gathers and recorded == 0:
        raise AssertionError(f"no trainer of the {what} handed accumulate_rows an input")
    prof = None
    if "NeuMF" in models:
        part = Dataset.from_uir(bench_data()[:5_000], seed=123)
        n_batches = -(-part.num_ratings * 5 // 256)
        prof = epoch_profile(lambda e: NeuMF(num_factors=8, layers=(32, 16, 8), num_epochs=e,
                                             seed=123, verbose=False).fit(part), n_batches, 1)
        log(f"  profile, one NeuMF epoch over the first {part.num_ratings} ratings ({n_batches} "
            f"minibatches of 256; a 1-epoch fit minus a 0-epoch fit): {prof['wall_ms']:.1f} ms "
            f"host clock, device busy {prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
            f"{prof['launches_per_minibatch']:.1f} device events per minibatch; top device ops: "
            f"{prof['top']}")
    log(f"  every model: two seeded fits of {SHORT_DEPTH} epochs (the second verbose, in chunks "
        f"of one epoch) identical, bit for bit; accumulate_rows on the trainers' own inputs "
        f"({recorded} shapes) equal to the plain version on the CPU, bit for bit (max |err| "
        f"{acc_err:.3e}); BiVAECF's serving lists equal to the plain version (positions relaxed "
        f"as near-ties: {relaxed}); accumulate_rows launches {launches}, fused_topk launches "
        f"{fused}")
    log(f"{what} at the bench shape: ok, main path {sum(clock.seconds.values()):.1f} s, "
        f"second fits {sum(refits.seconds.values()):.1f} s")
    return launches, fused, fit_s, acc_err, prof


def phase_lightgcn_ml10m(train, gen):
    """LightGCN's edge-form propagation at the ML-10M widths (69,878 users x
    10,677 items, 10,000,054 edges, d = 64), the adjacency as LightGCN.fit
    builds it (far past the dense budget): one step forward and backward
    through gather_rows and accumulate_rows, then LightGCN's 3-layer mean
    forward and backward, counted; the step's four outputs held bit for bit
    to the same step on the CPU, where ``accumulate_rows`` is its plain
    version (``index_add_`` in edge order), two calls bit for bit; times of
    the step and the 3 layers beside the plain version on the card
    (``index_add_``, atomic), four cuSPARSE products (the same function's
    forward and backward as CSR x dense) and the bound."""
    import torch

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.graph import NormAdjacency, layer_mean, propagate, propagate_torch

    clock = Clock()
    adj = clock("NormAdjacency (set-up)", lambda: NormAdjacency(train))
    if adj.dense is not None:
        raise AssertionError("the ML-10M adjacency took the dense form")
    nu, ni, E, d = train.num_users, train.num_items, adj.edge_u.numel(), 64
    ue, ie, gu, gi = (torch.randn(n, d, generator=gen, device=DEV) for n in (nu, ni, nu, ni))
    eu, ei, w = adj.edge_u, adj.edge_i, adj.edge_norm

    def fwd_bwd(fn, x=(ue, ie, gu, gi)):
        u, i = x[0].clone().requires_grad_(True), x[1].clone().requires_grad_(True)
        a, b = fn(u, i)
        return (a.detach(), b.detach(), *torch.autograd.grad([a, b], [u, i], x[2:]))

    def layers(u, i):
        return adj.lightgcn(u, i, 3)

    def plain(u, i):
        return propagate_torch(u, i, eu, ei, w)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = 0
    got = clock("one step, forward and backward", lambda: fwd_bwd(adj.propagate))
    step_launches = ACCUMULATE_ROWS.launches
    clock("3 layers, forward and backward", lambda: fwd_bwd(layers))
    launches = ACCUMULATE_ROWS.launches
    clock.report("LightGCN edge form at ML-10M")
    if step_launches != 4 or launches != 4 + 12:
        raise AssertionError(f"{step_launches} and {launches} accumulate_rows launches, want 4 "
                             f"and 16")

    # ---- check and measure ----
    again = fwd_bwd(adj.propagate)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError("two calls of the edge-form step differ")
    names = ("messages to users", "messages to items", "gradient of users", "gradient of items")
    on_cpu = [t.cpu() for t in (eu, ei, w)]
    want = fwd_bwd(lambda u, i: propagate(u, i, *on_cpu), tuple(t.cpu() for t in (ue, ie, gu, gi)))
    max_err = 0.0
    for name, k_out, c_out in zip(names, got, want):
        k_out = k_out.cpu()
        max_err = max(max_err, (k_out - c_out).abs().max().item())
        if not torch.equal(k_out, c_out):
            raise AssertionError(f"ML-10M {name}: the kernel differs from the plain version on "
                                 f"the CPU, max |kernel - plain| {max_err:.3e}")
    del want, on_cpu
    ref = fwd_bwd(plain)
    card_err = max((k_out - p_out).abs().max().item() for k_out, p_out in zip(got, ref))
    del ref, again
    torch.cuda.empty_cache()
    rows_u = torch.sparse_coo_tensor(torch.stack([eu, ei]), w, (nu, ni)).coalesce().to_sparse_csr()
    rows_i = torch.sparse_coo_tensor(torch.stack([ei, eu]), w, (ni, nu)).coalesce().to_sparse_csr()

    def library():  # A·ie, Aᵀ·ue forward; Aᵀ·gu, A·gi backward
        return (torch.sparse.mm(rows_u, ie), torch.sparse.mm(rows_i, ue),
                torch.sparse.mm(rows_i, gu), torch.sparse.mm(rows_u, gi))

    ms = time_ms(lambda: fwd_bwd(adj.propagate), 5, 1)
    plain_ms = time_ms(lambda: fwd_bwd(plain), 5, 1)
    library_ms = time_ms(library, 5, 1)
    layers_ms = time_ms(lambda: fwd_bwd(layers), 3, 1)
    layers_plain_ms = time_ms(lambda: fwd_bwd(lambda u, i: layer_mean(plain, u, i, 3)), 3, 1)
    nbytes = 4.0 * 2 * 2 * (nu + ni) * d + 20.0 * E
    flops = 2.0 * 4 * E * d
    bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
    bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    log(f"  LightGCN edge form, ML-10M ({nu:,} users x {ni:,} items, {E:,} edges, d={d}): one "
        f"step forward and backward (4 accumulate_rows launches) {ms:.3f} ms, plain "
        f"(index_add_ and autograd's gather) {plain_ms:.3f} ms, 4 cuSPARSE CSR x dense "
        f"products {library_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {flops:.3e} FLOP, "
        f"{nbytes / 1e6:.1f} MB), {100 * bound_ms / ms:.3f}% of it; 3 layers forward and "
        f"backward {layers_ms:.3f} ms, plain {layers_plain_ms:.3f} ms (CUDA events)")
    log(f"  the step's four outputs equal to the step on the CPU (accumulate_rows' plain "
        f"version), bit for bit; max |kernel - plain on the card (index_add_, atomic)| "
        f"{card_err:.3e}; two calls bit-identical; accumulate_rows launches {launches}")
    log(f"LightGCN edge form at ML-10M: ok in {sum(clock.seconds.values()):.1f} s")
    del rows_u, rows_i
    torch.cuda.empty_cache()
    return launches, dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, layers_ms=layers_ms,
                          layers_plain_ms=layers_plain_ms, max_abs_err=max_err,
                          card_plain_max_abs_err=card_err)


# examples/hpf_movielens.py's HPF (k = 5, 100 sweeps) on phase 10's train set
HPF_ML10M = dict(k=5, seed=123)
HPF_SWEEPS = 100
HPF_RTOL, HPF_ATOL = 3e-5, 1e-6


def phase_hpf_ml10m(train, seed):
    """HPF at the ML-10M widths (69,878 users x 10,677 items, 10,000,054
    ratings, k = 5), phase 10's train set: fits of 1 and of 3 sweeps on
    the card held to the same fits on the CPU (rtol ``HPF_RTOL``: digamma,
    exp and the column sums differ by ulps between the two devices; the
    scatters do not), the first sweep's two accumulate_rows inputs held bit
    for bit to the plain version on the CPU and timed, a second 3-sweep
    fit bit for bit, the 100-sweep fit timed (seconds per sweep from a
    100-sweep fit minus a 3-sweep fit) beside a sweep's byte bound, the
    device-busy share and peak device memory; then recommend_batch for
    8,192 users at k = 100 through fused_topk (d = 5), every list held to
    the plain version. Returns (accumulate_rows launches, fused_topk
    launches, the fitted model, the users served, the stats)."""
    import torch

    from cornac_tpu_torch.models import HPF
    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS, accumulate_rows
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    clock = Clock()
    tables = ("Gs", "Gr", "Ls", "Lr")

    def fit(sweeps, device=None):
        return HPF(max_iter=sweeps, device=device, **HPF_ML10M).fit(train)

    # ---- the main path, counted ----
    ACCUMULATE_ROWS.launches = FUSED_TOPK.launches = 0
    with recording_accumulate({}) as store:
        one = clock("HPF.fit, 1 sweep", lambda: fit(1))
    three = clock("HPF.fit, 3 sweeps", lambda: fit(3))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model = clock(f"HPF.fit, {HPF_SWEEPS} sweeps", lambda: fit(HPF_SWEEPS))
    peak = torch.cuda.max_memory_allocated() - held
    rng = np.random.RandomState(seed + 4)
    users = rng.choice(train.num_users, SERVE_BATCH, replace=False)
    recs = clock(f"recommend_batch {SERVE_BATCH} users k={TOPK}",
                 lambda: model.recommend_batch(list(users), k=TOPK))
    launches, fused = ACCUMULATE_ROWS.launches, FUSED_TOPK.launches
    clock.report("HPF at ML-10M")
    if launches != 2 * (1 + 3 + HPF_SWEEPS) or fused <= 0:
        raise AssertionError(f"HPF launched accumulate_rows {launches} times (want "
                             f"{2 * (4 + HPF_SWEEPS)}) and fused_topk {fused}")

    # ---- check and measure ----
    again = clock("HPF.fit, 3 sweeps, again", lambda: fit(3))
    for name in tables:
        if not np.array_equal(getattr(three, name), getattr(again, name)):
            raise AssertionError(f"HPF at ML-10M: two seeded 3-sweep fits differ in {name}")
    worst = 0.0
    for sweeps, on_card in ((1, one), (3, three)):
        on_cpu = clock(f"HPF.fit on the CPU, {sweeps} sweep(s)", lambda: fit(sweeps, "cpu"))
        for name in tables:
            a, b = getattr(on_card, name), getattr(on_cpu, name)
            rel = float(np.max(np.abs(a - b) / (HPF_ATOL + np.abs(b))))
            worst = max(worst, rel)
            if not np.allclose(a, b, rtol=HPF_RTOL, atol=HPF_ATOL):
                raise AssertionError(f"HPF at ML-10M, {sweeps} sweep(s): {name} on the card "
                                     f"differs from the CPU's beyond rtol {HPF_RTOL}")
    if len(store) != 2:
        raise AssertionError(f"the first sweep recorded {len(store)} accumulate_rows shapes")
    acc_err, acc_ms = 0.0, {}
    for (shape, B, stride), (table, ids, upd) in store.items():
        # not profiled: this late in the process the profiler loses the
        # kernel's events; at tens of ms a launch, CUDA events time it
        err = check_accumulate(f"HPF's first sweep, {B} ids into {shape}", table, ids, upd,
                               calls=0)[0]
        acc_err, acc_ms[shape[0]] = max(acc_err, err), time_ms(
            lambda: accumulate_rows(table.clone(), ids, upd), 3, 1)
    del store
    if not all(np.isfinite(getattr(model, name)).all() for name in ("Theta", "Beta")):
        raise AssertionError("the 100-sweep fit has non-finite tables")
    # the 1-sweep fit records its scatters' inputs (copies of 10M rows): the
    # 3-sweep fit is the set-up to subtract
    sweep_s = (clock.seconds[f"HPF.fit, {HPF_SWEEPS} sweeps"]
               - clock.seconds["HPF.fit, 3 sweeps"]) / (HPF_SWEEPS - 3)
    nu, ni, n, k = train.num_users, train.num_items, train.num_ratings, HPF_ML10M["k"]
    # a sweep must read the ratings (two int64 ids and a float32 value) once
    # and read and write each table row once (G_s, G_r, L_s, L_r and the
    # rates K_r, T_r)
    nbytes = 20.0 * n + 2 * 4.0 * (2 * (nu + ni) * k + nu + ni)
    bound_s = nbytes / PEAK_BYTES
    # the busy share of 3 sweeps alone (the sweep function on the fit's own
    # device tensors, no uploads), from the profiler's device events; this
    # late in the process it may lose some, and then the share is not
    # measured (6 accumulate_rows launches must be seen)
    state = [torch.as_tensor(np.asarray(t, np.float32), device=DEV)
             for t in HPF(**HPF_ML10M, max_iter=0).fit(train)._initial_tables()]
    state += [torch.ones(nu, device=DEV), torch.ones(ni, device=DEV)]
    edges = [torch.as_tensor(np.asarray(a, dt), device=DEV)
             for a, dt in zip(train.uir_tuple, (np.int64, np.int64, np.float32))]
    from cornac_tpu_torch.models.hpf import _hpf_cavi

    _hpf_cavi(*state, *edges, 1, True)  # warm
    wall_ms, busy_ms, _, events = profile_call(lambda: _hpf_cavi(*state, *edges, 3, True))
    kept = sum(e.count for e in events if "accumulate_rows_kernel" in e.key)
    share = busy_ms / wall_ms if kept == 6 else None
    log(f"  HPF k={k} over {n:,} ratings ({nu:,} users x {ni:,} items): {sweep_s * 1e3:.3f} ms per "
        f"sweep (a {HPF_SWEEPS}-sweep fit minus a 3-sweep fit, over {HPF_SWEEPS - 3}); byte bound "
        f"{bound_s * 1e3:.4f} ms per sweep ({nbytes / 1e6:.1f} MB over {PEAK_BYTES / 1e12:.2f} "
        f"TB/s), {100 * bound_s / sweep_s:.3f}% of it; accumulate_rows "
        + ", ".join(f"{ms:.3f} ms into {R:,} rows" for R, ms in acc_ms.items())
        + " (CUDA events, the table copied in each)"
        + "; 3 sweeps busy "
        + (f"{100 * share:.2f}%" if share is not None else
           f"not measured (the profiler kept {kept} of 6 accumulate_rows events)")
        + f" ({wall_ms:.1f} ms host clock, {busy_ms:.3f} ms device, top device ops "
        f"{top_ops(events)}); peak device memory of the fit {peak / 2**30:.3f} GiB above "
        f"what the run held")
    del state, edges
    log(f"  fits of 1 and 3 sweeps equal to the CPU's within rtol {HPF_RTOL} / atol {HPF_ATOL} "
        f"(max |card - cpu| / (atol + |cpu|) {worst:.3e}); two seeded 3-sweep fits bit for bit; "
        f"the first sweep's accumulate_rows inputs equal to the plain version on the CPU, bit "
        f"for bit (max |err| {acc_err:.3e})")
    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(model.get_user_vectors(), np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(model.get_item_vectors(), np.float32), device=dev)
    want = reference_lists(Ud[users], Vd, TOPK, [set()] * len(users))
    got = [[model.iid_map[i] for i in row] for row in recs]
    relaxed = check_lists(got, want, plain_scores(Ud[users], Vd).cpu().numpy(),
                          "HPF recommend_batch")
    log(f"  recommend_batch ({SERVE_BATCH} users, k={TOPK}, d={k}): equal to the plain version "
        f"(positions relaxed as near-ties: {relaxed}); fused_topk launches {fused}")
    log(f"HPF at ML-10M: ok in {sum(clock.seconds.values()):.1f} s")
    torch.cuda.empty_cache()
    return launches, fused, model, users, dict(
        sweep_s=sweep_s, bound_s=bound_s, share=share, peak=peak, acc_ms=acc_ms,
        max_abs_err=acc_err, worst_rel=worst)


# benchmarks/vaecf_sparse_stream.py:38-39, VAECF at the Netflix widths
VAECF_FULL = dict(k=32, autoencoder_structure=[100], batch_size=1024, learning_rate=0.001, seed=1)


def phase_vaecf_full(ds, seed):
    """VAECF at 480,000 x 17,700 on the WMF phase's 20M pairs: fits of 1 and
    of 1 + 3 epochs (the index-resident mode: 34 GB dense, 160 MB of
    coordinates), seconds per steady epoch beside the FP32 FLOP bound, peak
    device memory; the fit's input and progress (three batches' blocks
    densified on the card equal to the binarized rows of the train matrix,
    every parameter tensor moved from its initial value, a 0-epoch fit's,
    by the first epoch and again by the next three); score_batch of 8,192
    users, their top-100 held to a float64 scoring of the same parameters;
    recommend for one user."""
    import torch

    from cornac_tpu_torch.engine.nn import ACTIVATIONS
    from cornac_tpu_torch.models import VAECF
    from cornac_tpu_torch.models.vaecf import _decode, _encode, batch_source

    clock = Clock()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' tensors the times phase reuses
    fit1 = clock("VAECF.fit, 1 epoch", lambda: VAECF(n_epochs=1, **VAECF_FULL).fit(ds))
    model = clock("VAECF.fit, 4 epochs", lambda: VAECF(n_epochs=4, **VAECF_FULL).fit(ds))
    peak = torch.cuda.max_memory_allocated()
    users = np.random.RandomState(seed + 7).choice(N_USERS, SERVE_BATCH, replace=False)
    scores = clock(f"score_batch {SERVE_BATCH} users", lambda: model.score_batch(users))
    uid = ds.user_ids[int(users[0])]
    rec = clock("recommend (one user, k=100)", lambda: model.recommend(uid, k=TOPK))
    clock.report("VAECF at the Netflix widths")
    if model.data_mode != "index-resident":
        raise AssertionError(f"the full-width VAECF fit took the {model.data_mode} mode")
    if not all(torch.isfinite(p).all() for p in model.params.parameters()):
        raise AssertionError("the full-width VAECF fit has non-finite parameters")
    if scores.shape != (SERVE_BATCH, N_ITEMS) or not np.isfinite(scores).all():
        raise AssertionError(f"score_batch gave {scores.shape}")

    # what the fit trained on: the index-resident blocks of the first, a
    # middle and the last (padded) batch are the binarized rows
    dev, bsz = torch.device(DEV), VAECF_FULL["batch_size"]
    n_rows = model.r_mat.shape[0]
    n_batches = -(-n_rows // bsz)
    mode, fetch = batch_source(model.r_mat, bsz, dev)
    if mode != "index-resident":
        raise AssertionError(f"the batch source took the {mode} mode")
    for b in (0, n_batches // 2, n_batches - 1):
        rows = model._rows(np.arange(b * bsz, min((b + 1) * bsz, n_rows)))
        want = torch.zeros((bsz, N_ITEMS))
        want[:rows.shape[0]] = torch.from_numpy(rows)
        if not torch.equal(fetch(b).cpu(), want):
            raise AssertionError(f"batch {b}'s densified block differs from the train rows")
    del fetch
    # and that it trained: every tensor moved, the decoder's too (it has no
    # gradient where the blocks are zeros)
    init = VAECF(n_epochs=0, **VAECF_FULL).fit(ds).params
    stages = [dict(m.named_parameters()) for m in (init, fit1.params, model.params)]
    steps = (("epoch 1", stages[0], stages[1]), ("epochs 2-4", stages[1], stages[2]))
    still = [f"{name} ({when})" for name in stages[0] for when, a, b in steps
             if torch.equal(a[name], b[name])]
    if still:
        raise AssertionError(f"VAECF parameters that did not move: {still}")
    del init, stages, fit1

    # the plain scoring: the same parameters and rows in float64
    vae64, act = copy.deepcopy(model.params).double(), ACTIVATIONS[model.act_fn]
    S = torch.empty((SERVE_BATCH, N_ITEMS), dtype=torch.float64)
    with torch.no_grad():
        for s in range(0, SERVE_BATCH, 1024):
            x = torch.as_tensor(model._rows(users[s:s + 1024]), device=dev).double()
            S[s:s + 1024] = _decode(vae64, _encode(vae64, x, act)[0], act, model.likelihood).cpu()
    want = torch.sort(S, dim=1, descending=True, stable=True)[1][:, :TOPK].numpy()
    got = np.argsort(-scores, axis=1, kind="stable")[:, :TOPK]
    relaxed = check_lists(got, want, S.numpy(), "VAECF score_batch top-100")
    if [model.iid_map[i] for i in rec] != [ds.item_ids[i] for i in got[0]]:
        raise AssertionError("recommend for one user differs from its score_batch row")
    epoch_s = (clock.seconds["VAECF.fit, 4 epochs"] - clock.seconds["VAECF.fit, 1 epoch"]) / 3
    # where a batch's time goes: an epoch over the first 50 batches' users
    # (the same shapes a batch; a whole epoch would give the profiler some
    # 50,000 events), a 1-epoch fit minus a 0-epoch fit
    from collections import OrderedDict

    from cornac_tpu_torch.data import Dataset

    n_part = 50 * VAECF_FULL["batch_size"]
    u, i, r = ds.uir_tuple
    keep = u < n_part
    part = Dataset(num_users=n_part, num_items=N_ITEMS,
                   uid_map=OrderedDict((x, x) for x in range(n_part)),
                   iid_map=OrderedDict((x, x) for x in range(N_ITEMS)),
                   uir_tuple=(u[keep], i[keep], r[keep]), seed=0)
    prof = epoch_profile(lambda e: VAECF(n_epochs=e, **VAECF_FULL).fit(part), 50, 1)
    h, z = VAECF_FULL["autoencoder_structure"][0], VAECF_FULL["k"]
    row_flops = 2.0 * (N_ITEMS * h + 2 * h * z + z * h + h * N_ITEMS)
    flops = 3 * row_flops * n_batches * VAECF_FULL["batch_size"]
    bound_s = flops / PEAK_F32_FLOPS
    log(f"  VAECF k={z} [{h}] batch {VAECF_FULL['batch_size']} over {ds.num_ratings:,} pairs "
        f"({N_USERS:,} users x {N_ITEMS:,} items, {model.data_mode}): {epoch_s:.3f} s per steady "
        f"epoch ((fit of 4 epochs - fit of 1) / 3, host clock); FP32 FLOP bound {flops:.4e} FLOP "
        f"= 3 x {row_flops / 1e6:.3f} MFLOP x {n_batches} x {VAECF_FULL['batch_size']} rows over "
        f"{PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s = {bound_s:.4f} s, {100 * bound_s / epoch_s:.2f}% "
        f"of it; peak device memory {peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} GiB "
        f"above the {held / 2**30:.3f} GiB the run held before the fits")
    log(f"  profile, one epoch over the first {n_part:,} users (50 batches; a 1-epoch fit minus "
        f"a 0-epoch fit): {prof['wall_ms']:.1f} ms host clock, device busy "
        f"{prof['busy_ms']:.3f} ms ({100 * prof['share']:.2f}%), "
        f"{prof['launches_per_minibatch']:.1f} device events per batch; top device ops: "
        f"{prof['top']}")
    log(f"  the fit's input: batches 0, {n_batches // 2} and {n_batches - 1} densified on the "
        f"card equal to the train rows; all {len(dict(model.params.named_parameters()))} "
        f"parameter tensors moved in epoch 1 and again in epochs 2-4")
    log(f"  score_batch ({SERVE_BATCH} users): top-{TOPK} equal to a float64 scoring of the same "
        f"parameters (positions relaxed as near-ties: {relaxed}); recommend for one user equal "
        f"to its row")
    log(f"VAECF at the Netflix widths: ok in {sum(clock.seconds.values()):.1f} s")
    del model, vae64, scores, S
    torch.cuda.empty_cache()
    return dict(epoch_s=epoch_s, bound_s=bound_s, peak=peak - held, share=prof["share"],
                fit1_s=clock.seconds["VAECF.fit, 1 epoch"],
                fit4_s=clock.seconds["VAECF.fit, 4 epochs"])


def phase_times(bpr, users, batches=(1, 256, SERVE_BATCH), what="BPR"):
    """CUDA-event times of fused_topk at each batch size of ``batches``
    (the serving model's vectors, for the first B of ``users``), each with
    its split S, against its plain version and ``matmul`` + ``topk`` timed
    in turn (plain, kernel, library), beside the bound."""
    import torch

    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK, fused_topk_torch

    dev = torch.device(DEV)
    Ud = torch.as_tensor(np.asarray(bpr.get_user_vectors()[users], np.float32), device=dev)
    Vd = torch.as_tensor(np.asarray(bpr.get_item_vectors(), np.float32), device=dev)
    N, d = Vd.shape
    rows = {}
    for B in batches:
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
                       bound_ms=bound_ms, bound_by=bound_by, slices=S, d=d, items=N)
        log(f"  times ({what}) B={B} N={N} d={d} k={TOPK} S={S}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, matmul+topk {library_ms:.4f} ms ({library_ms / ms:.2f}x the "
            f"kernel), bound {bound_ms:.4f} ms ({bound_by}), {B / ms * 1e3:,.0f} users/s, "
            f"{100 * bound_ms / ms:.2f}% of bound")
    return rows


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


def deterministic_index_add(table, ids, upd, reps):
    """``index_add_`` under ``torch.use_deterministic_algorithms(True)``:
    its CUDA-event ms, whether two launches give the same bits, whether
    those are the kernel's (the plain version's sums in batch order) and
    whether it runs under ``torch.cuda.set_sync_debug_mode("error")`` (no
    wait for the card). Both modes are restored; the port calls neither."""
    import torch

    from cornac_tpu_torch.ops.accumulate import accumulate_rows

    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        ms = time_ms(lambda: table.index_add_(0, ids, upd), reps)
        a, b = (table.clone().index_add_(0, ids, upd) for _ in range(2))
        same_bits = torch.equal(a, b)
        as_kernel = torch.equal(a, accumulate_rows(table.clone(), ids, upd))
        t = table.clone()
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t.index_add_(0, ids, upd)
            no_sync = True
        except RuntimeError:
            no_sync = False
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    return ms, same_bits, as_kernel, no_sync


def phase_accumulate_times(cases):
    """CUDA-event times of accumulate_rows at the trainers' shapes, on the
    inputs ``phase_accumulate`` checked: the wrapper (one kernel), the plain
    version, ``index_add_`` (one library call, atomics) and ``index_add_``
    in PyTorch's deterministic mode, timed in turn, beside the bound; and
    the kernel's own device time per launch, which ``phase_accumulate``
    took from the profiler's events (None where it kept none). The
    bound counts what the function must move: the ids (8 bytes each) and
    the updates read once, each touched table row read and written once;
    its B * d additions are far below the float32 peak."""
    import torch

    from cornac_tpu_torch.ops.accumulate import accumulate_rows, accumulate_rows_torch

    rows = {}
    for label, (table, ids, upd, per_call, device_ms, kept, err, card_err) in cases.items():
        (R, d), B = table.shape, ids.shape[0]
        reps = 200 if B < 1_000_000 else 10
        plain_ms = time_ms(lambda: accumulate_rows_torch(table, ids, upd), reps)
        ms = time_ms(lambda: accumulate_rows(table, ids, upd), reps)
        library_ms = time_ms(lambda: table.index_add_(0, ids, upd), reps)
        # deterministic index_add_ sorts: 0.6-0.7 s a call at 10M ids
        det_ms, det_bits, det_as_kernel, det_no_sync = deterministic_index_add(
            table, ids, upd, reps if B < 1_000_000 else 3)
        # the profiler again, after the run's long profiles: it has been seen
        # to keep fewer of a short kernel's events late in the process
        late = profile_call(lambda: [accumulate_rows(table, ids, upd) for _ in range(20)])[2]
        touched = torch.unique(ids).numel()
        nbytes = 8.0 * B + 4.0 * B * d + 8.0 * touched * d
        flops = float(B * d)
        bound_ms = 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)
        bound_by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
        rows[label] = dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                           deterministic_library_ms=det_ms, deterministic_same_bits=det_bits,
                           deterministic_bits_as_kernel=det_as_kernel,
                           deterministic_no_sync=det_no_sync, launches_per_call=per_call,
                           bound_ms=bound_ms, bound_by=bound_by, shape=f"{B} ids into {R} x {d}",
                           max_abs_err=err, card_plain_max_abs_err=card_err)
        as_kernel = "the kernel's bits" if det_as_kernel else "not the kernel's bits"
        log(f"  times accumulate_rows, {label}: {B} ids into {R} rows x {d} ({touched} touched): "
            f"kernel {ms:.4f} ms (device "
            + ("not measured" if device_ms is None else
               f"{device_ms:.4f} ms, mean of the {20 * kept:g} events the profiler kept of 20 "
               f"calls in phase 5; it keeps {late} of 20 here")
            + f"; {per_call:g} launch per call), plain {plain_ms:.4f} ms, "
            f"index_add_ {library_ms:.4f} ms, deterministic index_add_ {det_ms:.4f} ms (two "
            f"launches {'bit-identical' if det_bits else 'DIFFER'}, "
            f"{as_kernel}; "
            f"{'runs' if det_no_sync else 'does NOT run'} without a sync); bound "
            f"{bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.3f} MB), "
            f"{100 * bound_ms / ms:.2f}% of bound")
    return rows


# the families at the bench shape run in processes of their own, at once,
# after the timed phases: their eager steps are bound by the host, one core
# each
NEURAL_GROUPS = (("GMF", "MLP"), ("NeuMF", "LightGCN", "NGCF"), ("VAECF", "RecVAE", "BiVAECF"))
FAMILY_TIMEOUT = 900  # seconds a family's process may take


@functools.lru_cache(maxsize=1)
def _bench_data():
    return make_ml100k_like()


def run_captured(phase, *args):
    """In a spawned process: the phase function ``phase`` of this script
    on ``make_ml100k_like(7)`` and ``args``, its log captured. Returns
    (log, result); a failure raises with the log and the traceback."""
    import io
    import traceback

    sys.path.insert(0, str(ROOT))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            result = globals()[phase](_bench_data, *args)
    except Exception:
        raise RuntimeError(f"{phase}{args} failed:\n{out.getvalue()}{traceback.format_exc()}"
                           ) from None
    return out.getvalue(), result


def build_all():
    """Build every kernel library at once: one nvcc per source, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from cornac_tpu_torch.ops.accumulate import ACCUMULATE_ROWS
    from cornac_tpu_torch.ops.canary import CANARY
    from cornac_tpu_torch.ops.cosine_topk import COSINE_TOPK
    from cornac_tpu_torch.ops.fused_topk import FUSED_TOPK

    libs = [FUSED_TOPK.library, COSINE_TOPK.library, ACCUMULATE_ROWS.library, CANARY.library]
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
    canary_err = phase_canary(gen)
    if args.quick:
        log(f"quick run done in {time.perf_counter() - t_start:.1f} s")
        return

    def lap(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what}: done")

    lap("device, build and kernel-vs-plain phases")
    probe_launches, _ = phase_probe()
    lap("on-silicon probe")
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    # bench.py's generator is pure Python (about 15 s): a second process
    # makes the data while the serving slice runs. The factor and neural
    # families at the bench shape run last, in four processes of their own
    # at once (their logs printed when each ends), after every phase this
    # process times: the card time-slices between processes and they share
    # the host's cores, so a time taken beside them would carry their load
    # (their own times carry each other's)
    pool = multiprocessing.get_context("spawn").Pool(2 + len(NEURAL_GROUPS))
    try:
        bench_data = pool.apply_async(make_ml100k_like)
        launches, bpr, users = phase_slice(args.seed, work)
        lap("BPR serving slice")
        knn_launches, W_items, W_users = phase_knn_ml1m(args.seed, work)
        lap("KNN slice")
        ml10m_launches, W10, train10m = phase_knn_ml10m(args.seed)
        lap("related items")
        lgcn_launches, lgcn = phase_lightgcn_ml10m(train10m, gen)
        lap("LightGCN edge form at ML-10M")
        hpf_launches, hpf_fused, hpf_model, hpf_users, hpf = phase_hpf_ml10m(train10m, args.seed)
        del train10m
        lap("HPF at ML-10M")
        bench_launches, bench = phase_trainer_bench(bench_data.get)
        lap("trainers at the bench shape")
        full_launches, full_fused, full = phase_trainer_full(args.seed)
        lap("trainer at full width")
        t = time.perf_counter()
        netflix = netflix_dataset()
        log(f"  {WMF_PAIRS:,} seeded pairs at the Netflix widths (set-up, host clock): "
            f"{time.perf_counter() - t:.3f} s")
        wmf_fused, wmf = phase_wmf_full(args.seed, netflix)
        lap("WMF at the Netflix widths")
        vaecf = phase_vaecf_full(netflix, args.seed)
        del netflix
        lap("VAECF at the Netflix widths")
        rows = phase_times(bpr, users)
        hpf_rows = phase_times(hpf_model, hpf_users, (SERVE_BATCH,), "HPF at ML-10M")
        cos_rows = phase_cosine_times([
            ("ML-1M item side", W_items),
            ("ML-1M user side", W_users),
            ("half dense, ML-1M item widths", star_weights(3706, 6040, 0.5, "integer", gen)),
            ("ML-10M item side", W10),
        ])
        acc_rows = phase_accumulate_times(acc_cases)
        canary_row = phase_canary_times()
        lap("times")
        families = [("factor family", pool.apply_async(run_captured, ("phase_factor_bench",)))]
        families += [(f"neural family ({', '.join(names)})",
                      pool.apply_async(run_captured, ("phase_neural_bench", names)))
                     for names in NEURAL_GROUPS]
        families.append(("factor family's rest and the protocols",
                         pool.apply_async(run_captured, ("phase_factor_rest_bench",))))
        done = []
        for what, job in families:
            text, result = job.get(timeout=FAMILY_TIMEOUT)
            log(text.rstrip())
            lap(f"{what} at the bench shape, in its own process")
            done.append(result)
    finally:
        pool.terminate()
        pool.join()
    factor_launches, factor_fused, factor_fit, factor_acc_err = done[0]
    neural = done[1:1 + len(NEURAL_GROUPS)]
    neural_launches = sum(r[0] for r in neural)
    neural_fused = sum(r[1] for r in neural)
    neural_fit = {name: sec for r in neural for name, sec in r[2].items()}
    neural_acc_err = max(r[3] for r in neural)
    neural_prof = next(r[4] for r in neural if r[4] is not None)
    rest_launches, rest_fused, rest_fit, rest_acc_err, proto = done[-1]
    kernels = [{
        "name": "fused_topk",
        "batch": B,
        "slices": row["slices"],
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/fused_topk.cu",
        "replaces": "cornac_tpu/ops/pallas_ranking.py:38",
        "launches": (launches + full_fused + factor_fused + neural_fused + wmf_fused
                     + hpf_fused + rest_fused + probe_launches["fused_topk"]),
        "max_abs_err": max_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
    } for B, row in sorted(rows.items(), reverse=True)]
    # B1 at HPF's d = 5 over the ML-10M catalog, on the trained vectors
    hpf_row = hpf_rows[SERVE_BATCH]
    kernels.append({**{k: v for k, v in kernels[0].items() if k not in ("batch", "slices")},
                    "batch": SERVE_BATCH, "d": hpf_row["d"], "items": hpf_row["items"],
                    "slices": hpf_row["slices"],
                    **{k: hpf_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                               "library_ms")}})
    cos = cos_rows["ML-10M item side"]
    kernels.append({
        "name": "cosine_topk",
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/cosine_topk.cu",
        "replaces": "cornac_tpu/ops/pallas_similarity.py:43",
        "launches": knn_launches + ml10m_launches + probe_launches["cosine_topk"],
        "max_abs_err": cos_err,
        "ms": cos["ms"],
        "plain_ms": cos["plain_ms"],
        "bound_ms": cos["bound_ms"],
        "bound_by": cos["bound_by"],
        "library_ms": cos["library_ms"],
        "dense_bound_ms": cos["dense_bound_ms"],
        "sparse_library_ms": cos["sparse_library_ms"],
    })
    # accumulate_rows at the BPR trainer's full-width V update (the row
    # earlier runs report) and at LightGCN's edge form at the ML-10M widths,
    # each with its own max |kernel - plain| (the plain version on the CPU,
    # whose bits the kernel must give, and on the card, atomic); the largest
    # |kernel - plain on the CPU| over every check of every path besides
    acc_all_err = max(acc_err, factor_acc_err, neural_acc_err, lgcn["max_abs_err"],
                      hpf["max_abs_err"], rest_acc_err)
    for label in ("full width, V update (positives + negatives)",
                  "LightGCN edge form, ML-10M, into user rows",
                  "LightGCN edge form, ML-10M, into item rows",
                  "HPF, ML-10M, into user rows",
                  "HPF, ML-10M, into item rows"):
        acc = acc_rows[label]
        kernels.append({
            "name": "accumulate_rows",
            "shape": acc["shape"],
            "route": "cuda",
            "source": "cornac_tpu_torch/csrc/accumulate_rows.cu",
            "replaces": "cornac_tpu/ops/accumulate.py:26",
            "launches": (bench_launches + full_launches + factor_launches + neural_launches
                         + lgcn_launches + hpf_launches + rest_launches),
            "max_abs_err": acc["max_abs_err"],
            "card_plain_max_abs_err": acc["card_plain_max_abs_err"],
            "max_abs_err_all_paths": acc_all_err,
            "ms": acc["ms"],
            "device_ms": acc["device_ms"],
            "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"],
            "bound_by": acc["bound_by"],
            "library_ms": acc["library_ms"],
            "deterministic_library_ms": acc["deterministic_library_ms"],
            "launches_per_call": acc["launches_per_call"],
        })
    kernels.append({
        "name": "canary",
        "shape": [128, 128],
        "route": "cuda",
        "source": "cornac_tpu_torch/csrc/canary.cu",
        "replaces": "benchmarks/pallas_on_silicon.py:74",
        "launches": probe_launches["canary"],
        "max_abs_err": canary_err,
        **canary_row,
    })
    log("factor family, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in factor_fit.items()))
    log("factor family's rest, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in rest_fit.items()))
    log("the protocols, host clock: " + ", ".join(
        f"{name} {sec:.3f} s" for name, sec in proto["seconds"].items()))
    log(f"HPF at ML-10M: {hpf['sweep_s'] * 1e3:.3f} ms per sweep, "
        f"{100 * hpf['bound_s'] / hpf['sweep_s']:.3f}% of the byte bound, busy "
        + ("not measured" if hpf["share"] is None else f"{100 * hpf['share']:.2f}%")
        + f", peak {hpf['peak'] / 2**30:.3f} GiB")
    log(f"WMF at the Netflix widths: {wmf['sweep_s'][0]:.4f} / {wmf['sweep_s'][1]:.4f} s per "
        f"sweep, {100 * wmf['bound_s'] / min(wmf['sweep_s']):.2f}% of the FLOP bound, peak "
        f"{wmf['peak_fit'] / 2**30:.3f} GiB")
    log("neural family, fit seconds (host clock): " + ", ".join(
        f"{name} {sec:.3f}" for name, sec in neural_fit.items())
        + f"; NeuMF epoch busy {100 * neural_prof['share']:.2f}%")
    log(f"LightGCN edge form at ML-10M: one step forward and backward {lgcn['ms']:.3f} ms "
        f"(plain {lgcn['plain_ms']:.3f}, cuSPARSE {lgcn['library_ms']:.3f}, bound "
        f"{lgcn['bound_ms']:.4f} ms); 3 layers {lgcn['layers_ms']:.3f} ms")
    log(f"VAECF at the Netflix widths: {vaecf['epoch_s']:.3f} s per steady epoch, "
        f"{100 * vaecf['bound_s'] / vaecf['epoch_s']:.2f}% of the {vaecf['bound_s']:.4f} s FP32 "
        f"bound, peak {vaecf['peak'] / 2**30:.3f} GiB above what the run held")
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
