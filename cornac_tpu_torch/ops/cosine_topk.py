"""Fused all-pairs co-support cosine similarity + exact top-k neighbours.

Port of ``cornac_tpu/ops/pallas_similarity.py::cosine_topk``. For a tensor
on the card the hand-written kernel ``csrc/cosine_topk.cu`` walks the
nonzeros of W: for each row it accumulates the co-support sums over the
columns it shares with every other row, in shared memory, and folds the
similarities into a running top-k, so neither the (n, n) similarity
matrix nor any dense product is formed. The kernel reads two compressed
views of W (``SparseViews``: CSR and CSC), built on the device as layout
preparation, from a dense W (``cosine_topk``) or from a scipy matrix's
entries (``cosine_topk_sparse``, what the KNN models use, so that no
dense (n, m) W is built). For tensors on the CPU the plain version
``cosine_topk_torch`` runs instead; on the card only the tests and
``chip_smoke.py`` call it, as the reference the kernel is held to.

All return (similarities (n, k) float32, row indices (n, k) int32), best
first, equal similarities ordered by ascending index (as ``jax.lax.top_k``
orders them), with ``k`` capped at ``n - 1`` with ``exclude_self`` and at
``n`` without, exactly as the JAX function does. The support is
``float32(W) != 0``, what the JAX kernel's ``[W != 0]`` means.
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from scipy.sparse import csr_matrix

from ..device import default_device, resolve_device
from .dispatch import full_f32, resolve_path
from .native import CudaLibrary

NEG_INF = -3.0e38
WARPS = 8  # kWarps in csrc/cosine_topk.cu: warps of a block, each owning a span of rows


def _sqrt_f32(x):
    """Correctly rounded float32 square root on every device: PyTorch's
    vectorised CPU ``sqrt`` is off by one ulp on some inputs (sqrt(66.75)),
    where the card, the CUDA kernel and the JAX package round exactly; the
    root of a float32 taken in float64 and rounded once is exact."""
    return torch.sqrt(x.double()).float()


def co_support_cosine(wr, W, B=None, W2=None):
    """(len(wr), n) co-support cosine of the rows ``wr`` against every row
    of ``W``: ``num / max(sqrt(d1) * sqrt(d2), 1e-12)``, 0 where ``num`` is
    0. ``B = [W != 0]`` and ``W2 = W * W`` may be passed in when the caller
    reuses them across row blocks."""
    B = (W != 0).to(W.dtype) if B is None else B
    W2 = W * W if W2 is None else W2
    br = (wr != 0).to(wr.dtype)
    with full_f32():
        num = wr @ W.T
        d1 = (wr * wr) @ B.T  # ||w_r||^2 over the columns c also rated
        d2 = br @ W2.T  # ||w_c||^2 over the columns r also rated
    denom = _sqrt_f32(d1) * _sqrt_f32(d2)
    return torch.where(num != 0, num / torch.clamp_min(denom, 1e-12), 0.0)


class SparseViews(NamedTuple):
    """W (n, m) as its CSR (``row_ptr``, ``col_idx``, ``row_val``) and its
    CSC (``col_ptr``, ``row_idx``, ``col_val``): int32 indices ascending
    within each row and column, float32 values, no zeros."""

    shape: tuple
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    row_val: torch.Tensor
    col_ptr: torch.Tensor
    row_idx: torch.Tensor
    col_val: torch.Tensor

    def dense(self):
        """The (n, m) float32 W on the views' device."""
        n, m = self.shape
        W = torch.zeros((n, m), dtype=torch.float32, device=self.row_val.device)
        rows = torch.repeat_interleave(
            torch.arange(n, device=W.device), torch.diff(self.row_ptr.long()))
        W[rows, self.col_idx.long()] = self.row_val
        return W


def views_from_entries(rows, cols, vals, shape):
    """``SparseViews`` of the (n, m) matrix with the entries ``vals`` at
    (``rows``, ``cols``): tensors on one device, (row, col) pairs distinct,
    in any order; values are cast to float32 and those that are then 0
    dropped."""
    n, m = (int(x) for x in shape)
    if max(n, m) >= 2**31 - 1 or rows.numel() >= 2**31:
        raise ValueError("the kernel takes n, m and the entry count as 32-bit ints")
    vals = vals.to(torch.float32)
    keep = vals != 0
    rows, cols, vals = rows[keep].long(), cols[keep].long(), vals[keep]

    def compress(major, minor, n_major, n_minor):
        order = torch.argsort(major * n_minor + minor)
        ptr = torch.zeros(n_major + 1, dtype=torch.int64, device=vals.device)
        ptr[1:] = torch.cumsum(torch.bincount(major, minlength=n_major), 0)
        return ptr.int(), minor[order].int(), vals[order]

    return SparseViews((n, m), *compress(rows, cols, n, m), *compress(cols, rows, m, n))


def dense_views(W):
    """``SparseViews`` of a dense float32 tensor W."""
    rows, cols = W.nonzero(as_tuple=True)
    return views_from_entries(rows, cols, W[rows, cols], W.shape)


def scipy_views(mat, device):
    """``SparseViews`` on ``device`` of a scipy sparse matrix: duplicates
    summed in its own dtype, then cast to float32 and zeros dropped, as
    ``np.asarray(mat.todense(), np.float32)`` would hold them. A CSR matrix
    in canonical form (what the KNN models hold) goes to the device as it
    is; any other is made so on the host first."""
    csr = csr_matrix(mat)
    if not csr.has_canonical_format:
        csr = csr.copy()
        csr.sum_duplicates()
    n = csr.shape[0]
    indptr = torch.as_tensor(csr.indptr.astype(np.int64), device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device), torch.diff(indptr))
    return views_from_entries(
        rows,
        torch.as_tensor(csr.indices.astype(np.int64), device=device),
        torch.as_tensor(csr.data.astype(np.float32), device=device),
        csr.shape,
    )


def partition(views, C):
    """How the kernel's warps share the candidate rows: ``(bounds, split)``.

    The n rows fall into ``ceil(n / C)`` ranges of at most C rows (one
    pass of shared memory each), and each range into ``WARPS`` spans of
    consecutive rows, one per warp, cut so that the spans carry about equal
    work: a row c takes part in ``sum_{j in supp(c)} c_j`` pair updates
    over all rows' walks (c_j the count of column j). ``bounds`` (int32,
    ranges * WARPS + 1): range q is rows ``bounds[q*WARPS]`` up to
    ``bounds[(q+1)*WARPS]``, its warp w's span starts at
    ``bounds[q*WARPS + w]``. ``split`` (int32, m x len(bounds)): ``split[j,
    t]`` is the index of column j's first CSC entry whose row is at or
    past ``bounds[t]``, so a warp finds its share of a column in two
    loads."""
    n, m = views.shape
    dev = views.row_val.device
    ranges = max(1, -(-n // C))
    col_count = torch.diff(views.col_ptr.long())
    nnz = views.row_val.numel()  # given, so that repeat_interleave need not wait for the device
    row_of = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(views.row_ptr.long()), output_size=nnz)
    work = torch.zeros(n, dtype=torch.float64, device=dev)
    work.index_add_(0, row_of, col_count[views.col_idx.long()].double())
    # range q: rows q*n//ranges up to (q+1)*n//ranges; inside it, cut where
    # the running work passes each w/WARPS of the range's total
    starts = torch.arange(ranges + 1, device=dev) * n // ranges
    cum = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev), torch.cumsum(work, 0)])
    lo, hi = cum[starts[:-1]], cum[starts[1:]]
    frac = torch.arange(WARPS, dtype=torch.float64, device=dev) / WARPS
    targets = lo[:, None] + (hi - lo)[:, None] * frac[None, :]
    cuts = torch.searchsorted(cum[1:], targets.reshape(-1), right=True).reshape(ranges, WARPS)
    cuts = torch.minimum(torch.maximum(cuts, starts[:-1, None]), starts[1:, None])
    cuts[:, 0] = starts[:-1]
    bounds = torch.cat([cuts.reshape(-1), starts[-1:]])
    keys = (torch.repeat_interleave(torch.arange(m, device=dev), col_count, output_size=nnz) * n
            + views.row_idx.long())
    queries = torch.arange(m, device=dev)[:, None] * n + bounds[None, :]
    split = torch.searchsorted(keys, queries.reshape(-1)).reshape(m, len(bounds))
    return bounds.int(), split.int().contiguous()


class CosineTopkKernel:
    """ctypes binding of ``cornac_cosine_topk``; ``launches`` counts the
    kernel launches, and nothing else adds to it."""

    def __init__(self):
        self.library = CudaLibrary("cosine_topk")
        self.launches = 0
        self._plans = {}
        self._bound = None

    def plan(self, n, device):
        """(rows a range holds, persistent blocks) for n rows on the CUDA
        ``device``, asked of the CUDA runtime once per pair."""
        device = torch.device(device)
        key = (torch.cuda.current_device() if device.index is None else device.index, n)
        if key not in self._plans:
            fn = self.library.load().cornac_cosine_topk_plan
            fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
            fn.restype = ctypes.c_int
            C, blocks = ctypes.c_int(), ctypes.c_int()
            self.library.check(fn(key[0], n, ctypes.byref(C), ctypes.byref(blocks)))
            self._plans[key] = (C.value, blocks.value)
        return self._plans[key]

    def _fn(self):
        if self._bound is None:
            fn = self.library.load().cornac_cosine_topk
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
            self._bound = fn
        return self._bound

    def __call__(self, views, k, exclude_self=True):
        """Launch on the current stream. ``views``: ``SparseViews`` on a
        CUDA device; 1 <= k <= n - 1 with ``exclude_self``, else k <= n."""
        if not isinstance(views, SparseViews):
            raise ValueError("the kernel takes SparseViews (dense_views, scipy_views)")
        n, m = views.shape
        dev = views.row_val.device
        for name, t, dtype, size in (
            ("row_ptr", views.row_ptr, torch.int32, n + 1),
            ("col_idx", views.col_idx, torch.int32, None),
            ("row_val", views.row_val, torch.float32, None),
            ("col_ptr", views.col_ptr, torch.int32, m + 1),
            ("row_idx", views.row_idx, torch.int32, None),
            ("col_val", views.col_val, torch.float32, None),
        ):
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{name} must be a CUDA tensor on the views' device")
            if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous 1-d {dtype} tensor")
            if size is not None and t.numel() != size:
                raise ValueError(f"{name} has {t.numel()} entries, want {size}")
        if not (views.col_idx.numel() == views.row_val.numel() == views.row_idx.numel()
                == views.col_val.numel()):
            raise ValueError("the CSR and CSC views hold different entry counts")
        cap = n - 1 if exclude_self else n
        if not 1 <= k <= cap:
            raise ValueError(f"k={k} must lie in [1, {cap}]")
        if n * k >= 2**31:
            raise ValueError("the kernel takes n*k as a 32-bit int")
        C, blocks = self.plan(n, dev)
        bounds, split = partition(views, C)
        sims = torch.empty((n, k), dtype=torch.float32, device=dev)
        ids = torch.empty((n, k), dtype=torch.int32, device=dev)
        scratch = torch.empty((blocks, WARPS + 1, 2, k), dtype=torch.int64, device=dev)
        next_row = torch.zeros(1, dtype=torch.int32, device=dev)
        # the C side launches on this device and restores the caller's
        index = dev.index
        err = self._fn()(
            index, views.row_ptr.data_ptr(), views.col_idx.data_ptr(), views.row_val.data_ptr(),
            split.data_ptr(), views.row_idx.data_ptr(), views.col_val.data_ptr(),
            bounds.data_ptr(), n, (len(bounds) - 1) // WARPS, C, k, int(bool(exclude_self)),
            blocks, sims.data_ptr(), ids.data_ptr(), scratch.data_ptr(), next_row.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index),
        )
        if err:
            self.library.check(err)
        self.launches += 1
        return sims, ids


COSINE_TOPK = CosineTopkKernel()


def all_pairs_cosine(W, exclude_self=True):
    """The full (n, n) co-support cosine of the rows of W in float32 (TF32
    off), the diagonal set to -3e38 with ``exclude_self``: what the kernel
    ranks."""
    sim = co_support_cosine(W, W)
    if exclude_self:
        sim.fill_diagonal_(NEG_INF)
    return sim


def cosine_topk_torch(W, k, exclude_self=True):
    """Plain version: ``all_pairs_cosine``, then a stable descending sort
    (smaller index first among equal similarities) and the first ``k``
    columns."""
    s, i = torch.sort(all_pairs_cosine(W, exclude_self), dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32)


def _capped(n, k, exclude_self):
    return int(max(0, min(k, n - 1 if exclude_self else n)))


def _empty(n, device):  # nothing to rank: the JAX function returns (n, 0) too
    return (torch.empty((n, 0), dtype=torch.float32, device=device),
            torch.empty((n, 0), dtype=torch.int32, device=device))


def cosine_topk(W, k, exclude_self=True, force=None):
    """Top-k most similar rows per row of ``W`` under co-support cosine.

    W: (n, m) dense weights (user-item or item-user); a tensor stays on its
    device, numpy goes to the default device. k: neighbours per row,
    capped at ``n - 1`` with ``exclude_self`` (default True), else at n.
    ``force``: None (the kernel on the card, the plain version on the
    CPU), ``"kernel"`` or ``"torch"``.

    Returns (similarities (n, k) float32, row indices (n, k) int32).
    """
    device = W.device if isinstance(W, torch.Tensor) else default_device()
    W = torch.as_tensor(W, dtype=torch.float32, device=device).contiguous()
    n = W.shape[0]
    k = _capped(n, k, exclude_self)
    path = resolve_path(force, device)
    if k == 0:
        return _empty(n, device)
    if path == "torch":
        return cosine_topk_torch(W, k, exclude_self)
    return COSINE_TOPK(dense_views(W), k, exclude_self)


def cosine_topk_sparse(mat, k, exclude_self=True, force=None, device=None):
    """``cosine_topk`` of a scipy sparse matrix, on ``device`` (default:
    the card), without building the dense W for the kernel: its views come
    from the matrix's entries (``scipy_views``). The plain version
    densifies them and runs ``cosine_topk_torch``."""
    dev = resolve_device(device)
    n = mat.shape[0]
    k = _capped(n, k, exclude_self)
    path = resolve_path(force, dev)
    if k == 0:
        return _empty(n, dev)
    views = scipy_views(mat, dev)
    if path == "torch":
        return cosine_topk_torch(views.dense(), k, exclude_self)
    return COSINE_TOPK(views, k, exclude_self)
