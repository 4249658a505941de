"""Fused all-pairs co-support cosine similarity + exact top-k neighbours.

Port of ``cornac_tpu/ops/pallas_similarity.py::cosine_topk``. For a tensor
on the card the hand-written kernel ``csrc/cosine_topk.cu`` computes each
tile of similarities and folds it into a running top-k, so the (n, n)
similarity matrix is never written to device memory. For a tensor on the
CPU the plain version ``cosine_topk_torch`` runs instead; on the card only
the tests and ``chip_smoke.py`` call it, as the reference the kernel is
held to.

Both return (similarities (n, k) float32, row indices (n, k) int32), best
first, equal similarities ordered by ascending index (as ``jax.lax.top_k``
orders them), with ``k`` capped at ``n - 1`` with ``exclude_self`` and at
``n`` without, exactly as the JAX function does.
"""

import ctypes

import torch

from ..device import default_device
from .dispatch import full_f32, resolve_path
from .native import CudaLibrary, check_tensor

NEG_INF = -3.0e38


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


class CosineTopkKernel:
    """ctypes binding of ``cornac_cosine_topk``; ``launches`` counts the
    kernel launches, and nothing else adds to it."""

    def __init__(self):
        self.library = CudaLibrary("cosine_topk")
        self.launches = 0

    def _fn(self):
        lib = self.library.load()
        fn = lib.cornac_cosine_topk
        fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, W, k, exclude_self=True):
        """Launch on the current stream. W (n, m): float32, contiguous, on a
        CUDA device; 1 <= k <= n - 1 with ``exclude_self``, else k <= n."""
        n, m = check_tensor(W, "W", 2)
        cap = n - 1 if exclude_self else n
        if not 1 <= k <= cap:
            raise ValueError(f"k={k} must lie in [1, {cap}]")
        if max(n, m, 2 * n * k) >= 2**31:
            raise ValueError("the kernel takes n, m and n*k as 32-bit ints")
        sims = torch.empty((n, k), dtype=torch.float32, device=W.device)
        ids = torch.empty((n, k), dtype=torch.int32, device=W.device)
        scratch = torch.empty((2, n, k), dtype=torch.int64, device=W.device)
        fn = self._fn()
        with torch.cuda.device(W.device):  # the C side launches on the current device
            err = fn(
                W.data_ptr(), n, m, k, int(bool(exclude_self)),
                sims.data_ptr(), ids.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(W.device).cuda_stream,
            )
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
    k = int(max(0, min(k, n - 1 if exclude_self else n)))
    path = resolve_path(force, device)
    if k == 0:  # nothing to rank: the JAX function returns (n, 0) too
        return (torch.empty((n, 0), dtype=torch.float32, device=device),
                torch.empty((n, 0), dtype=torch.int32, device=device))
    if path == "torch":
        return cosine_topk_torch(W, k, exclude_self)
    return COSINE_TOPK(W, k, exclude_self)
