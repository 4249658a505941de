"""Fused full-catalog scoring + exact top-k.

Port of ``cornac_tpu/ops/pallas_ranking.py::fused_topk``. For a tensor on
the card the hand-written kernel ``csrc/fused_topk.cu`` scores each chunk
of the catalog and folds it into a running top-k, so the (B, N) score
matrix is never written to device memory. For a tensor on the CPU the
plain version ``fused_topk_torch`` runs instead; on the card only the tests
and ``chip_smoke.py`` call it, as the reference the kernel is held to.

Both return (scores (B, k) float32, item indices (B, k) int32), best
first, equal scores ordered by ascending item index, with ``k`` capped at
the catalog size, exactly as the JAX function does.
"""

import ctypes

import torch

from ..device import default_device
from .dispatch import full_f32, resolve_path
from .native import CudaLibrary, check_tensor


class FusedTopkKernel:
    """ctypes binding of ``cornac_fused_topk``; ``launches`` counts the
    kernel launches, and nothing else adds to it."""

    def __init__(self):
        self.library = CudaLibrary("fused_topk")
        self.launches = 0

    def _fn(self):
        lib = self.library.load()
        fn = lib.cornac_fused_topk
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        return fn

    def __call__(self, U, V, k, bias=None):
        """Launch on the current stream. U (B, d), V (N, d), bias (N,) or
        None: float32, contiguous, on one CUDA device; 1 <= k <= N."""
        B, d = check_tensor(U, "U", 2)
        N, d_v = check_tensor(V, "V", 2)
        if d_v != d:
            raise ValueError(f"U has {d} features but V has {d_v}")
        if bias is not None and check_tensor(bias, "bias", 1)[0] != N:
            raise ValueError(f"bias has {bias.shape[0]} entries for {N} items")
        for t in (V, bias):
            if t is not None and t.device != U.device:
                raise ValueError("U, V and bias must be on the same device")
        if not 1 <= k <= N:
            raise ValueError(f"k={k} must lie in [1, {N}]")
        if max(B * d, N * d, 2 * B * k) >= 2**31:
            raise ValueError("the kernel indexes rows with 32-bit ints")
        scores = torch.empty((B, k), dtype=torch.float32, device=U.device)
        items = torch.empty((B, k), dtype=torch.int32, device=U.device)
        scratch = torch.empty((2, B, k), dtype=torch.int64, device=U.device)
        if B == 0:
            return scores, items
        fn = self._fn()
        with torch.cuda.device(U.device):  # the C side launches on the current device
            err = fn(
                U.data_ptr(), V.data_ptr(), 0 if bias is None else bias.data_ptr(),
                B, N, d, k, scores.data_ptr(), items.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(U.device).cuda_stream,
            )
        self.library.check(err)
        self.launches += 1
        return scores, items


FUSED_TOPK = FusedTopkKernel()


def fused_topk_torch(U, V, k, bias=None):
    """Plain version: full float32 product, bias, stable descending sort
    (smaller item index first among equal scores), first ``k`` columns."""
    with full_f32():
        scores = U @ V.T
    if bias is not None:
        scores = scores + bias
    s, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32)


def fused_topk(U, V, k, bias=None, force=None, precision="f32",
               recall_target=None, partitions=None):
    """Top-k items per user by dot-product score (+ optional item bias).

    U: (B, d) user vectors. V: (N, d) item vectors. k: int, capped at N.
    bias: optional (N,) item bias. Tensors stay on their device; numpy
    inputs go to the default device. ``force``: None (the kernel on the
    card, the plain version on the CPU), ``"kernel"`` or ``"torch"``.

    ``precision="bf16"``, ``recall_target`` and ``partitions`` select the
    JAX package's XLA-only variants, which the port does not have yet:
    they raise rather than answer with the exact path.
    """
    if precision != "f32" or recall_target is not None or partitions is not None:
        raise NotImplementedError(
            "fused_topk's bf16, recall_target and partitions variants are not "
            "ported yet (ROADMAP.md); only the exact f32 path exists"
        )
    device = U.device if isinstance(U, torch.Tensor) else default_device()
    U = torch.as_tensor(U, dtype=torch.float32, device=device).contiguous()
    V = torch.as_tensor(V, dtype=torch.float32, device=device).contiguous()
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32, device=device).contiguous()
    k = int(min(k, V.shape[0]))
    if resolve_path(force, device) == "torch":
        return fused_topk_torch(U, V, k, bias)
    return FUSED_TOPK(U, V, k, bias)
