"""Fused full-catalog scoring + exact top-k.

Port of ``cornac_tpu/ops/pallas_ranking.py::fused_topk``. For a tensor on
the card the hand-written kernel ``csrc/fused_topk.cu`` scores each chunk
of the catalog and folds it into a running top-k, so the (B, N) score
matrix is never written to device memory. The catalog is split into
``S`` slices scored by separate blocks and merged by a second kernel
(``split_plan`` picks ``S`` so that the grid fills the card; ``S = 1``,
no merge, at large batches). For a tensor on the CPU the
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

CHUNK = 512  # items per chunk of the kernel (kChunk in csrc/fused_topk.cu)
ROWS = 16  # user rows per block (kRows)


def split_plan(B, N, k, sms, per_sm):
    """How many catalog slices S the kernel scores in separate blocks for
    B users, N items and top-k on a card of ``sms`` SMs that each hold
    ``per_sm`` blocks of it at once. Slice s is made of chunks ``s*C//S``
    up to ``(s+1)*C//S`` of the ``C = ceil(N / CHUNK)`` chunks.

    S is the most slices whose grid, ``ceil(B / ROWS) * S`` blocks, still
    runs in one wave of ``per_sm * sms`` (S = 1 when the row blocks alone
    fill the card), with at most one slice per chunk and ``N // k``
    slices, so that the merge never takes more candidates per row (S * k)
    than the catalog has. A slice may still hold fewer than k items: the
    kernel pads each slice's list with empty keys, so the lists are
    count-aware."""
    row_blocks = -(-B // ROWS)
    chunks = -(-N // CHUNK)
    return max(1, min(per_sm * sms // row_blocks, chunks, N // k))


class FusedTopkKernel:
    """ctypes binding of ``cornac_fused_topk``; ``launches`` counts the
    calls that launch it (one call, whether it runs one kernel or the
    scoring kernel and the merge), and nothing else adds to it."""

    def __init__(self):
        self.library = CudaLibrary("fused_topk")
        self.launches = 0
        self._fn = None
        self._slots = {}

    def slots(self, device, k):
        """(SMs, blocks of the scoring kernel per SM) on ``device`` for
        this k, asked of the CUDA runtime once per pair."""
        key = (torch.cuda.current_device() if device.index is None else device.index, k)
        if key not in self._slots:
            fn = self.library.load().cornac_fused_topk_blocks_per_sm
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            per_sm = ctypes.c_int()
            self.library.check(fn(key[0], k, ctypes.byref(per_sm)))
            sms = torch.cuda.get_device_properties(device).multi_processor_count
            self._slots[key] = (sms, per_sm.value)
        return self._slots[key]

    def plan(self, U, N, k):
        """The number of catalog slices a launch for U (B, d) uses."""
        return split_plan(max(U.shape[0], 1), N, k, *self.slots(U.device, k))

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
        S = self.plan(U, N, k)
        if max(B * d, N * d, 2 * S * B * k) >= 2**31:
            raise ValueError("the kernel indexes rows with 32-bit ints")
        scores = torch.empty((B, k), dtype=torch.float32, device=U.device)
        items = torch.empty((B, k), dtype=torch.int32, device=U.device)
        if B == 0:
            return scores, items
        scratch = torch.empty((2, B, S, k), dtype=torch.int64, device=U.device)
        if self._fn is None:
            fn = self.library.load().cornac_fused_topk
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
            self._fn = fn
        # the C side launches on this device and restores the caller's
        index = U.get_device()
        err = self._fn(
            index, U.data_ptr(), V.data_ptr(), 0 if bias is None else bias.data_ptr(),
            B, N, d, k, S, scores.data_ptr(), items.data_ptr(),
            scratch.data_ptr(), torch._C._cuda_getCurrentRawStream(index),
        )
        if err:
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

    ``partitions``: the JAX package's exact two-stage selection (top-k in
    each of P catalog blocks, then over the P*k survivors), whose answer
    equals the one-stage answer. The port accepts any P and gives that
    same exact answer: the kernel splits the catalog itself, into as many
    slices as fill the card (``split_plan``), whatever P asks for.

    ``recall_target``: the JAX package's approximate mode
    (``jax.lax.approx_max_k``), a float in (0, 1]. The port answers it with
    the exact selection: recall 1.0, which meets every target, and the same
    ties to the smaller index. It is checked before ``precision``, as the
    JAX function checks it, so its scores are float32 products even when
    ``precision="bf16"``.

    ``precision="bf16"``: bf16 operands, float32 accumulation, as the JAX
    package's XLA variant computes them. U and V are rounded to bfloat16
    (round to nearest even) and back to float32 on their device, and the
    exact path runs on the rounded operands with the bias in float32: the
    product of two bf16 values is exact in float32, so only the order of the
    sums differs from JAX's, and the tie rule is the exact path's.
    """
    if recall_target is not None and not 0.0 < float(recall_target) <= 1.0:
        raise ValueError(f"recall_target must lie in (0, 1], got {recall_target}")
    if precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be 'f32' or 'bf16', got {precision!r}")
    device = U.device if isinstance(U, torch.Tensor) else default_device()
    U = torch.as_tensor(U, dtype=torch.float32, device=device).contiguous()
    V = torch.as_tensor(V, dtype=torch.float32, device=device).contiguous()
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=torch.float32, device=device).contiguous()
    if U.dim() != 2 or V.dim() != 2 or U.shape[1] != V.shape[1]:
        raise ValueError(f"U {tuple(U.shape)} and V {tuple(V.shape)} must be (B, d) and (N, d)")
    k = int(min(k, V.shape[0]))
    if precision == "bf16" and recall_target is None:
        U, V = (t.to(torch.bfloat16).to(torch.float32) for t in (U, V))
    if resolve_path(force, device) == "torch":
        return fused_topk_torch(U, V, k, bias)
    return FUSED_TOPK(U, V, k, bias)
