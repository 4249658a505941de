"""Deterministic grouped row accumulation: ``table[ids] += updates``.

Port of ``cornac_tpu/ops/accumulate.py::accumulate_rows``, the scatter step
of every SGD trainer. Its contract is determinism: the same inputs give the
same bits. On the card ``index_add_`` sums float updates with atomics, in an
order that changes from run to run, and ``torch.unique_consecutive`` would
cost a sync with the host on every step. So for a tensor on the card the
batch's ids go through a stable ``torch.sort`` and the hand-written kernel
``csrc/accumulate_rows.cu`` sums each run of equal ids in batch order, in one
warp, and adds the sum to its table row once. For a tensor on the CPU the
plain version ``accumulate_rows_torch`` does the same arithmetic with a
stable sort and ``index_add_``, which is sequential there; on the card only
the tests and ``chip_smoke.py`` call it, as the reference the kernel is held
to.

Unlike the JAX function, which returns a new array, both update ``table``
in place and return it: the trainers own their tables, and the copy would
double the bytes of every step.
"""

import ctypes

import torch

from .dispatch import resolve_path
from .native import CudaLibrary, check_tensor


class AccumulateRowsKernel:
    """ctypes binding of ``cornac_accumulate_rows``; ``launches`` counts the
    calls that launch it, and nothing else adds to it."""

    def __init__(self):
        self.library = CudaLibrary("accumulate_rows")
        self.launches = 0
        self._fn = None

    def __call__(self, table, ids_sorted, order, updates):
        """Launch on the current stream. table (R, d) and updates (B, d):
        float32, contiguous; ids_sorted (B,) int32 sorted by a stable sort
        and order (B,) int64, its permutation; all on one CUDA device. Ids
        outside [0, R) are dropped. Updates ``table`` in place."""
        R, d = check_tensor(table, "table", 2)
        B, d_u = check_tensor(updates, "updates", 2)
        if d_u != d:
            raise ValueError(f"table has {d} columns but updates have {d_u}")
        for t, name, dtype in ((ids_sorted, "ids_sorted", torch.int32), (order, "order", torch.int64)):
            if t.dtype != dtype or t.shape != (B,) or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous ({B},) {dtype} tensor")
        for t in (updates, ids_sorted, order):
            if t.device != table.device:
                raise ValueError("table, ids and updates must be on the same device")
        if self._fn is None:
            fn = self.library.load().cornac_accumulate_rows
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(table.device):  # the C side launches on the current device
            err = self._fn(
                table.data_ptr(), updates.data_ptr(), ids_sorted.data_ptr(), order.data_ptr(),
                B, R, d, torch.cuda.current_stream(table.device).cuda_stream,
            )
        self.library.check(err)
        self.launches += 1
        return table


ACCUMULATE_ROWS = AccumulateRowsKernel()


def accumulate_rows_torch(table, ids, updates):
    """Plain version: a stable sort of ``ids``, one sum per run of equal ids
    in batch order (``index_add_`` into zeros), then one add per table row.
    On the CPU ``index_add_`` is sequential, so these are the kernel's sums;
    on the card it is not, and the result agrees only to float32 rounding."""
    ids_sorted, order = torch.sort(ids, stable=True)
    rows, run = torch.unique_consecutive(ids_sorted, return_inverse=True)
    sums = updates.new_zeros((rows.shape[0],) + updates.shape[1:])
    sums.index_add_(0, run, updates[order])
    return table.index_add_(0, rows, sums)


def accumulate_rows(table, ids, updates, force=None):
    """Sum ``updates`` into rows ``ids`` of ``table``, in place, and return
    ``table``.

    ``table``: (R, ...) float32; ``ids``: (B,) integer, in [0, R);
    ``updates``: (B, ...) with the table's trailing dimensions. Deterministic
    on either device. ``force``: None (the kernel on the card, the plain
    version on the CPU), ``"kernel"`` or ``"torch"``.
    """
    if resolve_path(force, table.device) == "torch":
        return accumulate_rows_torch(table, ids, updates)
    if table.shape[0] >= 2**31:
        raise ValueError("the kernel sorts row ids as 32-bit ints")
    if ids.shape[0] == 0:
        return table
    ids_sorted, order = torch.sort(ids.to(torch.int32), stable=True)
    ACCUMULATE_ROWS(table.view(table.shape[0], -1), ids_sorted, order,
                    updates.reshape(updates.shape[0], -1).contiguous())
    return table
