"""Deterministic grouped row accumulation: ``table[ids] += updates``.

Port of ``cornac_tpu/ops/accumulate.py::accumulate_rows``, the scatter step
of every SGD trainer. Its contract is determinism: the same inputs give the
same bits. On the card ``index_add_`` sums float updates with atomics, in an
order that changes from run to run, and ``torch.unique_consecutive`` would
cost a sync with the host on every step. So for a tensor on the card the
hand-written kernel ``csrc/accumulate_rows.cu`` runs, in one launch on the
ids as the caller holds them: each block owns a range of table rows, picks
the batch's updates of those rows in batch order and sums them in shared
memory, then adds each touched row's sum to the table once
(``accumulate_plan`` sizes the blocks). For a tensor on the CPU the plain
version ``accumulate_rows_torch`` does the same arithmetic with a stable
sort and ``index_add_``, which is sequential there; on the card only the
tests and ``chip_smoke.py`` call it, as the reference the kernel is held to.

Unlike the JAX function, which returns a new array, both update ``table``
in place and return it: the trainers own their tables, and the copy would
double the bytes of every step.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from .dispatch import resolve_path
from .native import CudaLibrary

THREADS = 512  # kThreads in csrc/accumulate_rows.cu
WARPS = THREADS // 32
MAX_PER_LANE = 8  # kMaxPerLane: ids a lane takes per round
RING = 2  # kRing: rounds of ids in shared memory
MAX_COLS = 64  # kMaxCols: columns a block owns
MAX_INDEX = 65535  # kMaxIndex: rows a block owns; staged entries stay below it
# kFixedBytes: the ids' ring, the warps' counts and windows of 4 x 32
# entries, and 64 floats of room past the stage
FIXED_BYTES = 8 * RING * THREADS * MAX_PER_LANE + 4 * (2 * WARPS + WARPS * 32 * 4) + 4 * 64

AccumulatePlan = namedtuple("AccumulatePlan", "rows cols per_lane cap grid smem")
AccumulatePlan.__doc__ = """A launch of the kernel: each block owns ``rows`` table rows
and ``cols`` columns, its lanes load ``per_lane`` ids a round, it stages up
to ``cap`` updates before it sums them; ``grid`` is (row blocks, column
blocks) and ``smem`` the dynamic shared memory of a block in bytes."""


def smem_bytes(rows, cols, cap):
    """Shared memory of a block (``smem_bytes`` in the kernel): the fixed
    part, the sums, the stage (cap rows and a row of zeros) and its
    entries' rows, the warps' lists of touched rows (2 bytes a row) and a
    touched flag a row."""
    return (4 * (rows * cols + (cap + 1) * cols + cap) + FIXED_BYTES
            + 2 * WARPS * -(-rows // WARPS) + rows)


@functools.lru_cache(maxsize=256)
def accumulate_plan(R, B, d, sms, smem_limit):
    """The launch for ``B`` ids into an (R, d) table on a card of ``sms``
    SMs whose blocks may use ``smem_limit`` bytes of shared memory.

    Columns: one block column up to ``MAX_COLS``, else as few as cover d, of
    equal width. Rows: every block reads all B ids again (``grid * B * 8``
    bytes from L2), so the grid is as small as fills the SMs once, and
    larger only where a block's shared memory cannot hold its rows' sums
    beside the ids' ring and a stage of 256 updates (or of the whole batch,
    when that is smaller). Whatever shared memory the rows leave stages
    more updates, up to the whole batch, so that fewer blocks stop the scan
    to sum. It depends on shapes alone, so planning never waits for the
    card."""
    if R < 1 or d < 1:
        raise ValueError(f"no rows to plan for: R={R}, d={d}")
    grid_cols = -(-d // MAX_COLS)
    cols = -(-d // grid_cols)
    per_lane = max(1, min(MAX_PER_LANE, -(-B // THREADS)))
    entry = 4 * (cols + 1)  # a staged update row and its local row
    least_cap = max(32, min(B, 256))
    max_rows = min(MAX_INDEX, (smem_limit - FIXED_BYTES - 2 * WARPS - 4 * cols
                               - least_cap * entry) // (4 * cols + 3))
    if max_rows < 1:
        raise ValueError(f"{smem_limit} bytes of shared memory cannot hold a block's rows")
    row_blocks = max(-(-R // max_rows), min(R, -(-sms // grid_cols)))
    rows = -(-R // row_blocks)
    row_blocks = -(-R // rows)
    cap = (smem_limit - smem_bytes(rows, cols, 0)) // entry
    cap = max(1, min(cap, MAX_INDEX - 1, B))
    return AccumulatePlan(rows, cols, per_lane, cap, (row_blocks, grid_cols),
                          smem_bytes(rows, cols, cap))


class AccumulateRowsKernel:
    """ctypes binding of ``cornac_accumulate_rows``; ``launches`` counts the
    calls that launch it, and nothing else adds to it."""

    def __init__(self):
        self.library = CudaLibrary("accumulate_rows")
        self.launches = 0
        self._fn = None
        self._limits = {}

    def limits(self, device):
        """(SMs, shared memory a block may opt into) of ``device``, asked of
        the CUDA runtime once per device (which also lets the kernel use
        that much there)."""
        index = device.index if isinstance(device, torch.device) else device
        if index is None:
            index = torch.cuda.current_device()
        if index not in self._limits:
            fn = self.library.load().cornac_accumulate_rows_limits
            fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
            fn.restype = ctypes.c_int
            sms, smem = ctypes.c_int(), ctypes.c_int()
            self.library.check(fn(index, ctypes.byref(sms), ctypes.byref(smem)))
            self._limits[index] = (sms.value, smem.value)
        return self._limits[index]

    def plan(self, R, B, d, device):
        """The ``accumulate_plan`` of a launch for B ids into (R, d) on
        ``device``."""
        return accumulate_plan(R, B, d, *self.limits(device))

    def __call__(self, table, ids, updates):
        """Launch on the current stream. table (R, ...) and updates (B, ...)
        with the same trailing dimensions: float32, contiguous; ids (B,)
        int64, any stride; all on one CUDA device. Ids outside [0, R) are
        dropped. Updates ``table`` in place. Kept short: the trainers call
        it twice a minibatch, and on their shapes the host's time per call
        is of the kernel's order."""
        index = table.get_device()
        if (index < 0 or table.dtype != torch.float32 or updates.dtype != torch.float32
                or table.dim() < 1 or not table.is_contiguous() or not updates.is_contiguous()):
            raise ValueError("table and updates must be contiguous float32 CUDA tensors")
        if not isinstance(ids, torch.Tensor) or ids.dtype != torch.int64 or ids.dim() != 1:
            raise ValueError("ids must be a 1-D int64 tensor")
        B, R = ids.shape[0], table.shape[0]
        if updates.shape[0] != B or updates.shape[1:] != table.shape[1:]:
            raise ValueError(f"updates {tuple(updates.shape)} do not match {B} ids into a table "
                             f"{tuple(table.shape)}")
        if updates.get_device() != index or ids.get_device() != index:
            raise ValueError("table, ids and updates must be on the same device")
        if B >= 2**31:
            raise ValueError("the kernel lists batch positions as 32-bit ints")
        if B == 0 or table.numel() == 0:
            return table
        d = table.numel() // R
        plan = accumulate_plan(R, B, d, *self.limits(index))
        if self._fn is None:
            fn = self.library.load().cornac_accumulate_rows
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                           + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        # the C side launches on this device and restores the caller's
        err = self._fn(index, table.data_ptr(), updates.data_ptr(), ids.data_ptr(), ids.stride(0),
                       B, R, d, plan.rows, plan.cols, plan.per_lane, plan.cap,
                       torch._C._cuda_getCurrentRawStream(index))
        if err:
            self.library.check(err)
        self.launches += 1
        return table


ACCUMULATE_ROWS = AccumulateRowsKernel()


def ids_in_table(table, ids, updates):
    """The ids in [0, R) of ``table`` and their updates: the ones the
    kernel sums, the others being dropped (and refused by ``index_add_``)."""
    inside = (ids >= 0) & (ids < table.shape[0])
    if bool(inside.all()):
        return ids, updates
    return ids[inside], updates[inside]


def accumulate_rows_torch(table, ids, updates):
    """Plain version: a stable sort of ``ids``, one sum per run of equal ids
    in batch order (``index_add_`` into zeros), then one add per table row.
    On the CPU ``index_add_`` is sequential, so these are the kernel's sums;
    on the card it is not, and the result agrees only to float32 rounding.
    Ids outside [0, R) are dropped, as the kernel drops them (on the card,
    where it is only the kernel's reference, that check waits for it)."""
    ids, updates = ids_in_table(table, ids, updates)
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
    if force is None and table.is_cuda:
        path = "kernel"  # the trainers' call, decided without building a device
    else:
        path = resolve_path(force, table.device)
    if path == "torch":
        return accumulate_rows_torch(table, ids, updates)
    if ids.dtype != torch.int64:
        ids = ids.to(torch.int64)
    if not updates.is_contiguous():
        updates = updates.contiguous()
    return ACCUMULATE_ROWS(table, ids, updates)


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose gradient is a scatter-add through
    ``accumulate_rows``: duplicate ids sum in batch order, the same bits on
    every run (autograd's own backward of a gather is atomic on the card)."""

    @staticmethod
    def forward(ctx, table, ids, grad_ids):
        ctx.save_for_backward(ids if grad_ids is None else grad_ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        table_grad = grad.new_zeros(ctx.table_shape)
        return accumulate_rows(table_grad, ids, grad.contiguous()), None, None


def gather_rows(table, ids, grad_ids=None):
    """``table[ids]`` for the trainers' autodiff losses: ids (B,) int64 into
    the first dimension of a float32 table; the gradient with respect to
    ``table`` is summed deterministically (``accumulate_rows``).
    ``grad_ids`` (B,), when given, are the rows the gradient goes to
    instead: a caller whose gathered rows have an exactly zero gradient may
    send them outside [0, R), where ``accumulate_rows`` drops them."""
    return _GatherRows.apply(table, ids, grad_ids)
