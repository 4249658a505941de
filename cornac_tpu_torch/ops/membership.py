"""Device-side membership tests over sparse interaction sets.

Port of ``cornac_tpu/ops/membership.py``: whether each (user, item) query
pair is a stored entry, answered on the device for a whole batch with no
sync with the host, so that the BPR trainer can reject observed negatives
inside its epoch. Two structures, chosen at build time by
``build_membership``:

- **bitmap**: one bit per (user, item) cell in 32-bit words, each user's row
  padded to whole words; one gather and a bit test per query. Kept while it
  fits the JAX package's 64 MB budget.
- **binary search** over the CSR rows: branchless, with a fixed number of
  steps (``search_steps``, from the largest row), at any scale. A build that
  the JAX package would make a b+tree (a TPU row-gather layout) uses it too.

Both answer exactly, as the JAX package's three structures do.
"""

import math

import numpy as np
import torch

from ..device import resolve_device

_BITMAP_MAX_BYTES = 64 * 1024 * 1024


class Membership:
    """A membership structure on one device with a batched ``query``.

    ``kind`` is ``"bitmap"`` (``arrays``: the int32 words) or ``"csr"``
    (``arrays``: int64 row pointers and the int32 column indices with one
    sentinel past the end)."""

    def __init__(self, kind, arrays, num_items, search_steps=0):
        self.kind = kind
        self.arrays = arrays
        self.num_items = num_items
        self.search_steps = search_steps

    @property
    def words_per_row(self):
        return (self.num_items + 31) // 32

    def query(self, users, items):
        """(n,) bool tensor: whether each (user, item) pair is stored.
        ``users`` and ``items``: (n,) integer tensors on the structure's
        device, users in [0, num_users)."""
        users, items = users.long(), items.long()
        if self.kind == "bitmap":
            (words,) = self.arrays
            word = words[users * self.words_per_row + (items >> 5)]
            return ((word >> (items & 31)) & 1) != 0

        indptr, indices = self.arrays
        # lower bound of `items` in each user's sorted row: it lies in
        # [base, base + span], and every step halves span, rounding up, so
        # it ends at 1 (0 for an empty row, whose base is its end and stays
        # not found); the sentinel keeps every probe in bounds
        base = indptr[users]
        row_end = indptr[users + 1]
        span = row_end - base
        for _ in range(self.search_steps):
            half = span >> 1
            base = base + half * (indices[base + half] < items)
            span = span - half
        base = base + (indices[base] < items)
        return (base < row_end) & (indices[base] == items)


def build_membership(csr_matrix, bitmap_max_bytes=None, btree_max_degree=None, device=None):
    """Membership structure for a scipy CSR matrix on ``device`` (default:
    the card). The bitmap while it fits ``bitmap_max_bytes`` (default 64
    MB), else the CSR binary search. ``btree_max_degree`` is the JAX
    package's b+tree cap; the port has no b+tree and accepts it for the
    signature's sake."""
    del btree_max_degree
    dev = resolve_device(device)
    if bitmap_max_bytes is None:
        bitmap_max_bytes = _BITMAP_MAX_BYTES
    n_users, n_items = csr_matrix.shape
    wpr = (n_items + 31) // 32
    n_words = n_users * wpr
    if n_words * 4 <= bitmap_max_bytes:
        words = np.zeros(n_words, dtype=np.uint32)
        rows = np.repeat(np.arange(n_users, dtype=np.int64), np.diff(csr_matrix.indptr))
        cols = np.asarray(csr_matrix.indices, dtype=np.int64)
        np.bitwise_or.at(words, rows * wpr + (cols >> 5),
                         np.uint32(1) << (cols & 31).astype(np.uint32))
        return Membership("bitmap", (torch.as_tensor(words.view(np.int32), device=dev),), n_items)

    if not csr_matrix.has_sorted_indices:
        csr_matrix = csr_matrix.sorted_indices()
    max_degree = int(np.diff(csr_matrix.indptr).max(initial=0))
    steps = max(1, math.ceil(math.log2(max_degree + 1)) + 1)
    # a sentinel past the last entry: probes of empty rows stay in bounds
    indices = np.append(np.asarray(csr_matrix.indices, dtype=np.int32), np.int32(2**31 - 1))
    return Membership(
        "csr",
        (torch.as_tensor(np.asarray(csr_matrix.indptr, dtype=np.int64), device=dev),
         torch.as_tensor(indices, device=dev)),
        n_items,
        search_steps=steps,
    )
