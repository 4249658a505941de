"""Device-side CSR value lookup.

Port of ``cornac_tpu/ops/csr_lookup.py``: for a batch of (row, column)
queries, whether each pair is a stored entry of a CSR matrix, its stored
value (0 when absent) and its nnz position (0 when absent). MTER and
Companion read a pair's rating with it (the BPR pair-order reversal on
co-rated items); LRPPM and Companion chain a position into a second lookup
keyed by that position.

The JAX package searches each query's row with a fixed number of
branchless binary-search steps, because JAX runs without 64-bit integers
there. PyTorch has them: the port keeps one sorted int64 key an entry,
``row * n_cols + column`` (the CSR order, rows then sorted columns, is the
keys' order), and finds every query's key with one ``torch.searchsorted``,
a few launches a batch instead of some ten a search step. The lower bound
of a stored pair is its nnz position, so found flags, values and positions
equal the JAX package's, entry for entry; nothing waits for the host.
"""

import numpy as np
import torch

from ..device import resolve_device


class CsrLookup:
    """The sorted int64 keys and float32 values of a CSR matrix's entries
    on one device, with batched ``query`` and ``query_position``."""

    def __init__(self, keys, data, n_cols):
        self.keys = keys
        self.data = data
        self.n_cols = n_cols

    @classmethod
    def build(cls, csr_matrix, device=None):
        """The lookup of a scipy CSR matrix on ``device`` (default: the
        card); its rows' indices are sorted first where they are not."""
        if not csr_matrix.has_sorted_indices:
            csr_matrix = csr_matrix.sorted_indices()
        dev = resolve_device(device)
        n_rows, n_cols = csr_matrix.shape
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(csr_matrix.indptr))
        keys = rows * n_cols + np.asarray(csr_matrix.indices, dtype=np.int64)
        return cls(torch.as_tensor(keys, device=dev),
                   torch.as_tensor(np.asarray(csr_matrix.data, dtype=np.float32), device=dev),
                   int(n_cols))

    def query_position(self, rows, cols):
        """(found bool, value float32 (0 when absent), nnz position int64
        (0 when absent)) of each (row, column) pair."""
        cols = cols.long()
        keys = rows.long() * self.n_cols + cols
        pos = torch.searchsorted(self.keys, keys)
        safe = torch.clamp(pos, max=max(self.keys.shape[0] - 1, 0))
        # a column past the matrix's (Companion's overall-rating aspect) would
        # alias the next row's first columns: it is absent
        found = (pos < self.keys.shape[0]) & (self.keys[safe] == keys) & (cols < self.n_cols)
        found &= cols >= 0
        zero = torch.zeros((), dtype=self.data.dtype, device=self.data.device)
        return (found, torch.where(found, self.data[safe], zero),
                torch.where(found, safe, torch.zeros_like(safe)))

    def query(self, rows, cols):
        """(found bool, value float32; 0 when absent) of each pair."""
        found, value, _ = self.query_position(rows, cols)
        return found, value
