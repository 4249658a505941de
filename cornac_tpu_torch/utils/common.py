"""Common small utilities (host-side, numpy).

Capability parity with reference ``cornac/utils/common.py:29-241``. These are
host-side helpers used by the data layer and models; device-side math lives in
``cornac_tpu_torch.ops``.
"""

import numbers

import numpy as np
import scipy.sparse as sp

FLOAT_DTYPES = (np.float64, np.float32, np.float16)


def sigmoid(x):
    """Numerically-stable sigmoid on host arrays."""
    return 1.0 / (1.0 + np.exp(-x))


def scale(values, target_min, target_max, source_min=None, source_max=None):
    """Affinely map ``values`` from [source_min, source_max] to
    [target_min, target_max] (reference ``common.py:34-69``)."""
    lo = np.min(values) if source_min is None else source_min
    hi = np.max(values) if source_max is None else source_max
    if lo == hi:
        lo = 0.0  # degenerate source range: treat values as already in [0, hi]
    unit = (values - lo) / (hi - lo)
    return unit * (target_max - target_min) + target_min


def clip(values, lower_bound, upper_bound):
    """Clip values into [lower_bound, upper_bound]."""
    return np.minimum(np.maximum(values, lower_bound), upper_bound)


def intersects(x, y, assume_unique=False):
    """Elements of ``x`` that are also in ``y``."""
    return x[np.isin(x, y, assume_unique=assume_unique)]


def excepts(x, y, assume_unique=False):
    """Elements of ``x`` that are not in ``y``."""
    return x[np.isin(x, y, assume_unique=assume_unique, invert=True)]


def safe_indexing(X, indices):
    """Subset rows/items of array-likes or plain lists by integer indices."""
    if not hasattr(X, "shape"):
        return [X[idx] for idx in indices]
    int_typed = getattr(indices, "dtype", None) is not None and indices.dtype.kind == "i"
    if int_typed and hasattr(X, "take"):
        return X.take(indices, axis=0)
    return X[indices]


def validate_format(input_format, valid_formats):
    """Raise ValueError when ``input_format`` is not supported."""
    if input_format not in valid_formats:
        raise ValueError(
            f"unsupported data format {input_format!r}; expected one of {valid_formats}"
        )
    return input_format


def estimate_batches(input_size, batch_size):
    """Number of batches needed to cover ``input_size``."""
    return int(np.ceil(input_size / batch_size))


def get_rng(seed):
    """Return a numpy RandomState for a seed / pass-through RandomState.

    Kept as ``np.random.RandomState`` (legacy generator) so split permutations
    and sampling sequences are reproducible in the same way users of the
    reference expect (reference ``common.py:161-173``).
    """
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, (numbers.Integral, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(
        "{} can not be used to create a numpy.random.RandomState".format(seed)
    )


def _inplace_csr_row_normalize(X, norm):
    """Vectorized in-place CSR row normalization (no Cython needed;
    replaces reference ``utils/fast_sparse_funcs.pyx:30-80``)."""
    if norm == "l1":
        norms = np.abs(X.data)
    else:
        norms = X.data**2
    row_sums = np.add.reduceat(norms, X.indptr[:-1][np.diff(X.indptr) > 0])
    # expand per-row sums back onto data
    full_sums = np.zeros(X.shape[0], dtype=np.float64)
    nz_rows = np.diff(X.indptr) > 0
    full_sums[nz_rows] = row_sums
    if norm == "l2":
        full_sums = np.sqrt(full_sums)
    scale_per_entry = np.repeat(full_sums, np.diff(X.indptr))
    mask = scale_per_entry != 0
    X.data[mask] /= scale_per_entry[mask]


def inplace_csr_row_normalize_l1(X):
    _inplace_csr_row_normalize(X, "l1")


def inplace_csr_row_normalize_l2(X):
    _inplace_csr_row_normalize(X, "l2")


def normalize(X, norm="l2", axis=1, copy=True):
    """Scale vectors individually to unit norm; dense or CSR sparse input."""
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"unsupported norm {norm!r}; expected l1, l2, or max")
    if len(X.shape) != 2:
        raise ValueError(f"normalize expects a 2D input, got shape {X.shape}")

    out = X.copy() if copy else X
    if out.dtype not in FLOAT_DTYPES:
        out = out.astype(np.float64)
    if axis == 0:
        out = out.T  # normalize columns by normalizing rows of the transpose

    if sp.issparse(out):
        out = out.tocsr()
        if norm == "max":
            per_row = out.max(axis=1).toarray()
            denom = per_row.repeat(np.diff(out.indptr))
            nonzero = denom != 0
            out.data[nonzero] /= denom[nonzero]
        else:
            _inplace_csr_row_normalize(out, norm)
    else:
        row_norm = {
            "l1": lambda m: np.abs(m).sum(axis=1),
            "l2": lambda m: np.sqrt((m**2).sum(axis=1)),
            "max": lambda m: np.max(m, axis=1),
        }[norm](out)
        row_norm[row_norm == 0] = 1.0
        out /= row_norm.reshape(-1, 1)

    return out.T if axis == 0 else out
