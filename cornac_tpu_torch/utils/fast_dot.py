"""In-place vector-matrix-rows dot accumulation: a copy of
``cornac_tpu/utils/fast_dot.py`` (host numpy), ``output[i] += vec . mat[i]``
for every row ``i`` in one GEMV, for code written against Cornac's
``fast_dot``."""

import numpy as np


def fast_dot(vec, mat, output):
    """Accumulate ``mat @ vec`` into ``output`` in place.

    Parameters mirror the reference: ``vec`` (d,), ``mat`` (n, d),
    ``output`` (n,) — all float32 or float64, ``output`` is modified
    in place and nothing is returned.
    """
    vec = np.asarray(vec)
    mat = np.asarray(mat)
    output += mat.dot(vec).astype(output.dtype, copy=False)
