"""Seeded parameter initializers (host-side numpy), as in
``cornac_tpu/utils/init_utils.py``: initial factors come from numpy's
``RandomState``, so a seed gives the same draws in both packages. The other
initializers come with the models that use them.
"""

import numpy as np

from .common import get_rng


def zeros(shape, dtype=np.float32):
    return np.zeros(shape, dtype=dtype)


def uniform(shape=None, low=0.0, high=1.0, random_state=None, dtype=np.float32):
    return get_rng(random_state).uniform(low, high, shape).astype(dtype)
