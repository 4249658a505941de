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


def normal(shape=None, mean=0.0, std=1.0, random_state=None, dtype=np.float32):
    return get_rng(random_state).normal(mean, std, shape).astype(dtype)


def gamma(shape=None, shape_param=1.0, scale_param=1.0, random_state=None, dtype=np.float32):
    return get_rng(random_state).gamma(shape_param, scale_param, shape).astype(dtype)


def xavier_uniform(shape, random_state=None, dtype=np.float32):
    """Glorot & Bengio (2010) uniform initializer."""
    assert len(shape) == 2  # fan-in/fan-out requires a matrix
    std = np.sqrt(2.0 / np.sum(shape))
    limit = np.sqrt(3.0) * std
    return uniform(shape, -limit, limit, random_state, dtype)
