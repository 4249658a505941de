"""Tradesy: implicit feedback + visual features.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/tradesy.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache

import numpy as np

from ..data.reader import read_text


def load_feedback(reader=None):
    """Load implicit (user, item, 1.0) feedback."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/tradesy/users.zip",
        unzip=True,
        relative_path="tradesy/users.csv",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UI", sep=",")


def load_visual_feature():
    """Load CNN visual features: returns (features, item_ids)."""
    features = np.load(
        cache(
            url="https://static.preferred.ai/cornac/datasets/tradesy/item_features.zip",
            unzip=True,
            relative_path="tradesy/item_features.npy",
        )
    )
    item_ids = read_text(
        cache(
            url="https://static.preferred.ai/cornac/datasets/tradesy/item_ids.zip",
            unzip=True,
            relative_path="tradesy/item_ids.txt",
        )
    )
    return features, item_ids
