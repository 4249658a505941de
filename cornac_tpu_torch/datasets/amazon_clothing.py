"""Amazon Clothing: ratings, text, visual features, context graph.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/amazon_clothing.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache

import numpy as np

from ..data.reader import read_text


def load_feedback(reader=None):
    """Load (user, item, rating) triplets ."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_clothing/rating.zip",
        unzip=True,
        relative_path="amazon_clothing/rating.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UIR", sep="\t")


def load_graph(reader=None):
    """Load the item context graph ."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_clothing/context.zip",
        unzip=True,
        relative_path="amazon_clothing/context.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UI", sep="\t")


def load_text():
    """Load item texts: returns (texts, item_ids)."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_clothing/text.zip",
        unzip=True,
        relative_path="amazon_clothing/text.txt",
    )
    return read_text(fpath, sep="::")


def load_visual_feature():
    """Load CNN visual features: returns (features, item_ids)."""
    features = np.load(
        cache(
            url="https://static.preferred.ai/cornac/datasets/amazon_clothing/image.zip",
            unzip=True,
            relative_path="amazon_clothing/image_features.npy",
        )
    )
    item_ids = read_text(
        cache(
            url="https://static.preferred.ai/cornac/datasets/amazon_clothing/item_ids.zip",
            unzip=True,
            relative_path="amazon_clothing/item_ids.txt",
        )
    )
    return features, item_ids
