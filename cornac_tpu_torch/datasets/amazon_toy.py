"""Amazon Toys & Games: ratings + aspect sentiment.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/amazon_toy.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_feedback(fmt="UIR", reader=None):
    """Load (user, item, rating) triplets."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_toy/rating.zip",
        unzip=True,
        relative_path="amazon_toy/rating.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep=",")


def load_sentiment(reader=None):
    """Load (user, item, [(aspect, opinion, polarity)]) tuples."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_toy/sentiment.zip",
        unzip=True,
        relative_path="amazon_toy/sentiment.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UITup", sep=",", tup_sep=":")
