"""Amazon Digital Music: ratings + reviews.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/amazon_digital_music.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_feedback(reader=None):
    """Load (user, item, rating) triplets ."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_digital_music/rating.zip",
        unzip=True,
        relative_path="amazon_digital_music/rating.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UIR", sep=",")


def load_review(reader=None):
    """Load (user, item, review) triplets ."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/amazon_digital_music/review.zip",
        unzip=True,
        relative_path="amazon_digital_music/review.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UIReview", sep="\t")
