"""Epinions ratings + trust network.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/epinions.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_feedback(reader=None):
    """Load (user, item, rating) triplets ."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/epinions/ratings_data.zip",
        unzip=True,
        relative_path="epinions/ratings_data.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UIR", sep=" ")


def load_trust(reader=None):
    """Load the user trust network as UIR triplets ."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/epinions/trust_data.zip",
        unzip=True,
        relative_path="epinions/trust_data.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UIR", sep=" ")
