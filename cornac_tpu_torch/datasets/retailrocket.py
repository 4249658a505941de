"""RetailRocket sessions (train/val/test).

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/retailrocket.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_train(fmt="USIT", reader=None):
    """Load the train split."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/retailrocket/train.zip",
        unzip=True,
        relative_path="retailrocket/train.csv",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep=",")


def load_val(fmt="USIT", reader=None):
    """Load the val split."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/retailrocket/val.zip",
        unzip=True,
        relative_path="retailrocket/val.csv",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep=",")


def load_test(fmt="USIT", reader=None):
    """Load the test split."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/retailrocket/test.zip",
        unzip=True,
        relative_path="retailrocket/test.csv",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep=",")
