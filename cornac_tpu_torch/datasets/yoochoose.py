"""YooChoose click/buy sessions (RecSys'15 challenge).

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/yoochoose.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_buy(fmt="SITJson", reader=None):
    """Load the buy split."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/yoochoose/buy.zip",
        unzip=True,
        relative_path="yoochoose/buy.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep="\t")


def load_click(fmt="SITJson", reader=None):
    """Load the click split."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/yoochoose/click.zip",
        unzip=True,
        relative_path="yoochoose/click.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep="\t")


def load_test(fmt="SITJson", reader=None):
    """Load the test split."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/yoochoose/test.zip",
        unzip=True,
        relative_path="yoochoose/test.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep="\t")
