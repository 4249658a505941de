"""Ta Feng grocery baskets.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/tafeng.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_basket(fmt="UBITJson", reader=None):
    """Load basket data."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/tafeng/basket.zip",
        unzip=True,
        relative_path="tafeng/basket.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep="\t")
