"""Gowalla check-in sessions.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/gowalla.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def load_checkins(fmt="USITJson", reader=None):
    """Load check-in sessions."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/gowalla/check-ins.zip",
        unzip=True,
        relative_path="gowalla/check-ins.txt",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep="\t")
