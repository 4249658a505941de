"""Diginetica sessions (train/val/test; session- or user-based).

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/diginetica.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


def _load(name, fmt, reader):
    fpath = cache(
        url=f"https://static.preferred.ai/cornac/datasets/diginetica/{name}.zip",
        unzip=True,
        relative_path=f"diginetica/{name}.csv",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt=fmt, sep=",")


def load_train(fmt="USIT", reader=None):
    """Load the training sessions."""
    return _load("train", fmt, reader)


def load_val(fmt="USIT", reader=None, mode="session-based"):
    """Load the validation sessions ('session-based' or 'user-based')."""
    name = "val" if mode == "session-based" else "val_user_based"
    return _load(name, fmt, reader)


def load_test(fmt="USIT", reader=None, mode="session-based"):
    """Load the test sessions ('session-based' or 'user-based')."""
    name = "test" if mode == "session-based" else "test_user_based"
    return _load(name, fmt, reader)
