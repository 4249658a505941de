"""Netflix Prize data (small / original variants).

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/netflix.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache


VARIANTS = {"small": "data_small", "original": "data"}


def load_feedback(fmt="UIR", variant="original", reader=None):
    """Load Netflix ratings ('small' subset or 'original')."""
    fmt = validate_format(fmt, ["UIR", "UIRT"])
    fname = VARIANTS.get(variant.lower())
    if fname is None:
        raise ValueError("variant must be one of {}.".format(list(VARIANTS)))
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/netflix/{}.zip".format(fname),
        unzip=True,
        relative_path="netflix/{}.csv".format(fname),
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt, sep=",")
