"""MovieLens datasets (100K/1M/10M/20M) + movie plots.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/movielens.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache

from collections import namedtuple

from ..data.reader import read_text

VALID_DATA_FORMATS = ["UIR", "UIRT"]

MovieLens = namedtuple("MovieLens", ["url", "unzip", "path", "sep", "skip"])
ML_DATASETS = {
    "100K": MovieLens(
        "https://files.grouplens.org/datasets/movielens/ml-100k/u.data",
        False, "ml-100k/u.data", "\t", 0,
    ),
    "1M": MovieLens(
        "https://files.grouplens.org/datasets/movielens/ml-1m.zip",
        True, "ml-1m/ratings.dat", "::", 0,
    ),
    "10M": MovieLens(
        "https://files.grouplens.org/datasets/movielens/ml-10m.zip",
        True, "ml-10M100K/ratings.dat", "::", 0,
    ),
    "20M": MovieLens(
        "https://files.grouplens.org/datasets/movielens/ml-20m.zip",
        True, "ml-20m/ratings.csv", ",", 1,
    ),
}


def load_feedback(fmt="UIR", variant="100K", reader=None):
    """Load user-item ratings of a MovieLens variant (100K/1M/10M/20M)."""
    fmt = validate_format(fmt, VALID_DATA_FORMATS)
    ml = ML_DATASETS.get(variant.upper(), None)
    if ml is None:
        raise ValueError("variant must be one of {}.".format(list(ML_DATASETS)))
    fpath = cache(url=ml.url, unzip=ml.unzip, relative_path=ml.path)
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt, sep=ml.sep, skip_lines=ml.skip)


def load_plot():
    """Load movie plots: returns (texts, movie_ids)."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/movielens/ml_plot.zip",
        unzip=True,
        relative_path="movielens/ml_plot.dat",
    )
    return read_text(fpath, sep="::")
