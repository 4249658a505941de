"""CiteULike-a: article bookmarking feedback + article texts.

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/citeulike.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache

import csv


def load_feedback(reader=None):
    """Load implicit (user, item, 1.0) feedback."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/citeulike/users.zip",
        unzip=True,
        relative_path="citeulike/users.dat",
    )
    reader = Reader() if reader is None else reader
    return reader.read(fpath, fmt="UI", sep=" ", id_inline=True)


def load_text():
    """Load article texts (title + abstract): returns (texts, item_ids)."""
    fpath = cache(
        url="https://static.preferred.ai/cornac/datasets/citeulike/text.zip",
        unzip=True,
        relative_path="citeulike/raw-data.csv",
    )
    texts, ids = [], []
    with open(fpath, encoding="utf-8", errors="ignore") as f:
        next(f)  # header
        for row in csv.reader(f):
            ids.append(row[0])
            texts.append(row[3] + ". " + row[4])
    return texts, ids
