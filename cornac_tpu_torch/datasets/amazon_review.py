"""Amazon review corpora (by category; McAuley et al.).

Cached-file loaders, ported from the JAX package's (capability parity with reference
``cornac/datasets/amazon_review.py``). Files are cached under the framework cache
dir (see :mod:`cornac_tpu_torch.utils.download`, which downloads nothing).
"""

from ..data import Reader
from ..utils import validate_format
from ..utils.download import cache

import gzip
import json
import os

_BASE_URL = "https://snap.stanford.edu/data/amazon/productGraph/categoryFiles"

# short names used throughout the Semantic-ID literature
# (reference datasets/amazon_review.py:35-39)
_CATEGORY_FILES = {
    "beauty": "Beauty",
    "sports": "Sports_and_Outdoors",
    "toys": "Toys_and_Games",
}


def _category_stem(category, version):
    stem = _CATEGORY_FILES.get(category, category.strip().replace(" ", "_"))
    if version != "2014":
        raise ValueError("only the 2014 version is supported")
    return stem


def _item_text(meta, include_description=False):
    """Flatten item metadata into one text string (title, price, brand,
    categories — the content features embedded with Sentence-T5 in the
    TIGER paper; reference ``datasets/amazon_review.py:89-120``)."""
    parts = []
    if meta.get("title"):
        parts.append(f"Title: {meta['title']}")
    if meta.get("price") is not None:
        parts.append(f"Price: {meta['price']}")
    if meta.get("brand"):
        parts.append(f"Brand: {meta['brand']}")
    categories = meta.get("categories")
    if categories:
        flat = categories[0] if isinstance(categories[0], list) else categories
        if flat:
            parts.append("Categories: " + ", ".join(str(c) for c in flat))
    if include_description and meta.get("description"):
        parts.append(f"Description: {meta['description']}")
    return ". ".join(parts)


def load_text(category, version="2014", include_description=False):
    """Item content texts aligned to the 5-core review items (reference
    ``datasets/amazon_review.py:149-181``): items without a metadata entry
    get an empty string. Returns ``(texts, ids)``."""
    import csv

    stem = _category_stem(category, version)
    # item universe = the reviews file's items
    rows = load_feedback(category, version, fmt="UIRT")
    item_ids = []
    seen = set()
    for _, iid, *_ in rows:
        if iid not in seen:
            seen.add(iid)
            item_ids.append(iid)

    suffix = "_text_desc" if include_description else "_text"
    from ..utils.download import get_cache_path

    text_path, _ = get_cache_path(
        f"amazon_review/{category}_{version}{suffix}.csv"
    )
    if not os.path.exists(text_path):
        meta_gz_path = cache(
            url=f"{_BASE_URL}/meta_{stem}.json.gz",
            relative_path=f"amazon_review/meta_{category}_{version}.json.gz",
        )
        texts_by_item = {}
        with gzip.open(meta_gz_path, "rt", encoding="utf-8") as fin:
            for line in fin:
                # the 2014 meta files are python-literal lines, not JSON
                try:
                    d = json.loads(line)
                except ValueError:
                    import ast as _ast

                    d = _ast.literal_eval(line)
                if d.get("asin") in seen:
                    texts_by_item[d["asin"]] = _item_text(
                        d, include_description
                    )
        with open(text_path, "w", newline="", encoding="utf-8") as fout:
            w = csv.writer(fout)
            for iid in item_ids:
                w.writerow([iid, texts_by_item.get(iid, "")])

    texts, ids = [], []
    with open(text_path, newline="", encoding="utf-8") as f:
        for item, text in csv.reader(f):
            ids.append(item)
            texts.append(text)
    return texts, ids


def load_feedback(category, version="2014", fmt="UIRT", reader=None):
    """Load (user, item, rating, timestamp) for an Amazon category (5-core)."""
    stem = _category_stem(category, version)
    gz_path = cache(
        url=f"{_BASE_URL}/reviews_{stem}_5.json.gz",
        relative_path=f"amazon_review/{category}_{version}.json.gz",
    )
    csv_path = gz_path + ".csv"
    if not os.path.exists(csv_path):
        with gzip.open(gz_path, "rt", encoding="utf-8") as fin, open(
            csv_path, "w", encoding="utf-8"
        ) as fout:
            for line in fin:
                d = json.loads(line)
                fout.write(
                    f"{d['reviewerID']},{d['asin']},{d['overall']},{d['unixReviewTime']}\n"
                )
    reader = Reader() if reader is None else reader
    return reader.read(csv_path, fmt=fmt, sep=",")


def load_review(category, version="2014", reader=None):
    """Load (user, item, review text) for an Amazon category (5-core)."""
    stem = _category_stem(category, version)
    gz_path = cache(
        url=f"{_BASE_URL}/reviews_{stem}_5.json.gz",
        relative_path=f"amazon_review/{category}_{version}.json.gz",
    )
    out = []
    with gzip.open(gz_path, "rt", encoding="utf-8") as fin:
        for line in fin:
            d = json.loads(line)
            out.append((d["reviewerID"], d["asin"], d.get("reviewText", "")))
    return out
