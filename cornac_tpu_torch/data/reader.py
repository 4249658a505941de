"""Line-oriented reading of interaction files (host-side).

A copy of ``cornac_tpu/data/reader.py``: the twelve line formats (UI, UIR,
UIRT, UITup, UIReview, UBI, UBIT, UBITJson, SIT, SITJson, USIT, USITJson),
the frequency / set / basket / sequence filters, binarize-by-threshold and
``read_text``. UIR and UIRT files with a one-character separator, no
skipped lines and no custom parser go through the native C++ parser
(``native/fast_io_ext.cpp``, built with g++ at first use), which gives the
line-by-line parser's tuples byte for byte; a malformed row, a non-numeric
rating or timestamp column, or a missing compiler sends the file to the
Python parser, as in the JAX package. ``Reader.parsed_natively`` tells
which parser read the last file.
"""

import ast
import itertools

import numpy as np
from collections import Counter


def _parse_ui(tokens, line_idx=0, id_inline=False, **kwargs):
    if id_inline:
        return [(str(line_idx + 1), iid, 1.0) for iid in tokens]
    return [(tokens[0], iid, 1.0) for iid in tokens[1:]]


def _parse_uir(tokens, **kwargs):
    return [(tokens[0], tokens[1], float(tokens[2]))]


def _parse_uirt(tokens, **kwargs):
    return [(tokens[0], tokens[1], float(tokens[2]), int(tokens[3]))]


def _parse_uitup(tokens, **kwargs):
    tup_sep = kwargs.get("tup_sep")
    return [
        (tokens[0], tokens[1], [tuple(t.split(tup_sep)) for t in tokens[2:]])
    ]


def _parse_uireview(tokens, **kwargs):
    return [(tokens[0], tokens[1], tokens[2])]


def _parse_ubi(tokens, **kwargs):
    return [(tokens[0], tokens[1], tokens[2])]


def _parse_ubit(tokens, **kwargs):
    return [(tokens[0], tokens[1], tokens[2], int(tokens[3]))]


def _parse_ubitjson(tokens, **kwargs):
    return [
        (tokens[0], tokens[1], tokens[2], int(tokens[3]), ast.literal_eval(tokens[4]))
    ]


def _parse_sit(tokens, **kwargs):
    return [(tokens[0], tokens[1], int(tokens[2]))]


def _parse_sitjson(tokens, **kwargs):
    return [(tokens[0], tokens[1], int(tokens[2]), ast.literal_eval(tokens[3]))]


def _parse_usit(tokens, **kwargs):
    return [(tokens[0], tokens[1], tokens[2], int(tokens[3]))]


def _parse_usitjson(tokens, **kwargs):
    return [
        (tokens[0], tokens[1], tokens[2], int(tokens[3]), ast.literal_eval(tokens[4]))
    ]


# public aliases under the reference's parser names (data/reader.py:21-96),
# so custom-parser call sites written against the reference keep working
ui_parser = _parse_ui
uir_parser = _parse_uir
uirt_parser = _parse_uirt
tup_parser = _parse_uitup
review_parser = _parse_uireview
ubi_parser = _parse_ubi
ubit_parser = _parse_ubit
ubitjson_parser = _parse_ubitjson
sit_parser = _parse_sit
sitjson_parser = _parse_sitjson
usit_parser = _parse_usit
usitjson_parser = _parse_usitjson

PARSERS = {
    "UI": _parse_ui,
    "UIR": _parse_uir,
    "UIRT": _parse_uirt,
    "UITup": _parse_uitup,
    "UIReview": _parse_uireview,
    "UBI": _parse_ubi,
    "UBIT": _parse_ubit,
    "UBITJson": _parse_ubitjson,
    "SIT": _parse_sit,
    "SITJson": _parse_sitjson,
    "USIT": _parse_usit,
    "USITJson": _parse_usitjson,
}

BASKET_FMTS = {"UBI", "UBIT", "UBITJson"}
SEQUENCE_FMTS = {"SIT", "SITJson", "USIT", "USITJson"}


class Reader:
    """Read and filter raw interaction files.

    Parameters mirror the reference reader (``data/reader.py:98-199``):
    ``user_set``/``item_set`` retain only listed entities; ``min_user_freq``/
    ``min_item_freq`` drop rare entities; ``num_top_freq_user``/``..._item``
    retain only the most frequent; ``min/max_basket_size``,
    ``min_basket_sequence``, ``min/max_sequence_size`` filter basket/session
    data; ``bin_threshold`` binarizes explicit ratings.
    """

    def __init__(
        self,
        user_set=None,
        item_set=None,
        min_user_freq=1,
        min_item_freq=1,
        num_top_freq_user=0,
        num_top_freq_item=0,
        min_basket_size=1,
        max_basket_size=-1,
        min_basket_sequence=1,
        min_sequence_size=1,
        max_sequence_size=-1,
        bin_threshold=None,
        encoding="utf-8",
        errors=None,
    ):
        self.user_set = set(user_set) if user_set is not None else None
        self.item_set = set(item_set) if item_set is not None else None
        self.min_user_freq, self.min_item_freq = min_user_freq, min_item_freq
        self.num_top_freq_user = num_top_freq_user
        self.num_top_freq_item = num_top_freq_item
        self.min_basket_size, self.max_basket_size = min_basket_size, max_basket_size
        self.min_basket_sequence = min_basket_sequence
        self.min_sequence_size, self.max_sequence_size = (
            min_sequence_size, max_sequence_size,
        )
        self.bin_threshold = bin_threshold
        self.encoding, self.errors = encoding, errors

    @staticmethod
    def _members_of(tuples, pos, allowed):
        return [t for t in tuples if t[pos] in allowed]

    @staticmethod
    def _group_size_window(tuples, pos, lo, hi):
        """Keep tuples whose group (by column ``pos``) has lo <= size
        (<= hi when hi > 1); recounts after the lower cut like the
        reference's two sequential passes."""
        if lo > 1:
            sizes = Counter(t[pos] for t in tuples)
            tuples = [t for t in tuples if sizes[t[pos]] >= lo]
        if hi > 1:
            sizes = Counter(t[pos] for t in tuples)
            tuples = [t for t in tuples if sizes[t[pos]] <= hi]
        return tuples

    def _filter(self, tuples, fmt="UIR"):
        u_pos, i_pos, r_pos = fmt.find("U"), fmt.find("I"), fmt.find("R")

        if self.bin_threshold is not None and r_pos >= 0:
            thr = self.bin_threshold
            tuples = [
                tuple(1.0 if p == r_pos else v for p, v in enumerate(t))
                for t in tuples
                if t[r_pos] >= thr
            ]

        for pos, top_n in ((u_pos, self.num_top_freq_user),
                           (i_pos, self.num_top_freq_item)):
            if top_n > 0:
                freq = Counter(t[pos] for t in tuples)
                tuples = self._members_of(
                    tuples, pos, {k for k, _ in freq.most_common(top_n)}
                )

        for pos, allowed in ((u_pos, self.user_set), (i_pos, self.item_set)):
            if allowed is not None:
                tuples = self._members_of(tuples, pos, allowed)

        for pos, floor in ((u_pos, self.min_user_freq),
                           (i_pos, self.min_item_freq)):
            if floor > 1:
                freq = Counter(t[pos] for t in tuples)
                tuples = [t for t in tuples if freq[t[pos]] >= floor]

        return tuples

    def _filter_basket(self, tuples, fmt="UBI"):
        u_pos, b_pos = fmt.find("U"), fmt.find("B")
        tuples = self._group_size_window(
            tuples, b_pos, self.min_basket_size, self.max_basket_size
        )
        if self.min_basket_sequence > 1:
            n_baskets_of = Counter(
                u for (u, _) in {(t[u_pos], t[b_pos]) for t in tuples}
            )
            tuples = [
                t for t in tuples
                if n_baskets_of[t[u_pos]] >= self.min_basket_sequence
            ]
        return tuples

    def _filter_sequence(self, tuples, fmt="SIT"):
        return self._group_size_window(
            tuples, fmt.find("S"), self.min_sequence_size, self.max_sequence_size
        )

    def read(
        self, fpath, fmt="UIR", sep="\t", skip_lines=0, id_inline=False, parser=None, **kwargs
    ):
        """Parse a file line-by-line into tuples according to ``fmt`` or a
        custom ``parser`` callable, then apply the configured filters."""
        custom_parser = parser is not None
        parser = PARSERS.get(fmt, None) if parser is None else parser
        if parser is None:
            raise ValueError(
                "Invalid line format: {}\nSupported formats: {}".format(
                    fmt, list(PARSERS.keys())
                )
            )

        tuples = None
        if (
            not custom_parser
            and fmt in ("UIR", "UIRT")
            and skip_lines == 0
            and not id_inline
            and len(sep) == 1
            and self.errors is None
        ):
            tuples = self._read_native(fpath, fmt, sep)
        self.parsed_natively = tuples is not None
        if tuples is None:
            with open(fpath, encoding=self.encoding, errors=self.errors) as f:
                tuples = [
                    tup
                    for idx, line in enumerate(itertools.islice(f, skip_lines, None))
                    for tup in parser(
                        line.strip().split(sep), line_idx=idx, id_inline=id_inline, **kwargs
                    )
                ]

        tuples = self._filter(tuples, fmt=fmt)
        if fmt in BASKET_FMTS:
            tuples = self._filter_basket(tuples, fmt=fmt)
        elif fmt in SEQUENCE_FMTS:
            tuples = self._filter_sequence(tuples, fmt=fmt)
        return tuples

    def _read_native(self, fpath, fmt, sep):
        """The whole file's tuples from the native parser, or None to parse
        it line by line (no extension, a malformed row, a non-numeric
        rating or timestamp column, an encoding the C parser cannot read)."""
        from ..native import load_extension

        ext = load_extension()
        if ext is None:
            return None
        with open(fpath, "rb") as f:
            raw = f.read()
        if not raw.isascii() and self.encoding.lower() not in ("utf-8", "utf8", "ascii"):
            return None  # the C parser assumes UTF-8-compatible bytes
        return ext.parse_ratings(raw, sep, fmt == "UIRT")


def read_text(fpath, sep=None, encoding="utf-8", errors=None):
    """Read a text file; with ``sep`` return (texts, ids), else a list of lines."""
    with open(fpath, encoding=encoding, errors=errors) as f:
        if sep is None:
            return [line.strip() for line in f]
        texts, ids = [], []
        for line in f:
            tokens = line.strip().split(sep)
            ids.append(tokens[0])
            texts.append(sep.join(tokens[1:]))
        return texts, ids
