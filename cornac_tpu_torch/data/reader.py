"""Line-oriented reading of interaction files (host-side).

A copy of ``cornac_tpu/data/reader.py::Reader`` for the UIR line format
(what ``serving.core.handle_evaluate`` reads) through the Python parser,
with the same frequency / set filters and binarize-by-threshold. The JAX
package's native C++ reader, and its other line formats, come in later
slices.
"""

import itertools
from collections import Counter


def _parse_uir(tokens, **kwargs):
    return [(tokens[0], tokens[1], float(tokens[2]))]


PARSERS = {"UIR": _parse_uir}


class Reader:
    """Read and filter raw interaction files.

    ``user_set``/``item_set`` retain only listed entities;
    ``min_user_freq``/``min_item_freq`` drop rare entities;
    ``num_top_freq_user``/``..._item`` retain only the most frequent;
    ``bin_threshold`` binarizes explicit ratings.
    """

    def __init__(
        self,
        user_set=None,
        item_set=None,
        min_user_freq=1,
        min_item_freq=1,
        num_top_freq_user=0,
        num_top_freq_item=0,
        bin_threshold=None,
        encoding="utf-8",
        errors=None,
    ):
        self.user_set = set(user_set) if user_set is not None else None
        self.item_set = set(item_set) if item_set is not None else None
        self.min_user_freq, self.min_item_freq = min_user_freq, min_item_freq
        self.num_top_freq_user = num_top_freq_user
        self.num_top_freq_item = num_top_freq_item
        self.bin_threshold = bin_threshold
        self.encoding, self.errors = encoding, errors

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
                keep = {k for k, _ in freq.most_common(top_n)}
                tuples = [t for t in tuples if t[pos] in keep]

        for pos, allowed in ((u_pos, self.user_set), (i_pos, self.item_set)):
            if allowed is not None:
                tuples = [t for t in tuples if t[pos] in allowed]

        for pos, floor in ((u_pos, self.min_user_freq),
                           (i_pos, self.min_item_freq)):
            if floor > 1:
                freq = Counter(t[pos] for t in tuples)
                tuples = [t for t in tuples if freq[t[pos]] >= floor]

        return tuples

    def read(self, fpath, fmt="UIR", sep="\t", skip_lines=0, id_inline=False,
             parser=None, **kwargs):
        """Parse a file line by line into tuples according to ``fmt`` or a
        custom ``parser`` callable, then apply the configured filters."""
        parser = PARSERS.get(fmt, None) if parser is None else parser
        if parser is None:
            raise ValueError(
                "Invalid line format: {}\nSupported formats: {}".format(
                    fmt, list(PARSERS.keys())
                )
            )
        with open(fpath, encoding=self.encoding, errors=self.errors) as f:
            tuples = [
                tup
                for idx, line in enumerate(itertools.islice(f, skip_lines, None))
                for tup in parser(
                    line.strip().split(sep), line_idx=idx, id_inline=id_inline, **kwargs
                )
            ]
        return self._filter(tuples, fmt=fmt)
