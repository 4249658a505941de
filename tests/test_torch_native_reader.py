"""The port's native reader against the JAX package's, on the CPU.

The port keeps its own copy of ``fast_io_ext.cpp`` and builds it with g++
at first use into ``build/cornac_tpu_torch/``. Held here: the native path
is taken on this host (which has g++), its tuples equal the line-by-line
parser's and the JAX package's byte for byte (types included), and
malformed rows and non-numeric columns go to the Python parser as in the
JAX package.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from cornac_tpu.data import Reader as JaxReader
from cornac_tpu_torch.data import Reader
from cornac_tpu_torch.native import build as native_build

ROOT = Path(__file__).resolve().parents[1]


def _write(path, rows):
    path.write_text("".join(rows))
    return str(path)


def _typed(tuples):
    return [tuple((type(v).__name__, v) for v in t) for t in tuples]


@pytest.fixture(scope="module")
def rating_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(3)
    rows = [f"u{rng.randint(50)}\ti{rng.randint(80)}\t{rng.randint(1, 6) / 2:g}"
            f"\t{1_000_000 + k}\n" for k in range(2000)]
    rows[7] = "u1\ti2\t3.5e0\t17\n"  # exponent: strtod and float() agree
    rows[8] = "u1\ti3\t4\t18\r\n"  # CRLF ending
    uirt = _write(d / "uirt.tsv", rows)
    uir = _write(d / "uir.csv", [",".join(r.rstrip("\r\n").split("\t")[:3]) + "\n" for r in rows])
    unicode = _write(d / "unicode.tsv", ["usér\titém\t4.0\n", "u2\ti2\t1.5\n"])
    malformed = _write(d / "malformed.tsv", rows[:10] + ["u9\ti9\n"] + rows[10:20])
    text_rating = _write(d / "text_rating.tsv", ["u1\ti1\tgood\t1\n"])
    padded = _write(d / "padded.tsv", [" u1\ti1\t4.0\n", "u2\ti2\t2.0\n"])
    # no newline after the last row; negative, signed and fractional values
    unterminated = _write(d / "unterminated.tsv", ["u1\ti1\t-1.25\t5\n", "u2\ti1\t+2\t6\n",
                                                   "u1\ti3\t.5\t7"])
    return dict(uirt=uirt, uir=uir, unicode=unicode, malformed=malformed,
                text_rating=text_rating, padded=padded, unterminated=unterminated)


def _python_path(fpath, fmt, sep):
    """The line-by-line parser's tuples (a custom parser never takes the
    native path)."""
    from cornac_tpu_torch.data.reader import PARSERS

    return Reader().read(fpath, fmt=fmt, sep=sep, parser=PARSERS[fmt])


@pytest.mark.parametrize("name, fmt, sep", [("uirt", "UIRT", "\t"), ("uir", "UIR", ","),
                                            ("unicode", "UIR", "\t"),
                                            ("unterminated", "UIRT", "\t")])
def test_native_path_is_taken_and_matches(rating_files, name, fmt, sep):
    reader = Reader()
    got = reader.read(rating_files[name], fmt=fmt, sep=sep)
    assert reader.parsed_natively, "this host has g++: the native parser must run"
    assert _typed(got) == _typed(_python_path(rating_files[name], fmt, sep))
    assert _typed(got) == _typed(JaxReader().read(rating_files[name], fmt=fmt, sep=sep))


def test_native_build_lands_in_build_dir(rating_files):
    Reader().read(rating_files["uir"], fmt="UIR", sep=",")
    assert native_build.load_extension() is not None
    built = sorted(p.name for p in (ROOT / "build" / "cornac_tpu_torch").glob("fast_io_ext-*"))
    assert built, "the extension is built under build/cornac_tpu_torch/"
    package_dir = ROOT / "cornac_tpu_torch" / "native"
    assert not [p for p in os.listdir(package_dir) if p.endswith(".so")]


@pytest.mark.parametrize("name, fmt", [("malformed", "UIR"), ("text_rating", "UIRT"),
                                       ("padded", "UIR")])
def test_irregular_files_go_to_the_python_parser(rating_files, name, fmt):
    reader = Reader()
    jax_reader = JaxReader()
    try:
        want = jax_reader.read(rating_files[name], fmt=fmt)
    except (IndexError, ValueError) as err:
        with pytest.raises(type(err)):
            reader.read(rating_files[name], fmt=fmt)
        assert not reader.parsed_natively
        return
    got = reader.read(rating_files[name], fmt=fmt)
    assert not reader.parsed_natively
    assert _typed(got) == _typed(want)


def test_skip_lines_and_filters_match(rating_files):
    kw = dict(min_user_freq=30, min_item_freq=20, bin_threshold=2.0)
    got = Reader(**kw).read(rating_files["uirt"], fmt="UIRT")
    assert _typed(got) == _typed(JaxReader(**kw).read(rating_files["uirt"], fmt="UIRT"))
    reader = Reader()
    got = reader.read(rating_files["uirt"], fmt="UIRT", skip_lines=3)
    assert not reader.parsed_natively  # skipped lines go line by line, as in the JAX package
    assert _typed(got) == _typed(JaxReader().read(rating_files["uirt"], fmt="UIRT", skip_lines=3))
