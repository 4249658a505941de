"""The native (C++) host-side rating parser, built on demand with the
system g++.

See ``build.py``; the reader tolerates it being unavailable (no compiler,
read-only checkout) and parses in Python.
"""

from .build import load_extension  # noqa: F401
