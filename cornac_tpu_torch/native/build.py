"""Build-on-first-use loaders for the native host-side parsers.

A port of ``cornac_tpu/native/build.py`` for the one source that the
reader calls, the port's own copy of ``fast_io_ext.cpp`` (a CPython
extension that ``data/reader.py`` calls for UIR/UIRT files; the JAX
package's ctypes tokenizer, ``fast_io.cpp``, has no caller there or here
and was not carried over). It is compiled with the system ``g++`` the
first time it is asked for, into ``build/cornac_tpu_torch/`` at the root
of the checkout (never into the package directory), under a name that
hashes the source, the flags, this interpreter's headers and its ABI tag;
a build writes a temporary file and renames it into place, so two
processes building at once never load half a module. The loader returns
None when the build or the load fails (no compiler, read-only checkout),
and the reader parses in Python.
"""

import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cornac_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_EXTENSION = []  # once tried: [the loaded module, or None]


def _target(source, extra, suffix):
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(CXX_FLAGS + extra).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}{suffix}"


def _compile(source, extra, suffix):
    """Path of the built object, compiling it unless it exists."""
    target = _target(source, extra, suffix)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, *extra, str(source), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, target)
    finally:
        tmp.unlink(missing_ok=True)
    return target


def _extension_module():
    # extensions on Linux do not link libpython: the headers and the ABI
    # tag of this interpreter name the build
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    path = _compile(SRC_DIR / "fast_io_ext.cpp", ("-I", include), suffix)
    loader = importlib.machinery.ExtensionFileLoader("fast_io_ext", str(path))
    spec = importlib.util.spec_from_loader("fast_io_ext", loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def load_extension():
    """The ``fast_io_ext`` parser module, or None if unavailable."""
    with _LOCK:
        if not _EXTENSION:
            try:
                _EXTENSION.append(_extension_module())
            except Exception:
                _EXTENSION.append(None)
        return _EXTENSION[0]
