"""Build and load the hand-written CUDA kernels in ``cornac_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/cornac_tpu_torch/`` at the root of the checkout, named by a hash of
the source, every header in ``csrc/`` and the flags (so a changed shared
header rebuilds every library), and loaded with ``ctypes``. Nothing here runs
when the module is imported: the CPU tests import it on machines without
``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cornac_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` source, built and loaded on first use.

    ``build_seconds`` and ``compiler_log`` (nvcc's ``-Xptxas -v`` report of
    registers, shared memory and spills) describe the last build; both stay
    empty when a library built earlier from the same source was reused."""

    def __init__(self, name):
        self.name = name
        self.build_seconds = None
        self.compiler_log = ""
        self._lib = None

    @property
    def source(self):
        return CSRC / f"{self.name}.cu"

    def path(self):
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self):
        """Compile the source unless a library of the same hash exists."""
        target = self.path()
        if target.exists():
            return target
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
            capture_output=True, text=True,
        )
        self.build_seconds = time.perf_counter() - start
        self.compiler_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source}:\n{self.compiler_log}")
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
        return target

    def load(self):
        """The loaded ``ctypes.CDLL``, building it first if needed."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.cornac_cuda_error_string.argtypes = [ctypes.c_int]
            lib.cornac_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err):
        """Raise on a non-zero ``cudaError_t`` returned by a launch."""
        if err != 0:
            msg = self.load().cornac_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} ({msg})")


def check_tensor(t, name, ndim):
    """Shape of ``t`` after checking that it is a contiguous float32 CUDA
    tensor of ``ndim`` dimensions; raises ``ValueError`` otherwise."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return tuple(t.shape)
