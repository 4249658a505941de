"""The build canary: ``o = 2 * x``.

Port of the compile probe ``benchmarks/pallas_on_silicon.py::copy_kernel``
(a ``pl.pallas_call`` that doubles one (128, 128) block). For a tensor on
the card the hand-written kernel ``csrc/canary.cu`` runs, built and bound
exactly as the port's other kernels are (``ops/native.py``), so a run that
gets an answer from it has proved the toolchain, the library loader and a
launch on the current stream. For a tensor on the CPU the plain version
``scale2_torch`` runs. The answer is exact either way: doubling a float32
only moves its exponent.
"""

import torch

from ..device import default_device
from .dispatch import resolve_path
from .native import CudaLibrary, PackedCall


class CanaryKernel:
    """ctypes binding of ``cornac_scale2``; ``launches`` counts the calls
    that launch it, and nothing else adds to it.

    A call does only what the launch needs: three attribute checks, the
    output, the device and its current stream, and the five arguments in
    one packed array (``native.PackedCall``)."""

    def __init__(self):
        self.library = CudaLibrary("canary")
        self.launches = 0
        self._call = None

    def __call__(self, x):
        """Launch on the current stream. x: contiguous float32 on a CUDA
        device, any shape. Returns a new tensor of x's shape."""
        if not (isinstance(x, torch.Tensor) and x.is_cuda and x.dtype == torch.float32
                and x.is_contiguous()):
            raise ValueError("x must be a contiguous float32 CUDA tensor")
        out = torch.empty_like(x)
        if self._call is None:
            self._call = PackedCall(self.library.load().cornac_scale2, 5)
        # the C side launches on this device and restores the caller's
        index = x.get_device()
        err = self._call(index, x.data_ptr(), out.data_ptr(), x.numel(),
                         torch._C._cuda_getCurrentRawStream(index))
        if err:
            self.library.check(err)
        self.launches += 1
        return out


CANARY = CanaryKernel()


def scale2_torch(x):
    """Plain version: ``x * 2``."""
    return x * 2


def scale2(x, force=None):
    """``2 * x`` as float32. Tensors stay on their device; other inputs go
    to the default device. ``force``: None (the kernel on the card, the
    plain version on the CPU), ``"kernel"`` or ``"torch"``."""
    device = x.device if isinstance(x, torch.Tensor) else default_device()
    x = torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()
    if resolve_path(force, device) == "torch":
        return scale2_torch(x)
    return CANARY(x)
