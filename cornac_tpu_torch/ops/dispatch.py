"""Which implementation a kernel wrapper runs.

The JAX package picks Pallas or XLA by an environment variable plus a
per-call ``force=``. The port has no environment switch: a tensor on the
card always goes to the hand-written kernel, a tensor on the CPU to the
kernel's plain PyTorch version, and ``force=`` exists only so the tests and
``chip_smoke.py`` can run the plain version on the card. ``full_f32``
sets how the plain versions' float32 products run there.
"""

import contextlib

import torch

PATHS = ("kernel", "torch")


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products in full float32 on the card (TF32 off), as
    the JAX package's XLA products and the hand-written kernels run."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resolve_path(force, device):
    """``"kernel"`` or ``"torch"`` for a tensor on ``device``."""
    if force is None:
        return "kernel" if device.type == "cuda" else "torch"
    if force not in PATHS:
        raise ValueError(f"force must be one of {PATHS} or None, got {force!r}")
    if force == "kernel" and device.type != "cuda":
        raise ValueError("the CUDA kernel needs tensors on a CUDA device")
    return force
