"""The build canary on the CPU: ``scale2`` runs its plain version there,
bit for bit ``x * 2``, and refuses to run the kernel on a CPU tensor. The
kernel itself is held to ``x * 2`` on the card by ``chip_smoke.py``,
``tools/cuda_on_silicon.py`` and ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import cornac_tpu_torch
from cornac_tpu_torch.ops.canary import CANARY, scale2, scale2_torch

cornac_tpu_torch.set_default_device("cpu")


@pytest.mark.parametrize("shape", [(128, 128), (7,), (3, 5, 2), (0,)])
def test_plain_version_on_the_cpu(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    before = CANARY.launches
    y = scale2(torch.from_numpy(x))
    assert CANARY.launches == before  # the kernel never ran
    assert y.dtype == torch.float32 and y.shape == shape
    np.testing.assert_array_equal(y.numpy(), x * 2)
    assert torch.equal(scale2_torch(torch.from_numpy(x)), y)


def test_numpy_input_goes_to_the_default_device():
    y = scale2(np.arange(6, dtype=np.float64).reshape(2, 3))
    assert y.device.type == "cpu" and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.arange(6).reshape(2, 3) * 2.0)


def test_kernel_refuses_cpu_tensors():
    x = torch.ones(128, 128)
    with pytest.raises(ValueError):
        scale2(x, force="kernel")
    with pytest.raises(ValueError):
        CANARY(x)
    with pytest.raises(ValueError):
        CANARY(torch.ones(4, 4).t())  # not contiguous
    with pytest.raises(ValueError):
        scale2(x, force="pallas")
    assert CANARY.library.source.name == "canary.cu" and CANARY.library.source.exists()


_PACKED_SOURCE = r"""
#include <cstdint>
extern "C" int packed_probe(const int64_t* args) {
  return (int)(args[0] + (args[1] >> 40) - args[2]);
}
"""


def test_packed_call_passes_every_argument_and_counts_them(tmp_path):
    """``native.PackedCall``, the canary's binding, on a C function built
    here with g++: each int64 arrives (a pointer-sized value too), a wrong
    count raises, and threads calling at once each get their own answer."""
    import ctypes
    import subprocess
    import sys
    import threading

    from cornac_tpu_torch.ops.native import PackedCall

    src, lib = tmp_path / "probe.cpp", tmp_path / "libprobe.so"
    src.write_text(_PACKED_SOURCE)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    call = PackedCall(ctypes.CDLL(str(lib)).packed_probe, 3)
    assert call(5, 7 << 40, -2) == 14
    with pytest.raises(ValueError):
        call(1, 2)

    wrong = []

    def worker(k):
        for r in range(300):
            if call(k, r << 40, 0) != k + r:
                wrong.append((k, r))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and wrong == []
