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
