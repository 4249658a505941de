"""cornac_tpu_torch — the port of ``cornac_tpu`` to PyTorch and CUDA.

A second package beside the JAX one, with the same module paths, public
names and contracts. Plain tensor code is PyTorch; every kernel the JAX
package wrote in Pallas becomes a CUDA kernel written by hand for Hopper
(``csrc/``), built with ``nvcc`` at first use. It imports neither JAX nor
anything of ``cornac_tpu``.

Entry points run on the card: ``default_device()`` is ``cuda`` and raises
without one, unless the caller passes ``device="cpu"`` or calls
``set_default_device("cpu")``.
"""

from .device import default_device, set_default_device
from . import data, eval_methods, experiment, metrics, models
from .experiment import Experiment

__version__ = "0.1.0"

__all__ = [
    "Experiment",
    "data",
    "default_device",
    "eval_methods",
    "experiment",
    "metrics",
    "models",
    "set_default_device",
]
