"""Runtime configuration: the device-runtime knobs, applied process-wide.

Port of ``cornac_tpu/config.py``. Model hyperparameters stay constructor
kwargs; this dataclass sets what the process runs on. The fields map to
the port as follows:

- ``platform``: ``set_default_device``: "cpu", or "cuda" / "gpu" for the
  port's rule, the card or raise;
- ``matmul_precision``: ``torch.set_float32_matmul_precision``, "highest"
  and "float32" to "highest", "bfloat16" to "medium";
- ``device_metrics_min_cells``: ``metrics.ranking.set_device_metrics_min_cells``;
- ``coordinator_address``, ``num_processes``, ``process_id``:
  ``parallel.init_distributed`` (a ``torch.distributed`` group at
  ``tcp://<coordinator_address>``, NCCL on the card, gloo on the CPU);
- ``data_parallel`` and ``make_mesh``: ``parallel.make_mesh``, the
  (data, model) ``DeviceMesh``;
- ``host_device_count``: the JAX package simulates N devices inside one
  process; the port's counterpart is N gloo processes, one a rank, each
  calling ``init_distributed`` (``torchrun --nproc-per-node N`` on the CPU),
  so it raises rather than being ignored;
- ``compilation_cache_dir``: XLA's persistent compilation cache, which has
  no counterpart in the port (its kernels are built once per checkout by
  nvcc): it raises rather than being ignored.

Usage::

    from cornac_tpu_torch.config import RuntimeConfig

    RuntimeConfig(platform="cuda", matmul_precision="highest").apply()
"""

import dataclasses
from typing import Optional

_PRECISIONS = {"highest": "highest", "float32": "highest", "bfloat16": "medium"}
_PLATFORMS = {"cpu": "cpu", "cuda": None, "gpu": None}  # None: the card, or raise


@dataclasses.dataclass
class RuntimeConfig:
    """Device-runtime knobs, applied process-wide by ``apply``."""

    #: size of the mesh's data axis (None = every rank on data)
    data_parallel: Optional[int] = None
    #: default float32 matmul precision: "highest" | "float32" | "bfloat16"
    matmul_precision: str = "highest"
    #: XLA's persistent compilation cache: no counterpart in the port (raises)
    compilation_cache_dir: Optional[str] = None
    #: the process's default device: "cpu", "cuda" (or "gpu"); None keeps it
    platform: Optional[str] = None
    #: host-device count for simulated multi-chip runs: no counterpart (raises)
    host_device_count: Optional[int] = None
    #: multi-process: rank 0's "host:port", the number of ranks and this
    #: process's rank start the ``torch.distributed`` group (None = one process)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    #: minimum score-matrix cells before RankingContext ranks on the device
    device_metrics_min_cells: Optional[int] = None

    def apply(self):
        """Apply to the current process; every field is checked before any
        takes effect."""
        import torch

        from .device import set_default_device
        from .metrics.ranking import set_device_metrics_min_cells
        from .parallel import init_distributed

        if self.host_device_count is not None:
            raise NotImplementedError(
                "RuntimeConfig(host_device_count=...) makes the JAX package simulate N devices "
                "inside one process; the port's counterpart is N gloo processes, one a rank, each "
                "calling cornac_tpu_torch.parallel.init_distributed (e.g. torchrun "
                "--nproc-per-node N with set_default_device('cpu'))"
            )
        if self.coordinator_address is not None and (self.num_processes is None
                                                     or self.process_id is None):
            raise ValueError("RuntimeConfig(coordinator_address=...) needs num_processes and "
                             "process_id")
        if self.compilation_cache_dir is not None:
            raise NotImplementedError(
                "RuntimeConfig(compilation_cache_dir=...) configures XLA's persistent "
                "compilation cache, which has no counterpart in the port (its CUDA kernels "
                "are built once per checkout by nvcc)"
            )
        if self.matmul_precision not in _PRECISIONS:
            raise ValueError("matmul_precision must be highest/float32/bfloat16")
        if self.platform is not None and self.platform not in _PLATFORMS:
            raise ValueError(f"platform must be one of {sorted(_PLATFORMS)}, got "
                             f"{self.platform!r}")

        if self.platform is not None:
            set_default_device(_PLATFORMS[self.platform])
        torch.set_float32_matmul_precision(_PRECISIONS[self.matmul_precision])
        if self.device_metrics_min_cells is not None:
            set_device_metrics_min_cells(self.device_metrics_min_cells)
        if self.coordinator_address is not None:
            init_distributed(coordinator_address=self.coordinator_address,
                             num_processes=self.num_processes, process_id=self.process_id)
        return self

    def make_mesh(self):
        """The (data, model) mesh with ``data_parallel`` ranks on data
        (``parallel.make_mesh``)."""
        from .parallel import make_mesh

        return make_mesh(data_parallel=self.data_parallel)
