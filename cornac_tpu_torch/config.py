"""Runtime configuration: the device-runtime knobs, applied process-wide.

Port of ``cornac_tpu/config.py``. Model hyperparameters stay constructor
kwargs; this dataclass sets what the process runs on. The fields map to
the port as follows:

- ``platform``: ``set_default_device``: "cpu", or "cuda" / "gpu" for the
  port's rule, the card or raise;
- ``matmul_precision``: ``torch.set_float32_matmul_precision``, "highest"
  and "float32" to "highest", "bfloat16" to "medium";
- ``device_metrics_min_cells``: ``metrics.ranking.set_device_metrics_min_cells``;
- ``data_parallel``, ``host_device_count``, ``coordinator_address``,
  ``num_processes``, ``process_id`` and ``make_mesh``: the multi-device
  runtime, not ported yet (ROADMAP.md A8): they raise;
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
_MULTI_DEVICE = ("data_parallel", "host_device_count", "coordinator_address", "num_processes",
                 "process_id")


@dataclasses.dataclass
class RuntimeConfig:
    """Device-runtime knobs, applied process-wide by ``apply``."""

    #: size of the mesh's data axis (multi-device: raises, ROADMAP.md A8)
    data_parallel: Optional[int] = None
    #: default float32 matmul precision: "highest" | "float32" | "bfloat16"
    matmul_precision: str = "highest"
    #: XLA's persistent compilation cache: no counterpart in the port (raises)
    compilation_cache_dir: Optional[str] = None
    #: the process's default device: "cpu", "cuda" (or "gpu"); None keeps it
    platform: Optional[str] = None
    #: host-device count for simulated multi-chip runs (raises, A8)
    host_device_count: Optional[int] = None
    #: multi-host coordinator "host:port" and this process's place (raise, A8)
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

        given = [name for name in _MULTI_DEVICE if getattr(self, name) is not None]
        if given:
            raise NotImplementedError(
                f"RuntimeConfig({', '.join(given)}): the multi-device runtime is not ported yet "
                "(ROADMAP.md A8)"
            )
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
        return self

    def make_mesh(self):
        raise NotImplementedError("RuntimeConfig.make_mesh: the multi-device runtime is not "
                                  "ported yet (ROADMAP.md A8)")
