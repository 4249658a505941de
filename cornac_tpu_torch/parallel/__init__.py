"""The multi-device runtime: the process group, the (data, model) mesh and
the sharded primitives (``parallel/mesh.py``, ``parallel/sharded.py``).
Port of ``cornac_tpu/parallel`` on ``torch.distributed``, with the JAX
package's ``__all__``."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    init_distributed,
    make_mesh,
    pad_rows_to_multiple,
    replicate_all,
    shard_batch,
    shard_replicated,
    shard_rows,
    shard_tables,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "init_distributed",
    "make_mesh",
    "pad_rows_to_multiple",
    "replicate_all",
    "shard_batch",
    "shard_replicated",
    "shard_rows",
    "shard_tables",
]
