"""The process group, the (data, model) device mesh and the sharding helpers.

Port of ``cornac_tpu/parallel/mesh.py`` on ``torch.distributed``. A JAX
mesh is one process over many devices, and GSPMD inserts the collectives.
Here every rank is a process of its own (SPMD): each rank calls ``fit`` and
``evaluate``, and the sharded code paths (``parallel/sharded.py``, the
trainers' ``mesh`` branches) issue the collectives themselves.

The mesh is a 2-D ``torch.distributed.device_mesh.DeviceMesh`` with the
dimension names ("data", "model"): the data axis splits each minibatch and
each evaluation batch, the model axis splits the rows of the embedding
tables. On the card it is a ``"cuda"`` mesh over NCCL, one rank a GPU; in a
process that asked for the CPU (``set_default_device("cpu")`` or
``RuntimeConfig(platform="cpu")``) a ``"cpu"`` mesh over gloo. Nothing falls
back from one to the other.

The helpers return ``DTensor``s placed on the mesh: a table's rows
``Shard(0)`` over "model", a batch ``Shard(0)`` over "data", anything else
``Replicate()``. Every rank holds the same full value when it calls them,
so they cut the local piece without communicating.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..device import default_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _tensor_api():
    """(DTensor, Replicate, Shard), imported when a mesh is first used:
    ``torch.distributed.tensor`` takes seconds to import."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return DTensor, Replicate, Shard


def is_dtensor(x):
    """Whether ``x`` is a ``DTensor``, without importing
    ``torch.distributed.tensor``: none exists before something imported it."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(x, module.DTensor)


def _backend(device):
    return "nccl" if device.type == "cuda" else "gloo"


def _bind_card(rank):
    """Make this rank's GPU the current one: ``LOCAL_RANK`` when a launcher
    set it, else the rank modulo the cards on the host."""
    local = os.environ.get("LOCAL_RANK")
    torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())


def init_distributed(coordinator_address=None, num_processes=None, process_id=None, **kwargs):
    """Join this process to the group of ranks (``torch.distributed``).

    Call once in every process before building a mesh across processes.
    ``coordinator_address`` ("host:port" of rank 0) with ``num_processes``
    and ``process_id`` starts the group at ``tcp://host:port``; without
    them, the environment of ``torchrun`` (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``) does. The backend follows the process's
    device: NCCL on the card (this rank's GPU becomes the current one), gloo
    where the process asked for the CPU. ``kwargs`` go to
    ``init_process_group`` (e.g. ``timeout``, a ``datetime.timedelta``).

    A no-op when the group exists already, and in a single process given
    neither a coordinator nor a launcher's environment, as in the JAX
    package, so it may be called again.
    """
    if dist.is_initialized():
        return
    from_env = all(name in os.environ for name in _TORCHRUN_ENV)
    if coordinator_address is None and not from_env:
        return
    device = default_device()
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed(coordinator_address=...) needs num_processes "
                             "and process_id")
        rank, world = int(process_id), int(num_processes)
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank)
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = dict(init_method="env://")
    if device.type == "cuda":
        _bind_card(rank)
    dist.init_process_group(_backend(device), **init, **kwargs)


def _init_single_process(device):
    """A group of one rank in this process, kept in memory (no port, no
    file): what ``make_mesh`` starts when no group exists."""
    if device.type == "cuda":
        _bind_card(0)
    dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(devices=None, data_parallel=None):
    """Build the (data, model) ``DeviceMesh`` over the ranks of the group.

    ``devices``: the JAX signature's device list; here the global ranks,
    which must be every rank of the group (a mesh spans the whole group,
    laid out as below). ``data_parallel``: the size of the data
    axis (default: every rank, a model axis of 1); it must divide the
    number of ranks, and the model axis takes the rest.

    The ranks fill the (data, model) grid in rank order, row by row. A
    launcher numbers the ranks host by host (host = rank // the ranks of a
    host, ``LOCAL_WORLD_SIZE`` under ``torchrun``), so the data axis crosses
    hosts and, whenever the model axis divides the ranks of a host, each
    model group stays inside one: the row lookups and scatters of the
    sharded tables then never leave a host, and only the data axis's
    gathers do. Rank order is also each group's order, which the sharded
    primitives take as the order of the shards.

    In a process with no group, a group of one rank is started first, so
    ``BPR(mesh=make_mesh())`` works in a single process, as in the JAX
    package.
    """
    init_distributed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the group (0..{world - 1}), got {ranks}")
    n = len(ranks)
    data_parallel = n if data_parallel is None else int(data_parallel)
    if data_parallel < 1 or n % data_parallel != 0:
        raise ValueError(f"data_parallel={data_parallel} must divide device count {n}")
    device = default_device()
    if not dist.is_initialized():
        _init_single_process(device)
    elif dist.get_backend() != _backend(device):
        raise RuntimeError(f"the process group runs {dist.get_backend()}, but a mesh on "
                           f"{device.type} needs {_backend(device)}")
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.arange(n, dtype=torch.int64).reshape(data_parallel, n // data_parallel)
    return DeviceMesh(device.type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def check_mesh(mesh):
    """Raise ``TypeError`` unless ``mesh`` is a ``make_mesh`` mesh: a
    ``DeviceMesh`` with the dimensions ("data", "model")."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS,
                                                                             MODEL_AXIS):
        raise TypeError("mesh must be a DeviceMesh with the dimensions ('data', 'model'), as "
                        f"cornac_tpu_torch.parallel.make_mesh builds; got {mesh!r}")
    return mesh


def axis_size(mesh, axis):
    """Number of ranks along ``axis`` ("data" or "model")."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(mesh):
    """The ``torch.device`` this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def on_rank_zero(fn):
    """Run ``fn()`` on global rank 0 only and return its (picklable) result
    on every rank of the group; the other ranks wait for it. How a mesh fit
    writes a file once."""
    out = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(out, src=0)
    return out[0]


def _placed(mesh, x, placements):
    DTensor, _, Shard = _tensor_api()
    x = torch.as_tensor(x, device=mesh_device(mesh))
    local = x
    for dim, p in enumerate(placements):
        if isinstance(p, Shard):
            parts = mesh.size(dim)
            if x.shape[p.dim] % parts:
                raise ValueError(f"dimension {p.dim} of size {x.shape[p.dim]} does not split "
                                 f"evenly over {parts} ranks")
            size = x.shape[p.dim] // parts
            local = local.narrow(p.dim, mesh.get_local_rank(dim) * size, size)
    return DTensor.from_local(local.clone(), mesh, placements, run_check=False)


def shard_rows(mesh, x):
    """Shard a parameter table's leading (row) dim over the model axis."""
    _, Replicate, Shard = _tensor_api()
    return _placed(mesh, x, [Replicate(), Shard(0)])


def shard_batch(mesh, x):
    """Shard a batch's leading dim over the data axis."""
    _, Replicate, Shard = _tensor_api()
    return _placed(mesh, x, [Shard(0), Replicate()])


def shard_replicated(mesh, x):
    """Replicate an array across the whole mesh."""
    _, Replicate, _ = _tensor_api()
    return _placed(mesh, x, [Replicate(), Replicate()])


def pad_rows_to_multiple(x, multiple):
    """Pad a table's row count with zero rows so it divides evenly across
    shards (numpy in, numpy out; a tensor stays a tensor on its device)."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def shard_tables(mesh, *tables):
    """Row-shard parameter tables over the model axis, padding each row
    count to the shard count. Padded rows are inert (training ids never
    reference them) and callers slice ``[:n]`` when pulling results back.
    ``None`` entries pass through. One table in, one table out (no tuple).
    """
    shards = axis_size(mesh, MODEL_AXIS)
    out = tuple(None if t is None else shard_rows(mesh, pad_rows_to_multiple(t, shards))
                for t in tables)
    return out[0] if len(out) == 1 else out


def _map_leaves(fn, value):
    if isinstance(value, dict):
        return type(value)((k, _map_leaves(fn, v)) for k, v in value.items())
    if isinstance(value, (list, tuple)):
        return type(value)(_map_leaves(fn, v) for v in value)
    return None if value is None else fn(value)


def replicate_all(mesh, *values):
    """Replicate arrays (or dicts, lists and tuples of them) across the
    whole mesh. ``None`` entries pass through; one value in, one value out."""
    out = tuple(_map_leaves(lambda a: shard_replicated(mesh, a), v) for v in values)
    return out[0] if len(out) == 1 else out
