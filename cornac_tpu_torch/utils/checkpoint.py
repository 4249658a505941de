"""Checkpointed training: the trainers' epoch loop, mid-training resume and
the port's own checkpoint format.

Port of ``cornac_tpu/utils/checkpoint.py``: ``CheckpointManager``,
``save_pytree``, ``load_pytree`` and ``epoch_loop`` (chunking for the
``verbose`` report, ``max_chunk`` for trainers that must see every epoch's
result on the host, the ``"stop"`` early exit, periodic checkpoints and the
resume branch).

The format is the port's own; the JAX package writes Orbax directories,
which this module does not read (Orbax imports JAX). A checkpoint is one
directory per step, ``<directory>/<step>/state.pt``: a flat dict from a
leaf's path in the state (``"carry/0"``, ``"resident/U"``, ...) to a CPU
tensor, written with ``torch.save`` and read back with
``torch.load(weights_only=True)``. A save writes into a temporary directory
beside the final one and renames it into place, so an interrupted save
leaves no checkpoint behind (only a temporary directory, which the next
manager removes). The newest ``max_to_keep`` steps are kept.

A state is a pytree of tensors, numpy arrays and Python scalars in nested
dicts, lists and tuples (``None`` leaves are kept out of the file).
Restored into a template, every tensor leaf of the template is overwritten
in place (``copy_``), so a trainer that holds its tables, parameters or
optimizer moments in local variables continues from the restored values.

A mesh fit (the JAX package's ``place=``) carries ``DTensor`` leaves: a
save gathers each one whole (a collective, so every rank flattens) and
rank 0 alone writes the file; on resume every rank reads it and copies its
own rows back into its shard.
"""

import os
import shutil

import numpy as np
import torch

from ..parallel.mesh import is_dtensor, on_rank_zero

_STATE_FILE = "state.pt"
_TMP_PREFIX = ".tmp-"


def epoch_generator(seed, epoch, device, *more):
    """A ``torch.Generator`` on ``device`` for one epoch of a fit whose
    draws come from ``seed``, seeded from (seed, global epoch index): the
    stream of any epoch is the same however the host chunks the fit, and a
    resumed fit draws what an uninterrupted one draws. ``more``
    (non-negative ints, e.g. a minibatch index) names a stream within the
    epoch, as the JAX package's ``fold_in`` of the epoch key does."""
    gen = torch.Generator(device=device)
    state = np.random.SeedSequence([seed, epoch, *more]).generate_state(1, np.uint64)[0]
    gen.manual_seed(int(state))
    return gen


# ---------------------------------------------------------------------- #
# pytrees <-> flat dicts of tensors
# ---------------------------------------------------------------------- #
def _children(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _local_rows(template, saved):
    """The part of ``saved`` (a whole tensor) that ``template``, a
    ``DTensor``, holds on this rank: narrowed along each sharded dim by this
    rank's coordinate on the mesh."""
    local = template.to_local()
    for mesh_dim, placement in enumerate(template.placements):
        if placement.is_shard():
            size = local.shape[placement.dim]
            start = template.device_mesh.get_local_rank(mesh_dim) * size
            saved = saved.narrow(placement.dim, start, size)
    return local, saved


def flatten_state(state, prefix=""):
    """Flat ``{path: CPU tensor}`` of a state's leaves (``None`` skipped).
    A ``DTensor`` leaf is gathered whole, a collective over its mesh."""
    kids = _children(state)
    if kids is None:
        if state is None:
            return {}
        if is_dtensor(state):
            return {prefix: state.full_tensor().detach().cpu().clone()}
        if isinstance(state, torch.Tensor):
            return {prefix: state.detach().cpu().clone()}
        return {prefix: torch.as_tensor(np.asarray(state))}
    flat = {}
    for key, child in kids:
        flat.update(flatten_state(child, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def restore_into(template, flat, prefix=""):
    """``template`` with every leaf taken from ``flat`` (``flatten_state``'s
    keys): tensor leaves are overwritten in place and returned as the same
    objects; numpy and Python leaves come back as new values of their
    type. Raises ``KeyError`` when ``flat`` lacks a leaf of the template
    and ``ValueError`` when a tensor's shape differs."""
    kids = _children(template)
    if kids is None:
        if template is None:
            return None
        saved = flat[prefix]
        if is_dtensor(template):
            if saved.shape != template.shape:
                raise ValueError(f"checkpoint leaf {prefix!r} has shape {tuple(saved.shape)}, "
                                 f"the state {tuple(template.shape)}")
            local, saved = _local_rows(template, saved)
            with torch.no_grad():
                local.copy_(saved)
            return template
        if isinstance(template, torch.Tensor):
            if saved.shape != template.shape:
                raise ValueError(f"checkpoint leaf {prefix!r} has shape {tuple(saved.shape)}, "
                                 f"the state {tuple(template.shape)}")
            with torch.no_grad():
                template.copy_(saved)
            return template
        if isinstance(template, np.ndarray):
            return saved.numpy().astype(template.dtype, copy=True)
        return type(template)(saved.item())
    out = [(key, restore_into(child, flat, f"{prefix}/{key}" if prefix else str(key)))
           for key, child in kids]
    if isinstance(template, dict):
        return type(template)(out)
    values = [value for _, value in out]
    if isinstance(template, tuple) and hasattr(template, "_fields"):  # namedtuple
        return type(template)(*values)
    return type(template)(values)


def _write_atomic(final_dir, state):
    """Write ``state`` as ``final_dir/state.pt`` through a temporary
    directory renamed into place; an existing ``final_dir`` is replaced."""
    parent, name = os.path.split(os.path.abspath(final_dir))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"{_TMP_PREFIX}{name}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
            torch.save(flatten_state(state), f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final_dir):
            old = os.path.join(parent, f"{_TMP_PREFIX}old-{name}-{os.getpid()}")
            os.rename(final_dir, old)
            os.rename(tmp, final_dir)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _read(directory, template):
    flat = torch.load(os.path.join(directory, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    return flat if template is None else restore_into(template, flat)


class CheckpointManager:
    """Numbered checkpoints of a training state under ``directory``.

    ``save(step, state)`` writes ``directory/<step>/state.pt`` atomically
    and keeps the newest ``max_to_keep`` steps; ``restore(step, template)``
    gives the flat dict of the step's leaves, or, with a template, the
    template's structure with the saved leaves (tensor leaves overwritten
    in place)."""

    def __init__(self, directory, max_to_keep=3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):  # left by an interrupted save
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def _path(self, step):
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.directory, name, _STATE_FILE)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, state, force=False):
        """Save ``state`` at ``step``. Returns True if written: a step that
        exists already is kept unless ``force``."""
        path = self._path(step)
        if os.path.isdir(path) and not force:
            return False
        _write_atomic(path, state)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._path(old), ignore_errors=True)
        return True

    def restore(self, step, template=None):
        return _read(self._path(step), template)

    def restore_latest(self, template=None):
        """(step, state) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template)

    def close(self):
        """Nothing to release (the JAX package's manager closes Orbax's)."""


def save_pytree(path, state):
    """One checkpoint of ``state`` in the directory ``path`` (replaced if
    it exists), written atomically."""
    _write_atomic(path, state)


def load_pytree(path, template=None):
    """The state ``save_pytree`` wrote to ``path``: a flat dict of CPU
    tensors, or ``template``'s structure with the saved leaves."""
    return _read(path, template)


def epoch_loop(model, total, run_chunk, state, on_report=None, max_chunk=None, resident=None):
    """Run ``total`` epochs of a fit in chunks and return the final state.

    ``run_chunk(state, start_epoch, n_epochs) -> (state, info)`` runs
    ``n_epochs`` epochs; it must derive each epoch's randomness from the
    global epoch index (``epoch_generator``), so that neither the chunking
    nor a resume changes the result. A chunk is every epoch at once, one
    epoch when ``model.verbose`` (then ``on_report(done, info)`` is called
    after each chunk), at most ``max_chunk`` epochs, and at most the
    checkpoint interval. ``info`` may be a dict with a truthy ``"stop"``,
    which ends the fit early.

    ``resident``: tensors that the chunks update in place without carrying
    them in ``state`` (a model's parameters beside its optimizer state).

    With checkpointing on (``Recommender.enable_checkpointing``), the carry
    and ``resident`` are saved every ``every`` epochs, at the end and at an
    early stop; with ``resume``, the newest checkpoint is restored into
    them (in place) and the fit goes on from its epoch. Under
    ``model.mesh`` every rank runs the loop: each save gathers the sharded
    leaves, rank 0 writes and the others wait; each rank restores its rows.
    """
    cfg = getattr(model, "_ckpt_cfg", None)
    mesh = getattr(model, "mesh", None)
    verbose = bool(getattr(model, "verbose", False))
    mgr = None
    done = 0
    if cfg is not None:
        mgr = CheckpointManager(cfg["dir"], max_to_keep=cfg["max_to_keep"])
        if cfg["resume"]:
            step, saved = mgr.restore_latest()
            if step is not None:
                restored = restore_into({"carry": state, "resident": resident}, saved)
                state = restored["carry"]
                done = min(int(step), total)
                if verbose:
                    print("Resumed from checkpoint at epoch %d" % done)

    chunk = 1 if verbose else total
    if mgr is not None:
        chunk = min(chunk, cfg["every"])
    if max_chunk is not None:
        chunk = min(chunk, max_chunk)
    while done < total:
        e = min(chunk, total - done)
        state, info = run_chunk(state, done, e)
        done += e
        stop = isinstance(info, dict) and bool(info.get("stop"))
        if verbose and on_report is not None:
            on_report(done, info)
        if mgr is not None and (done % cfg["every"] == 0 or done == total or stop):
            flat = flatten_state({"carry": state, "resident": resident})
            if mesh is None:
                mgr.save(done, flat, force=True)
            else:
                on_rank_zero(lambda: mgr.save(done, flat, force=True))
        if stop:
            break
    return state
