"""Step-time metrics and profiler trace hooks.

Port of ``cornac_tpu/utils/profiling.py``: ``StepTimer`` (per-step host
clock with p50/p90/mean) as it is, and the trace hooks over
``torch.profiler`` in place of ``jax.profiler``: ``trace(logdir)`` writes a
Chrome trace (``trace.json``, loadable in Perfetto or TensorBoard's
profiler plugin) of the enclosed region, with the card's kernels when there
is a card; ``annotate(name)`` names a sub-region; ``block_until_ready``
waits for the card, so a ``StepTimer`` around it measures the device work,
not its enqueue.
"""

import contextlib
import json
import time

import numpy as np


class StepTimer:
    """Collects per-step wall-clock durations; summarizes p50/p90/mean.

    Use either as a context manager per step::

        timer = StepTimer("train_step")
        for batch in batches:
            with timer:
                step(batch)
        print(timer.summary())

    or via explicit ``tick()`` calls (duration = gap between ticks).
    """

    def __init__(self, name="step"):
        self.name = name
        self.durations = []
        self._t0 = None
        self._last_tick = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.durations.append(time.perf_counter() - self._t0)
        return False

    def tick(self):
        now = time.perf_counter()
        if self._last_tick is not None:
            self.durations.append(now - self._last_tick)
        self._last_tick = now

    def summary(self):
        if not self.durations:
            return {"name": self.name, "steps": 0}
        d = np.asarray(self.durations)
        return {
            "name": self.name,
            "steps": int(d.size),
            "total_s": float(d.sum()),
            "mean_s": float(d.mean()),
            "p50_s": float(np.percentile(d, 50)),
            "p90_s": float(np.percentile(d, 90)),
            "max_s": float(d.max()),
            "steps_per_s": float(d.size / d.sum()) if d.sum() > 0 else 0.0,
        }

    def dump(self, path):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the enclosed region with ``torch.profiler``.

    With a ``logdir``, writes ``logdir/trace.json`` (a Chrome trace of the
    host's operators and, on a card, its kernels and copies); without one,
    this is a no-op region, so call sites can leave the hook in production
    code and enable it with a flag.
    """
    if logdir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name):
    """Named sub-region inside an active trace (``record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield


def block_until_ready(tree):
    """Wait for the devices of every tensor in ``tree`` (nested dicts,
    lists and tuples), so a ``StepTimer`` measures device time, not the
    enqueue. Returns ``tree``."""
    import torch

    def leaves(node):
        if isinstance(node, dict):
            node = node.values()
        if isinstance(node, (list, tuple, type({}.values()))):
            for child in node:
                yield from leaves(child)
        else:
            yield node

    devices = {leaf.device for leaf in leaves(tree)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree
