"""The trainers' host-side epoch loop.

Port of ``cornac_tpu/utils/checkpoint.py::epoch_loop``: chunking for the
``verbose`` report, ``max_chunk`` for trainers that must see every epoch's
result on the host, and the ``"stop"`` early exit. Checkpointing
(``CheckpointManager``, ``save_pytree``, ``load_pytree``, resume) needs
Orbax in the JAX package and waits for ROADMAP.md A12:
``Recommender.enable_checkpointing`` raises until then.
"""

import numpy as np
import torch


def epoch_generator(seed, epoch, device, *more):
    """A ``torch.Generator`` on ``device`` for one epoch of a fit whose
    draws come from ``seed``, seeded from (seed, global epoch index): the
    stream of any epoch is the same however the host chunks the fit.
    ``more`` (non-negative ints, e.g. a minibatch index) names a stream
    within the epoch, as the JAX package's ``fold_in`` of the epoch key
    does."""
    gen = torch.Generator(device=device)
    state = np.random.SeedSequence([seed, epoch, *more]).generate_state(1, np.uint64)[0]
    gen.manual_seed(int(state))
    return gen


def epoch_loop(model, total, run_chunk, state, on_report=None, max_chunk=None):
    """Run ``total`` epochs of a fit in chunks and return the final state.

    ``run_chunk(state, start_epoch, n_epochs) -> (state, info)`` runs
    ``n_epochs`` epochs; it must derive each epoch's randomness from the
    global epoch index (``epoch_generator``), so that the chunking never
    changes the result. A chunk is every epoch at once, one epoch when
    ``model.verbose`` (then ``on_report(done, info)`` is called after each
    chunk), and at most ``max_chunk`` epochs. ``info`` may be a dict with
    a truthy ``"stop"``, which ends the fit early.
    """
    verbose = bool(getattr(model, "verbose", False))
    chunk = 1 if verbose else total
    if max_chunk is not None:
        chunk = min(chunk, max_chunk)
    done = 0
    while done < total:
        e = min(chunk, total - done)
        state, info = run_chunk(state, done, e)
        done += e
        if verbose and on_report is not None:
            on_report(done, info)
        if isinstance(info, dict) and info.get("stop"):
            break
    return state
