"""The JAX package's optax optimizers, written out on dicts of tensors.

``cornac_tpu`` trains MF's general-optimizer path and IBPR/COE with
``optax.sgd``, ``adam``, ``rmsprop`` and ``adagrad`` at their defaults. The
port computes the same updates with plain tensor operations, read from
optax's own update rules (``optax/_src/transform.py``: ``scale_by_adam``,
``scale_by_rms``, ``scale_by_rss``; ``alias.py`` for the defaults), not
``torch.optim``'s, which differ:

- adam: b1 0.9, b2 0.999, eps 1e-8 added outside the root (eps_root 0),
  both moments bias-corrected by ``1 - b ** count``;
- adamw: adam's direction plus ``weight_decay * param`` (decoupled, every
  parameter: optax's ``mask=None``), the sum times ``-lr``; ``lr`` may be a
  schedule, a function of the count of earlier updates (a device tensor),
  as optax's ``scale_by_schedule`` reads it (``warmup_cosine_decay_schedule``
  is optax's of that name);
- rmsprop: decay 0.9, eps 1e-8 added inside the root (``rsqrt(nu + eps)``,
  where ``torch.optim.RMSprop`` uses ``sqrt(nu) + eps``), no bias
  correction, initial nu 0, no momentum;
- adagrad: the sum of squares starts at 0.1 (``torch.optim.Adagrad``: 0),
  eps 1e-7 inside the root, and a zero sum gives a zero update;
- sgd: ``-lr * g``;
- adagrad_m (``cornac_tpu/models/seq_utils.py::adagrad_m``, the reference's
  ``IndexedAdagradM`` over dense tables, not an optax alias): the sum of
  squares starts at 0, eps 1e-6 inside the root, and momentum, when set,
  accumulates the scaled step (``mom = momentum * mom - lr * g /
  sqrt(acc + eps)``).

The updates are dense, as optax's are: every entry's moments decay at every
step, whether or not its row was in the minibatch (``torch.optim.SparseAdam``
is another algorithm). The step count is a device tensor, so no step waits
for the host. Adam updates all tensors at once with ``torch._foreach_*``
operations, the same arithmetic in a few launches.

Each maker returns an ``Optimizer(init, update)``: ``init(params)`` gives
the state, ``update(grads, state, params=None)`` gives (updates, new state),
both dicts keyed as ``params`` (only adamw reads ``params``, as optax's
``update`` takes them); ``apply_updates`` adds the updates to the parameters
in place.
"""

import math
from collections import namedtuple

import torch

Optimizer = namedtuple("Optimizer", "init update")


def _count(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _correction(decay, count):
    """``1 - decay ** count``, the power taken in float32 as optax takes
    it, on the count's device (no copy from the host)."""
    return 1 - torch.pow(decay, count.to(torch.float32))


def sgd(learning_rate):
    """``optax.sgd(learning_rate)``: no momentum."""
    def init(params):
        return {}

    def update(grads, state, params=None):
        return {name: g * -learning_rate for name, g in grads.items()}, state

    return Optimizer(init, update)


def _adam_direction(grads, state, b1, b2, eps, eps_root):
    """optax's ``scale_by_adam`` on every tensor at once: (names, the
    bias-corrected directions, the new state)."""
    # torch._foreach_*: a few launches for the whole model, not some twenty
    # per tensor; each operation the one a tensor at a time would do, so
    # the same bits
    count = state["count"] + 1
    names = list(grads)
    g = [grads[n] for n in names]
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                            torch._foreach_mul([state["mu"][n] for n in names], b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                            torch._foreach_mul([state["nu"][n] for n in names], b2))
    m_hat = torch._foreach_div(mu, _correction(b1, count))
    v_hat = torch._foreach_div(nu, _correction(b2, count))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(v_hat, eps_root)), eps)
    return names, torch._foreach_div(m_hat, denom), {
        "count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))}


def _adam_init(params):
    return {"count": _count(params),
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.adam`` at the same defaults."""
    def update(grads, state, params=None):
        names, direction, state = _adam_direction(grads, state, b1, b2, eps, eps_root)
        return dict(zip(names, torch._foreach_mul(direction, -learning_rate))), state

    return Optimizer(_adam_init, update)


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
    """``optax.adamw`` at the same defaults (``mask=None``: every parameter
    decays): ``-lr * (adam's direction + weight_decay * param)``.
    ``learning_rate``: a number, or a schedule called with the number of
    earlier updates (an int32 device tensor) that returns a 0-d float32
    tensor, so no step waits for the host."""
    def update(grads, state, params=None):
        if params is None:
            raise ValueError("adamw needs the parameters to decay them")
        lr = learning_rate(state["count"]) if callable(learning_rate) else learning_rate
        names, direction, state = _adam_direction(grads, state, b1, b2, eps, eps_root)
        decayed = torch._foreach_add(
            direction, torch._foreach_mul([params[n].detach() for n in names], weight_decay))
        return dict(zip(names, torch._foreach_mul(decayed, -lr))), state

    return Optimizer(_adam_init, update)


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps,
                                 end_value=0.0):
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): a linear ramp
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then a
    cosine decay to ``end_value`` at ``decay_steps`` (the warmup included),
    held there after. Called with an int tensor count, it returns a 0-d
    float32 tensor on the count's device, computed in float32 as optax
    computes it. Raises as optax does when no step is left to decay."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = float(decay_steps - warmup_steps)

    def warmup(count):
        if warmup_steps <= 0:  # optax: a constant schedule
            return torch.full_like(count, init_value, dtype=torch.float32)
        frac = 1 - torch.clamp(count, 0, warmup_steps).to(torch.float32) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        t = torch.clamp(count.to(torch.float32), max=cos_steps)
        decay = 0.5 * (1 + torch.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    def schedule(count):
        return torch.where(count < warmup_steps, warmup(count), cosine(count - warmup_steps))

    return schedule


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0):
    """``optax.rmsprop`` at the same defaults (eps inside the root, not
    centred, no momentum, no bias correction)."""
    def init(params):
        return {"nu": {n: torch.full_like(p, initial_scale) for n, p in params.items()}}

    def update(grads, state, params=None):
        nu, updates = {}, {}
        for name, g in grads.items():
            nu[name] = (1 - decay) * (g * g) + decay * state["nu"][name]
            updates[name] = torch.rsqrt(nu[name] + eps) * g * -learning_rate
        return updates, {"nu": nu}

    return Optimizer(init, update)


def adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """``optax.adagrad`` at the same defaults."""
    def init(params):
        return {"sum_of_squares": {n: torch.full_like(p, initial_accumulator_value)
                                   for n, p in params.items()}}

    def update(grads, state, params=None):
        sums, updates = {}, {}
        for name, g in grads.items():
            sums[name] = g * g + state["sum_of_squares"][name]
            scale = torch.where(sums[name] > 0, torch.rsqrt(sums[name] + eps), 0.0)
            updates[name] = scale * g * -learning_rate
        return updates, {"sum_of_squares": sums}

    return Optimizer(init, update)


def adagrad_m(learning_rate, momentum=0.0, eps=1e-6):
    """The sequential models' adagrad with optional momentum (GRU4Rec,
    FPMC's general path)."""
    def init(params):
        state = {"acc": {n: torch.zeros_like(p) for n, p in params.items()}}
        if momentum > 0:
            state["mom"] = {n: torch.zeros_like(p) for n, p in params.items()}
        return state

    def update(grads, state, params=None):
        names = list(grads)
        g = [grads[n] for n in names]
        acc = torch._foreach_add([state["acc"][n] for n in names],
                                 torch._foreach_mul(g, g))
        scaled = torch._foreach_mul(torch._foreach_mul(g, -learning_rate),
                                    torch._foreach_rsqrt(torch._foreach_add(acc, eps)))
        new = {"acc": dict(zip(names, acc))}
        if momentum > 0:
            scaled = torch._foreach_add(
                torch._foreach_mul([state["mom"][n] for n in names], momentum), scaled)
            new["mom"] = dict(zip(names, scaled))
        return dict(zip(names, scaled)), new

    return Optimizer(init, update)


OPTIMIZERS = {"sgd": sgd, "adam": adam, "rmsprop": rmsprop, "adagrad": adagrad}


def make_optimizer(name, learning_rate):
    """The optimizer ``name`` (one of ``OPTIMIZERS``) at ``learning_rate``,
    as ``cornac_tpu/models/mf.py::_make_optimizer`` makes it."""
    if name not in OPTIMIZERS:
        raise ValueError(f"optimizer must be one of {sorted(OPTIMIZERS)}, got {name!r}")
    return OPTIMIZERS[name](learning_rate)


def apply_updates(params, updates):
    """``params[name] += updates[name]`` in place, for every update (one
    ``torch._foreach_add_``)."""
    with torch.no_grad():
        torch._foreach_add_([params[name] for name in updates], list(updates.values()))
    return params


def step(params, opt, state, loss, mesh=None, axis="data", whole=()):
    """One step of ``opt`` on ``loss``: its gradients with respect to every
    tensor of ``params`` (a dict; a tensor the loss does not reach gets
    zeros, as ``jax.grad`` gives it), the optimizer's update, applied in
    place. Returns the new state.

    ``mesh`` (``parallel.make_mesh``): ``loss`` is this rank's share of the
    minibatch's loss (its data slice's terms over the whole minibatch's
    size), the gradients are summed over ``axis`` ("data", or None for
    every rank) and every rank applies the same update to its replica.
    ``whole``: names of ``params`` whose gradients are already the whole
    minibatch's on every rank (``parallel.sharded.slice_rows``), which are
    not summed."""
    grads = list(torch.autograd.grad(loss, list(params.values()), materialize_grads=True))
    if mesh is not None:  # one sum over the ranks for every gradient
        from ..parallel.sharded import sum_grads

        grads = sum_grads(mesh, grads, axis, {j for j, name in enumerate(params) if name in whole})
    updates, state = opt.update(dict(zip(params, grads)), state, params)
    apply_updates(params, updates)
    return state
