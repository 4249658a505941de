"""The JAX package's optax optimizers, written out on dicts of tensors.

``cornac_tpu`` trains MF's general-optimizer path and IBPR/COE with
``optax.sgd``, ``adam``, ``rmsprop`` and ``adagrad`` at their defaults. The
port computes the same updates with plain tensor operations, read from
optax's own update rules (``optax/_src/transform.py``: ``scale_by_adam``,
``scale_by_rms``, ``scale_by_rss``; ``alias.py`` for the defaults), not
``torch.optim``'s, which differ:

- adam: b1 0.9, b2 0.999, eps 1e-8 added outside the root (eps_root 0),
  both moments bias-corrected by ``1 - b ** count``;
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
the state, ``update(grads, state)`` gives (updates, new state), both dicts
keyed as ``params``; ``apply_updates`` adds the updates to the parameters
in place.
"""

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

    def update(grads, state):
        return {name: g * -learning_rate for name, g in grads.items()}, state

    return Optimizer(init, update)


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0):
    """``optax.adam`` at the same defaults."""
    def init(params):
        return {"count": _count(params),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads, state):
        # every tensor at once (torch._foreach_*: a few launches for the
        # whole model, not some twenty per tensor), each operation the one
        # a tensor at a time would do, so the same bits
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
        updates = torch._foreach_mul(torch._foreach_div(m_hat, denom), -learning_rate)
        return dict(zip(names, updates)), {"count": count, "mu": dict(zip(names, mu)),
                                           "nu": dict(zip(names, nu))}

    return Optimizer(init, update)


def rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0):
    """``optax.rmsprop`` at the same defaults (eps inside the root, not
    centred, no momentum, no bias correction)."""
    def init(params):
        return {"nu": {n: torch.full_like(p, initial_scale) for n, p in params.items()}}

    def update(grads, state):
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

    def update(grads, state):
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

    def update(grads, state):
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


def step(params, opt, state, loss):
    """One step of ``opt`` on ``loss``: its gradients with respect to every
    tensor of ``params`` (a dict; a tensor the loss does not reach gets
    zeros, as ``jax.grad`` gives it), the optimizer's update, applied in
    place. Returns the new state."""
    grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
    updates, state = opt.update(dict(zip(params, grads)), state)
    apply_updates(params, updates)
    return state
