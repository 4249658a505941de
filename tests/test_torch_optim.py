"""The port's optimizers against optax, on the CPU: five steps on the same
gradients (made with numpy, some entries exactly zero, as a row that was
not in the minibatch has) from the same parameters give the same
parameters and state within rtol 1e-6 / atol 1e-7 (float32 arithmetic in
another order of a few operations)."""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from cornac_tpu_torch.ops import optim

TOL = dict(rtol=1e-6, atol=1e-7)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    params = {"U": rng.randn(13, 4).astype(np.float32), "b": rng.randn(9).astype(np.float32)}
    grads = []
    for _ in range(5):
        g = {n: (rng.randn(*p.shape) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
             for n, p in params.items()}
        g["U"][rng.rand(13) < 0.4] = 0.0  # rows outside the minibatch
        grads.append(g)
    return params, grads


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adagrad"])
@pytest.mark.parametrize("lr", [0.001, 0.05])
def test_five_steps_match_optax(name, lr):
    params, grads = _inputs()
    ref = getattr(optax, name)(lr)
    j_params = {n: jnp.asarray(p) for n, p in params.items()}
    j_state = ref.init(j_params)
    ours = optim.make_optimizer(name, lr)
    t_params = {n: torch.tensor(p) for n, p in params.items()}
    t_state = ours.init(t_params)
    for g in grads:
        updates, j_state = ref.update({n: jnp.asarray(v) for n, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_updates, t_state = ours.update({n: torch.tensor(v) for n, v in g.items()}, t_state)
        optim.apply_updates(t_params, t_updates)
        for n in params:
            np.testing.assert_allclose(t_params[n].numpy(), np.asarray(j_params[n]), **TOL)
    # the state too: adam's moments and count, rmsprop's nu, adagrad's sums
    j_leaves = [np.asarray(x) for x in __import__("jax").tree_util.tree_leaves(j_state)]
    t_leaves = [x.numpy() for x in _leaves(t_state)]
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(sorted(t_leaves, key=_key), sorted(j_leaves, key=_key)):
        np.testing.assert_allclose(a, b, **TOL)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in _leaves(tree[key])]
    return [tree]


def _key(a):
    return (a.shape, float(np.abs(a).sum()))


def test_dense_updates_move_rows_outside_the_batch():
    # optax's update is dense: a row with a zero gradient keeps moving on
    # its first moment, and its second moment decays
    opt = optim.adam(0.1)
    p = {"U": torch.zeros(2, 3)}
    state = opt.init(p)
    _, state = opt.update({"U": torch.tensor([[1.0, 1, 1], [1, 1, 1]])}, state)
    updates, state = opt.update({"U": torch.tensor([[1.0, 1, 1], [0, 0, 0]])}, state)
    assert (updates["U"][1] != 0).all() and int(state["count"]) == 2
    np.testing.assert_allclose(state["nu"]["U"][1].numpy(), 0.999 * 0.001, rtol=1e-6)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="optimizer"):
        optim.make_optimizer("lbfgs", 0.1)
