"""The port's neural building blocks (``cornac_tpu_torch/engine/nn.py``)
against the JAX package's (``cornac_tpu/engine/nn.py``), on the CPU.

- Initial parameters: bit for bit from the same ``get_rng`` seed.
- Activations, ``dense`` and ``mlp``: within rtol 1e-6 / atol 1e-6 on the
  same inputs (float32 products summed in another order).
- ``convert.params_to_module``: a JAX pytree becomes the module the port
  builds, with the same names and the same bits.
- ``ops.optim.step``: one Adam step on a stack's loss against optax, within
  rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import cornac_tpu_torch
from cornac_tpu.engine import nn as jnn
from cornac_tpu.utils import get_rng as j_get_rng
from cornac_tpu_torch.convert import params_to_module
from cornac_tpu_torch.engine import nn as tnn
from cornac_tpu_torch.ops.optim import adam, step
from cornac_tpu_torch.utils import get_rng

cornac_tpu_torch.set_default_device("cpu")

TOL = dict(rtol=1e-6, atol=1e-6)


def flatten(tree, prefix=""):
    """{dotted name: numpy array} of a JAX pytree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}{key}."))
    return out


@pytest.mark.parametrize("name", sorted(jnn.ACTIVATIONS))
def test_activations_match_jax(name):
    x = np.random.RandomState(0).randn(7, 9).astype(np.float32) * 4
    want = np.asarray(jnn.ACTIVATIONS[name](jnp.asarray(x)))
    got = tnn.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("sizes", [[5, 3], [12, 8, 4, 2]])
def test_init_is_bit_identical_and_mlp_matches(sizes):
    theirs = jnn.init_mlp(j_get_rng(3), sizes)
    ours = tnn.init_mlp(get_rng(3), sizes)
    want = flatten(theirs)
    got = {n: p.detach().numpy() for n, p in ours.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    x = np.random.RandomState(1).randn(6, sizes[0]).astype(np.float32)
    for act in ("tanh", "relu"):
        j = jnn.mlp(theirs, jnp.asarray(x), jnn.ACTIVATIONS[act], final_act=jax.nn.sigmoid)
        t = tnn.mlp(ours, torch.from_numpy(x), tnn.ACTIVATIONS[act], final_act=torch.sigmoid)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)
    layer = jnn.init_dense(j_get_rng(4), 5, 2)
    np.testing.assert_allclose(
        tnn.dense(tnn.init_dense(get_rng(4), 5, 2), torch.from_numpy(x[:, :5])).detach().numpy(),
        np.asarray(jnn.dense(layer, jnp.asarray(x[:, :5]))), **TOL)


def test_params_to_module_keeps_names_and_bits():
    rng = j_get_rng(5)
    tree = {"enc": jnn.init_mlp(rng, [6, 4]), "head": jnn.init_dense(rng, 4, 2),
            "emb": jnp.asarray(rng.randn(3, 4).astype(np.float32)),
            "W1": [jnp.asarray(rng.randn(4, 4).astype(np.float32)) for _ in range(2)]}
    module = params_to_module(tree, device="cpu")
    want = flatten(tree)
    got = {n: p.detach().numpy() for n, p in module.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert isinstance(module.head, tnn.Dense) and isinstance(module.enc[0], tnn.Dense)
    with pytest.raises(TypeError):
        params_to_module(3.0, device="cpu")


def test_one_adam_step_on_a_stack_matches_optax():
    sizes, lr = [6, 5, 3], 0.01
    theirs = jnn.init_mlp(j_get_rng(7), sizes)
    ours = tnn.init_mlp(get_rng(7), sizes)
    x = np.random.RandomState(2).randn(8, 6).astype(np.float32)

    def j_loss(p):
        return jnp.sum(jnn.mlp(p, jnp.asarray(x), jnp.tanh) ** 2)

    opt = optax.adam(lr)
    updates, _ = opt.update(jax.grad(j_loss)(theirs), opt.init(theirs), theirs)
    want = flatten(optax.apply_updates(theirs, updates))

    params = dict(ours.named_parameters())
    t_opt = adam(lr)
    state = step(params, t_opt, t_opt.init(params),
                 torch.sum(tnn.mlp(ours, torch.from_numpy(x), torch.tanh) ** 2))
    assert int(state["count"]) == 1
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-5, atol=1e-6, err_msg=n)
