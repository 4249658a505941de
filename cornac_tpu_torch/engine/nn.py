"""Linear layers and stacks of them, as ``nn.Module``s.

Port of ``cornac_tpu/engine/nn.py:1-70``: the neural family (VAECF, RecVAE,
BiVAECF, NCF) builds its towers from these. A layer keeps the JAX package's
layout, ``w`` (fan_in, fan_out) and ``b`` (fan_out,), and computes
``x @ w + b``; its initial values are the same numpy draws, in the same
order, from the same ``RandomState`` (torch's ``nn.Linear`` default,
U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for both), so a seeded layer starts
bit for bit where the JAX layer does. Parameter names follow the JAX
package's pytrees (``encoder.0.w`` is ``params["encoder"][0]["w"]``), which
``convert.params_to_module`` relies on. The transformer blocks wait for
ROADMAP.md A10.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": F.leaky_relu,  # slope 0.01, as jax.nn.leaky_relu's default
    "leaky": F.leaky_relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "none": lambda x: x,
}


class Dense(nn.Module):
    """One linear layer: ``x @ w + b``."""

    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = _parameter(w), _parameter(b)

    def forward(self, x):
        return x @ self.w + self.b


def init_dense(rng, fan_in, fan_out):
    """One linear layer, torch-default initialization from ``rng`` (W's
    draws, then b's), on the CPU."""
    bound = 1.0 / np.sqrt(fan_in)
    w = rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, size=(fan_out,)).astype(np.float32)
    return Dense(w, b)


def dense(layer, x):
    return layer(x)


def init_mlp(rng, sizes):
    """Stack of linear layers, sizes = [in, h1, h2, ...], initialized in
    order."""
    return nn.ModuleList(init_dense(rng, sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1))


def mlp(layers, x, act, final_act=None):
    """Apply the stack: ``act`` between layers, ``final_act`` after the
    last (None: a linear head)."""
    n = len(layers)
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


class Tree(nn.Module):
    """A JAX package's parameter pytree as a module: each keyword becomes a
    child of that name, a module as it is, a list of arrays a
    ``ParameterList``, an array a parameter (float32)."""

    def __init__(self, **children):
        super().__init__()
        for name, value in children.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ParameterList(_parameter(v) for v in value))
            else:
                self.register_parameter(name, _parameter(value))


def _parameter(value):
    """A float32 parameter holding a copy of ``value`` (array or tensor)."""
    if isinstance(value, torch.Tensor):
        return nn.Parameter(value.detach().to(torch.float32).clone())
    return nn.Parameter(torch.as_tensor(np.asarray(value, np.float32)))
