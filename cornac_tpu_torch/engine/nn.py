"""Linear layers and stacks of them, as ``nn.Module``s.

Port of ``cornac_tpu/engine/nn.py``: the neural family (VAECF, RecVAE,
BiVAECF, NCF, CVAECF) builds its towers from these, and the sequential
models (SASRec) their transformer blocks. A layer keeps the JAX package's
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


# ---------------------------------------------------------------------- #
# transformer building blocks (SASRec; BERT4Rec, TransformerRec and TIGER
# share them in the JAX package)
# ---------------------------------------------------------------------- #
def layer_norm(x, g, b, eps=1e-8):
    """``(x - mean) * rsqrt(var + eps) * g + b`` over the last axis, the
    variance biased (``jnp.var``), eps 1e-8 (``nn.LayerNorm``'s is 1e-5)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def make_drop(dropout, generator):
    """Inverted-dropout closure ``drop(x, i)``: keeps each entry with
    probability ``1 - dropout`` (draws from ``generator``, in call order)
    and scales by its inverse; the identity when the rate is 0 or no
    generator is given (inference). ``i`` names the call site, as the JAX
    package folds it into its key; here the generator's order of calls,
    fixed by the model, separates the sites."""

    def drop(x, i):
        if dropout <= 0.0 or generator is None:
            return x
        keep = 1.0 - dropout
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return x * mask / keep

    return drop


def init_transformer_block(xav, d, ffn_mult=1):
    """A pre-LN block's parameters as a ``Tree``, drawn in the JAX
    package's order: ``xav(shape)`` (the model's xavier draw from its numpy
    ``RandomState``) for Wq, Wk, Wv, Wo, ff1, ff2; ones and zeros for the
    norms and biases."""
    return Tree(
        Wq=xav((d, d)),
        Wk=xav((d, d)),
        Wv=xav((d, d)),
        Wo=xav((d, d)),
        ln1_g=np.ones(d, np.float32),
        ln1_b=np.zeros(d, np.float32),
        ff1=xav((d, ffn_mult * d)),
        ff1_b=np.zeros(ffn_mult * d, np.float32),
        ff2=xav((ffn_mult * d, d)),
        ff2_b=np.zeros(d, np.float32),
        ln2_g=np.ones(d, np.float32),
        ln2_b=np.zeros(d, np.float32),
    )


def block_attention(blk, q_in, kv_in, attn_mask, n_heads, drop, di):
    """One multi-head attention sub-layer: queries from ``q_in``, keys and
    values from ``kv_in``; ``attn_mask`` (B, Lq, Lk) bool. Masked logits
    are -1e9, so a fully masked query row softmaxes to uniform weights."""
    B, L, d = kv_in.shape
    head_dim = d // n_heads
    Q = (q_in @ blk.Wq).reshape(B, -1, n_heads, head_dim)
    K = (kv_in @ blk.Wk).reshape(B, L, n_heads, head_dim)
    V = (kv_in @ blk.Wv).reshape(B, L, n_heads, head_dim)
    logits = torch.einsum("blhd,bmhd->bhlm", Q, K) / float(np.sqrt(head_dim))
    logits = torch.where(attn_mask[:, None, :, :], logits, -1e9)
    attn = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhlm,bmhd->blhd", attn, V).reshape(B, -1, d)
    return drop(ctx @ blk.Wo, di)


def block_ffn(blk, h, drop, di, act=ACTIVATIONS["gelu"]):
    """Pre-LN feed-forward sub-layer; ``act`` defaults to the tanh GELU
    (``jax.nn.gelu``'s default)."""
    f = layer_norm(h, blk.ln2_g, blk.ln2_b)
    f = act(f @ blk.ff1 + blk.ff1_b)
    return drop(f @ blk.ff2 + blk.ff2_b, di)


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
