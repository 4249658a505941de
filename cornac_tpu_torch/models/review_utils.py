"""Shared machinery of the review models (NARRE, HRDR).

Port of ``cornac_tpu/models/review_utils.py``. Each entity's reviews are
packed once into dense tensors ``(N, R, L)`` (entities x max_num_review x
max_text_length) on the host, so a training step is gathers; the text
processor (a 1 x k convolution, ReLU and a max-pool over the positions) is
the JAX package's window unfold and one product, not ``conv1d``: cuDNN may
pick a non-deterministic algorithm for a convolution's weight gradient, and
a seeded fit must give the same bits on every run. The max-pool is
``amax``, whose gradient splits evenly among tied positions as JAX's does.
The initial weights are the JAX package's numpy draws, in the same order.
"""

import numpy as np
import torch


def build_review_tensors(train_set, max_num_review, max_text_length, by="user"):
    """(reviews (N, R, L) int32, partner ids (N, R) int32, counts (N,)
    int32) of ``train_set``'s review modality grouped ``by`` user or item:
    each entity's first R reviews as token ids, the other side's index of
    each, and how many it has. Byte for byte the JAX package's."""
    mod = train_set.review_text
    group = mod.user_review if by == "user" else mod.item_review
    n = train_set.num_users if by == "user" else train_set.num_items
    R, L = max_num_review, max_text_length
    reviews = np.zeros((n, R, L), dtype=np.int32)
    partner = np.zeros((n, R), dtype=np.int32)
    counts = np.zeros((n,), dtype=np.int32)
    for idx in range(n):
        entries = list(group.get(idx, {}).items())[:R]
        if not entries:
            continue
        reviews[idx, : len(entries)] = np.asarray(
            mod.batch_seq([rid for _, rid in entries], max_length=L), dtype=np.int32)
        partner[idx, : len(entries)] = np.asarray([jdx for jdx, _ in entries], dtype=np.int32)
        counts[idx] = len(entries)
    return reviews, partner, counts


def init_text_cnn(rng, emb_size, kernel_sizes, n_filters):
    """One convolution a kernel size: ``w`` (ks, E, F) uniform in
    +-1/sqrt(ks E) from ``rng``, ``b`` zeros; as a list of dicts of
    float32 arrays."""
    convs = []
    for ks in kernel_sizes:
        bound = 1.0 / np.sqrt(ks * emb_size)
        convs.append({"w": rng.uniform(-bound, bound, size=(ks, emb_size, n_filters))
                      .astype(np.float32), "b": np.zeros((n_filters,), np.float32)})
    return convs


def windows(emb, ks):
    """(..., L, E) -> (..., L - ks + 1, ks, E): the VALID windows of width
    ``ks``, stacked slices as the JAX package builds them."""
    L = emb.shape[-2]
    return torch.stack([emb[..., t: L - ks + 1 + t, :] for t in range(ks)], dim=-2)


def text_cnn(params, prefix, emb, kernel_sizes):
    """emb (..., L, E) -> (..., F x len(kernel_sizes)): for each kernel
    size, the windows times ``params[f"{prefix}.{j}.w"]`` (ks, E, F) plus
    its bias, ReLU, and the maximum over the positions."""
    outs = []
    for j, ks in enumerate(kernel_sizes):
        w = params[f"{prefix}.{j}.w"]
        win = windows(emb, ks)
        # explicit widths: a rank's share of a minibatch may hold no rows
        win = win.reshape(*win.shape[:-2], ks * emb.shape[-1])
        h = win @ w.reshape(-1, w.shape[-1]) + params[f"{prefix}.{j}.b"]
        outs.append(torch.amax(torch.relu(h), dim=-2))
    return torch.cat(outs, dim=-1)


def masked_attention(scores, counts, R):
    """Softmax over the review axis with the empty slots masked out:
    scores (B, R, 1), counts (B,). A masked score is -1e9 and its weight is
    multiplied by 0 after the softmax, so an entity with no review gets no
    weight at all, and an empty slot's gradient is exactly 0."""
    mask = (torch.arange(R, device=counts.device)[None, :] < counts[:, None])[..., None]
    att = torch.softmax(torch.where(mask, scores, -1e9), dim=1)
    return att * mask


def init_dense_np(rng, fan_in, fan_out, bias=True):
    """A layer's ``w`` (fan_in, fan_out) uniform in +-1/sqrt(fan_in) from
    ``rng`` and, with ``bias``, ``b`` zeros; a dict of float32 arrays."""
    bound = 1.0 / np.sqrt(fan_in)
    p = {"w": rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)}
    if bias:
        p["b"] = np.zeros((fan_out,), np.float32)
    return p


def apply_dense(params, prefix, x):
    """``x @ w (+ b)`` of the layer ``prefix`` in the flat ``params``."""
    y = x @ params[prefix + ".w"]
    b = params.get(prefix + ".b")
    return y if b is None else y + b


def flatten(tree, prefix=""):
    """A JAX-style parameter tree (dicts, lists of dicts, arrays) as one
    flat dict {"cnn_u.0.w": array, ...}."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list, tuple)):
            out.update(flatten(value, name + "."))
        else:
            out[name] = value
    return out


def empty_slot_ids(ids, cnt, out_of_range):
    """The ids of a review gather's gradient: ``ids`` (B, R, ...) with every
    slot at or past its entity's count (``cnt`` (B,)) set to
    ``out_of_range``, which ``accumulate_rows`` drops. Such a slot's
    gradient is exactly 0 (``masked_attention``), so the sums keep their
    bits, and the long run of padding ids into row 0 is gone."""
    R = ids.shape[1]
    empty = torch.arange(R, device=ids.device)[None, :] >= cnt[:, None]
    return torch.where(empty.reshape(empty.shape + (1,) * (ids.dim() - 2)), out_of_range, ids)
