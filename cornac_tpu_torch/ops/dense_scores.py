"""Shared device batch scorers, as in ``cornac_tpu/ops/dense_scores.py``.

They feed the eval loop's device path (``Recommender.score_batch_device``):
the scores stay on the device, where the metric program reads them.
"""

import numpy as np
import torch

from .dispatch import full_f32


def _on(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def device_dot(u_rows, V, device):
    """(B, N) float32 scores ``u_rows @ V.T`` on ``device``."""
    with full_f32():
        return _on(u_rows, device) @ _on(V, device).T


def device_neg_l2(u_rows, V, device):
    """(B, N) float32 scores ``-||u - v||`` on ``device``, by the Gram
    expansion (one product, no (B, N, k) difference tensor), as the JAX
    package computes them."""
    u, v = _on(u_rows, device), _on(V, device)
    with full_f32():
        uv = u @ v.T
    sq = (u * u).sum(1)[:, None] + (v * v).sum(1)[None, :] - 2.0 * uv
    return -torch.sqrt(torch.clamp_min(sq, 0.0))


def device_broadcast_row(row, batch, device):
    """(batch, N) float32 scores on ``device``: one shared row for every
    user (popularity and constant scorers), a broadcast view."""
    r = torch.as_tensor(np.asarray(row, np.float32), device=device)
    return r[None, :].expand(batch, r.shape[0])
