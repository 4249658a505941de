"""Shared device batch scorers, as in ``cornac_tpu/ops/dense_scores.py``.

They feed the eval loop's device path (``Recommender.score_batch_device``):
the scores stay on the device, where the metric program reads them. The
other scorers of the JAX module come with the models that use them.
"""

import numpy as np
import torch


def device_broadcast_row(row, batch, device):
    """(batch, N) float32 scores on ``device``: one shared row for every
    user (popularity and constant scorers), a broadcast view."""
    r = torch.as_tensor(np.asarray(row, np.float32), device=device)
    return r[None, :].expand(batch, r.shape[0])
