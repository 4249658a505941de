"""Rating metrics, a copy of ``cornac_tpu/metrics/rating.py``."""

import numpy as np


class RatingMetric:
    """Base rating metric (lower is better by default)."""

    def __init__(self, name=None, higher_better=False):
        self.type = "rating"
        self.name = name
        self.higher_better = higher_better

    def compute(self, **kwargs):
        raise NotImplementedError()


class MAE(RatingMetric):
    """Mean Absolute Error."""

    def __init__(self):
        RatingMetric.__init__(self, name="MAE")

    def compute(self, gt_ratings, pd_ratings, weights=None, **kwargs):
        return np.average(np.abs(gt_ratings - pd_ratings), axis=0, weights=weights)


class MSE(RatingMetric):
    """Mean Squared Error."""

    def __init__(self):
        RatingMetric.__init__(self, name="MSE")

    def compute(self, gt_ratings, pd_ratings, weights=None, **kwargs):
        return np.average((gt_ratings - pd_ratings) ** 2, axis=0, weights=weights)


class RMSE(RatingMetric):
    """Root Mean Squared Error."""

    def __init__(self):
        RatingMetric.__init__(self, name="RMSE")

    def compute(self, gt_ratings, pd_ratings, weights=None, **kwargs):
        mse = np.average((gt_ratings - pd_ratings) ** 2, axis=0, weights=weights)
        return np.sqrt(mse)
