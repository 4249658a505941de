from .rating import MAE, MSE, RMSE, RatingMetric
from .ranking import (
    AUC,
    MAP,
    MRR,
    NCRR,
    NDCG,
    FMeasure,
    HitRatio,
    MeasureAtK,
    Precision,
    RankingContext,
    RankingMetric,
    Recall,
)

__all__ = [
    "AUC",
    "FMeasure",
    "HitRatio",
    "MAE",
    "MAP",
    "MeasureAtK",
    "MRR",
    "MSE",
    "NCRR",
    "NDCG",
    "Precision",
    "RankingContext",
    "RankingMetric",
    "RatingMetric",
    "Recall",
    "RMSE",
]
