from .base_method import BaseMethod, ranking_eval, rating_eval
from .cross_validation import CrossValidation
from .propensity_stratified_evaluation import PropensityStratifiedEvaluation
from .ratio_split import RatioSplit
from .stratified_split import StratifiedSplit
from .timestamp_split import TimestampSplit

__all__ = [
    "BaseMethod",
    "CrossValidation",
    "PropensityStratifiedEvaluation",
    "RatioSplit",
    "StratifiedSplit",
    "TimestampSplit",
    "ranking_eval",
    "rating_eval",
]
