from .base_method import BaseMethod, ranking_eval, rating_eval
from .cross_validation import CrossValidation
from .next_basket_evaluation import NextBasketEvaluation
from .next_item_evaluation import NextItemEvaluation
from .propensity_stratified_evaluation import PropensityStratifiedEvaluation
from .ratio_split import RatioSplit
from .stratified_split import StratifiedSplit
from .timestamp_split import TimestampSplit

__all__ = [
    "BaseMethod",
    "CrossValidation",
    "NextBasketEvaluation",
    "NextItemEvaluation",
    "PropensityStratifiedEvaluation",
    "RatioSplit",
    "StratifiedSplit",
    "TimestampSplit",
    "ranking_eval",
    "rating_eval",
]
