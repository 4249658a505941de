from .base_method import BaseMethod, ranking_eval, rating_eval
from .ratio_split import RatioSplit

__all__ = ["BaseMethod", "RatioSplit", "ranking_eval", "rating_eval"]
