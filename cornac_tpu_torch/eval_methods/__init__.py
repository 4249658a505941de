from .base_method import BaseMethod, ranking_eval, rating_eval

__all__ = ["BaseMethod", "ranking_eval", "rating_eval"]
