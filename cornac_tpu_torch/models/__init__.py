from .recommender import (
    MEASURE_COSINE,
    MEASURE_DOT,
    MEASURE_L2,
    ANNMixin,
    Recommender,
    is_ann_supported,
)
from .ann import BaseANN, TPUExactANN
from .bpr import BPR, WBPR

__all__ = [
    "ANNMixin",
    "BaseANN",
    "BPR",
    "MEASURE_COSINE",
    "MEASURE_DOT",
    "MEASURE_L2",
    "Recommender",
    "TPUExactANN",
    "WBPR",
    "is_ann_supported",
]
