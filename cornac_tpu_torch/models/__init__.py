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
from .knn import ItemKNN, UserKNN

__all__ = [
    "ANNMixin",
    "BaseANN",
    "BPR",
    "ItemKNN",
    "MEASURE_COSINE",
    "MEASURE_DOT",
    "MEASURE_L2",
    "Recommender",
    "TPUExactANN",
    "UserKNN",
    "WBPR",
    "is_ann_supported",
]
