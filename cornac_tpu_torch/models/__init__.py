from .recommender import (
    MEASURE_COSINE,
    MEASURE_DOT,
    MEASURE_L2,
    ANNMixin,
    Recommender,
    is_ann_supported,
)
from .ann import BaseANN, TPUExactANN
from .baseline import BaselineOnly, GlobalAvg, MostPop
from .bpr import BPR, WBPR
from .knn import ItemKNN, UserKNN
from .mf import MF, SVD
from .mmmf import MMMF

__all__ = [
    "ANNMixin",
    "BaseANN",
    "BaselineOnly",
    "BPR",
    "GlobalAvg",
    "ItemKNN",
    "MEASURE_COSINE",
    "MEASURE_DOT",
    "MEASURE_L2",
    "MF",
    "MMMF",
    "MostPop",
    "Recommender",
    "SVD",
    "TPUExactANN",
    "UserKNN",
    "WBPR",
    "is_ann_supported",
]
