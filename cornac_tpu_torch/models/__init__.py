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
from .ease import EASE
from .ibpr import COE, IBPR, OnlineIBPR
from .knn import ItemKNN, UserKNN
from .mf import MF, SVD
from .mmmf import MMMF
from .nmf import NMF
from .pmf import PMF
from .wmf import WMF

__all__ = [
    "ANNMixin",
    "BaseANN",
    "BaselineOnly",
    "BPR",
    "COE",
    "EASE",
    "GlobalAvg",
    "IBPR",
    "ItemKNN",
    "MEASURE_COSINE",
    "MEASURE_DOT",
    "MEASURE_L2",
    "MF",
    "MMMF",
    "MostPop",
    "NMF",
    "OnlineIBPR",
    "PMF",
    "Recommender",
    "SVD",
    "TPUExactANN",
    "UserKNN",
    "WBPR",
    "WMF",
    "is_ann_supported",
]
