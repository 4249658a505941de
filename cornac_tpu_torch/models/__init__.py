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
from .bivaecf import BiVAECF
from .bpr import BPR, WBPR
from .ease import EASE
from .fm import FM
from .hpf import HPF
from .ibpr import COE, IBPR, OnlineIBPR
from .knn import ItemKNN, UserKNN
from .lightgcn import NGCF, LightGCN
from .mf import MF, SVD
from .mmmf import MMMF
from .ncf import GMF, MLP, NCFBase, NeuMF
from .nmf import NMF
from .pmf import PMF
from .recvae import RecVAE
from .sansa import SANSA
from .skm import SKMeans
from .vaecf import VAECF
from .wmf import WMF

__all__ = [
    "ANNMixin",
    "BaseANN",
    "BaselineOnly",
    "BiVAECF",
    "BPR",
    "COE",
    "EASE",
    "FM",
    "GlobalAvg",
    "GMF",
    "HPF",
    "IBPR",
    "is_ann_supported",
    "ItemKNN",
    "LightGCN",
    "MEASURE_COSINE",
    "MEASURE_DOT",
    "MEASURE_L2",
    "MF",
    "MLP",
    "MMMF",
    "MostPop",
    "NCFBase",
    "NeuMF",
    "NGCF",
    "NMF",
    "OnlineIBPR",
    "PMF",
    "Recommender",
    "RecVAE",
    "SANSA",
    "SKMeans",
    "SVD",
    "TPUExactANN",
    "UserKNN",
    "VAECF",
    "WBPR",
    "WMF",
]
