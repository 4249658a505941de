from .recommender import (
    MEASURE_COSINE,
    MEASURE_DOT,
    MEASURE_L2,
    ANNMixin,
    NextItemRecommender,
    Recommender,
    is_ann_supported,
)
from .ann import BaseANN, TPUExactANN
from .baseline import BaselineOnly, GlobalAvg, MostPop
from .bivaecf import BiVAECF
from .bpr import BPR, WBPR
from .c2pf import C2PF
from .cvaecf import CVAECF
from .ease import EASE
from .fpmc import FPMC
from .gcmc import GCMC
from .gru4rec import GRU4Rec
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
from .sasrec import SASRec
from .sbpr import SBPR
from .skm import SKMeans
from .spop import SPop
from .vaecf import VAECF
from .vebpr import VEBPR
from .wmf import WMF

__all__ = [
    "ANNMixin",
    "BaseANN",
    "BaselineOnly",
    "BiVAECF",
    "BPR",
    "C2PF",
    "COE",
    "CVAECF",
    "EASE",
    "FM",
    "FPMC",
    "GCMC",
    "GlobalAvg",
    "GMF",
    "GRU4Rec",
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
    "NextItemRecommender",
    "NGCF",
    "NMF",
    "OnlineIBPR",
    "PMF",
    "Recommender",
    "RecVAE",
    "SANSA",
    "SASRec",
    "SBPR",
    "SKMeans",
    "SPop",
    "SVD",
    "TPUExactANN",
    "UserKNN",
    "VAECF",
    "VEBPR",
    "WBPR",
    "WMF",
]
