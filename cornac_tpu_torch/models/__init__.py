from .recommender import (
    MEASURE_COSINE,
    MEASURE_DOT,
    MEASURE_L2,
    ANNMixin,
    NextBasketRecommender,
    NextItemRecommender,
    Recommender,
    is_ann_supported,
)
from .ann import BaseANN, TPUExactANN
from .baseline import BaselineOnly, GlobalAvg, MostPop
from .basket import GPTop, TIFUKNN, UPCF
from .beacon import Beacon
from .bivaecf import BiVAECF
from .bpr import BPR, WBPR
from .causalrec import CausalRec
from .c2pf import C2PF
from .cdl import CDL
from .convmf import ConvMF
from .ctr import CTR
from .cvae import CDR, CVAE
from .cvaecf import CVAECF
from .dmrl import DMRL
from .dnntsp import DNNTSP
from .ease import EASE
from .fpmc import FPMC
from .gcmc import GCMC
from .gru4rec import GRU4Rec
from .fm import FM
from .hft import HFT
from .hpf import HPF
from .hrdr import HRDR
from .ibpr import COE, IBPR, OnlineIBPR
from .knn import ItemKNN, UserKNN
from .lightgcn import NGCF, LightGCN
from .mcf import MCF
from .mf import MF, SVD
from .mmmf import MMMF
from .narre import NARRE
from .ncf import GMF, MLP, NCFBase, NeuMF
from .nmf import NMF
from .pcrl import PCRL
from .pmf import PMF
from .recvae import RecVAE
from .sansa import SANSA
from .sasrec import SASRec
from .sbpr import SBPR
from .sorec import SoRec
from .skm import SKMeans
from .spop import SPop
from .tiger import TIGER
from .tiger_configs import (
    GRID_CONFIG,
    PAISCHER_CONFIG,
    PAISCHER_SPORTS_CONFIG,
    PAISCHER_TOYS_CONFIG,
)
from .transformer_rec import BERT4Rec, TransformerRec
from .vaecf import VAECF
from .vmf import VMF
from .vbpr import AMR, VBPR
from .vebpr import VEBPR
from .wmf import WMF

__all__ = [
    "AMR",
    "ANNMixin",
    "BaseANN",
    "BaselineOnly",
    "BERT4Rec",
    "Beacon",
    "BiVAECF",
    "BPR",
    "C2PF",
    "CausalRec",
    "CDL",
    "CDR",
    "COE",
    "ConvMF",
    "CTR",
    "CVAE",
    "CVAECF",
    "DMRL",
    "DNNTSP",
    "EASE",
    "FM",
    "FPMC",
    "GCMC",
    "GlobalAvg",
    "GRID_CONFIG",
    "GMF",
    "GPTop",
    "GRU4Rec",
    "HFT",
    "HPF",
    "HRDR",
    "IBPR",
    "is_ann_supported",
    "ItemKNN",
    "LightGCN",
    "MCF",
    "MEASURE_COSINE",
    "MEASURE_DOT",
    "MEASURE_L2",
    "MF",
    "MLP",
    "MMMF",
    "MostPop",
    "NARRE",
    "NCFBase",
    "NeuMF",
    "NextBasketRecommender",
    "NextItemRecommender",
    "NGCF",
    "NMF",
    "OnlineIBPR",
    "PAISCHER_CONFIG",
    "PAISCHER_SPORTS_CONFIG",
    "PAISCHER_TOYS_CONFIG",
    "PCRL",
    "PMF",
    "Recommender",
    "RecVAE",
    "SANSA",
    "SASRec",
    "SBPR",
    "SKMeans",
    "SoRec",
    "SPop",
    "SVD",
    "TIFUKNN",
    "TIGER",
    "TPUExactANN",
    "TransformerRec",
    "UPCF",
    "UserKNN",
    "VAECF",
    "VBPR",
    "VEBPR",
    "VMF",
    "WBPR",
    "WMF",
]
