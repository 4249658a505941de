from .modality import FeatureModality, Modality
from .text import ReviewModality, TextModality
from .image import ImageModality
from .graph import GraphModality
from .sentiment import SentimentModality
from .reader import Reader
from .dataset import BasketDataset, Dataset, PurchaseViewDataset, SequentialDataset

__all__ = [
    "BasketDataset",
    "Dataset",
    "FeatureModality",
    "GraphModality",
    "ImageModality",
    "Modality",
    "PurchaseViewDataset",
    "Reader",
    "ReviewModality",
    "SentimentModality",
    "SequentialDataset",
    "TextModality",
]
