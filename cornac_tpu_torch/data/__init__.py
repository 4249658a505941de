from .dataset import Dataset
from .reader import Reader

__all__ = ["Dataset", "Reader"]
