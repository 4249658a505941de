"""Device operations: the hand-written CUDA kernels and their wrappers, and
the graph propagation built on them."""

from .accumulate import accumulate_rows, gather_rows
from .graph import DENSE_ADJ_BUDGET, NormAdjacency, build_norm_edges, lightgcn_embeddings, propagate

__all__ = [
    "DENSE_ADJ_BUDGET",
    "NormAdjacency",
    "accumulate_rows",
    "build_norm_edges",
    "gather_rows",
    "lightgcn_embeddings",
    "propagate",
]
