from .common import (
    clip,
    estimate_batches,
    excepts,
    get_rng,
    intersects,
    normalize,
    safe_indexing,
    scale,
    sigmoid,
    validate_format,
)

__all__ = [
    "clip",
    "estimate_batches",
    "excepts",
    "get_rng",
    "intersects",
    "normalize",
    "safe_indexing",
    "scale",
    "sigmoid",
    "validate_format",
]
