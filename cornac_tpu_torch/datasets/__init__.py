"""Benchmark dataset loaders, read from the cache under ~/.cornac_tpu (nothing is downloaded).

Capability parity with reference ``cornac/datasets`` (18 datasets).
"""

from . import (
    amazon_clothing,
    amazon_digital_music,
    amazon_office,
    amazon_review,
    amazon_toy,
    citeulike,
    cosmetics,
    diginetica,
    epinions,
    filmtrust,
    gowalla,
    movielens,
    netflix,
    retailrocket,
    tafeng,
    tradesy,
    yoochoose,
)

__all__ = [
    "amazon_clothing",
    "amazon_digital_music",
    "amazon_office",
    "amazon_review",
    "amazon_toy",
    "citeulike",
    "cosmetics",
    "diginetica",
    "epinions",
    "filmtrust",
    "gowalla",
    "movielens",
    "netflix",
    "retailrocket",
    "tafeng",
    "tradesy",
    "yoochoose",
]
