"""Exceptions used across the framework.

Capability parity with reference ``cornac/exception.py:16-27``: a scoring
failure (e.g. cold-start user for a model with no fallback) degrades to the
model's ``default_score()`` instead of aborting evaluation.
"""


class CornacException(Exception):
    """Base exception for the framework."""


class ScoreException(CornacException):
    """Raised by ``Recommender.score`` when a score cannot be produced
    (e.g. unknown user/item for a model without a cold-start fallback)."""
