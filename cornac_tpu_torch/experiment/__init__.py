from .experiment import Experiment
from .result import ExperimentResult, Result

__all__ = ["Experiment", "ExperimentResult", "Result"]
