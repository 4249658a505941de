from .experiment import Experiment
from .result import CVExperimentResult, CVResult, ExperimentResult, PSTResult, Result

__all__ = ["CVExperimentResult", "CVResult", "Experiment", "ExperimentResult", "PSTResult",
           "Result"]
