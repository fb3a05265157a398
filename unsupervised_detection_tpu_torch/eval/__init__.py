"""Evaluation of the port: `Evaluator` and `evaluate_dataset` (metrics-only
and dense paths), and the 4-crop `EnsembleEvaluator`."""

from .ensemble import TEST_CROPS, EnsembleEvaluator
from .evaluator import Evaluator, evaluate_dataset

__all__ = ["Evaluator", "evaluate_dataset", "EnsembleEvaluator", "TEST_CROPS"]
