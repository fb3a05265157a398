"""Evaluation of the port: `Evaluator` and the metrics-only
`evaluate_dataset`."""

from .evaluator import Evaluator, evaluate_dataset

__all__ = ["Evaluator", "evaluate_dataset"]
