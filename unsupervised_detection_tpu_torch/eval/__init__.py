"""Evaluation of the port (so far: `Evaluator.infer_metrics`)."""

from .evaluator import Evaluator

__all__ = ["Evaluator"]
