"""Functional env wrappers of the port."""

from .base import APWrapper
from .metrics import ClassificationMetrics, MetricsState, RegressionMetrics
from .pseudo import PseudoActivePerceptionEnv
from .sparsify import Sparsify
from .time_limit import TimeLimit, TimeLimitState
from .vector_to_single import VectorToSingle

__all__ = ["APWrapper", "ClassificationMetrics", "MetricsState", "PseudoActivePerceptionEnv",
           "RegressionMetrics", "Sparsify", "TimeLimit", "TimeLimitState", "VectorToSingle"]
