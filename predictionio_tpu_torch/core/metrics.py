"""Metric base classes for evaluation.

The port's copy of `predictionio_tpu/core/metrics.py` (the reference's
Metric.scala:36 hierarchy): a metric scores the whole evaluation data set
[(evalInfo, [(query, predicted, actual)])] on the host, and `compare`
orders two scores (greater is better; NaN loses to any number).
"""

from __future__ import annotations

import abc
import math
from typing import Generic, List, Optional, Tuple, TypeVar

EI = TypeVar("EI")
Q = TypeVar("Q")
P = TypeVar("P")
A = TypeVar("A")

EvalDataSet = List[Tuple[EI, List[Tuple[Q, P, A]]]]


class Metric(Generic[EI, Q, P, A], abc.ABC):
    """Computes one score over the full evaluation data set; results are
    compared with ``compare`` (default: greater is better)."""

    def header(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def calculate(self, eval_data: EvalDataSet) -> float: ...

    def compare(self, a: float, b: float) -> int:
        if a == b or (math.isnan(a) and math.isnan(b)):
            return 0
        if math.isnan(a):
            return -1
        if math.isnan(b):
            return 1
        return 1 if a > b else -1


def _all_qpa(eval_data: EvalDataSet):
    for _, qpa in eval_data:
        yield from qpa


class AverageMetric(Metric[EI, Q, P, A]):
    """Mean of a per-(Q,P,A) score (Metric.scala AverageMetric)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A) -> float: ...

    def calculate(self, eval_data: EvalDataSet) -> float:
        vals = [self.calculate_one(q, p, a) for q, p, a in _all_qpa(eval_data)]
        return float("nan") if not vals else sum(vals) / len(vals)


class OptionAverageMetric(Metric[EI, Q, P, A]):
    """Mean over the scores that are not None (Metric.scala
    OptionAverageMetric)."""

    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A
                      ) -> Optional[float]: ...

    def calculate(self, eval_data: EvalDataSet) -> float:
        vals = [v for v in (self.calculate_one(q, p, a)
                            for q, p, a in _all_qpa(eval_data))
                if v is not None]
        return float("nan") if not vals else sum(vals) / len(vals)


def _stdev(vals: List[float]) -> float:
    # population stdev, matching Spark StatCounter.stdev
    if not vals:
        return float("nan")
    mean = sum(vals) / len(vals)
    return math.sqrt(sum((v - mean) ** 2 for v in vals) / len(vals))


class StdevMetric(Metric[EI, Q, P, A]):
    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A) -> float: ...

    def calculate(self, eval_data: EvalDataSet) -> float:
        return _stdev([self.calculate_one(q, p, a)
                       for q, p, a in _all_qpa(eval_data)])


class OptionStdevMetric(Metric[EI, Q, P, A]):
    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A
                      ) -> Optional[float]: ...

    def calculate(self, eval_data: EvalDataSet) -> float:
        vals = [v for v in (self.calculate_one(q, p, a)
                            for q, p, a in _all_qpa(eval_data))
                if v is not None]
        return _stdev(vals)


class SumMetric(Metric[EI, Q, P, A]):
    @abc.abstractmethod
    def calculate_one(self, query: Q, predicted: P, actual: A) -> float: ...

    def calculate(self, eval_data: EvalDataSet) -> float:
        return float(sum(self.calculate_one(q, p, a)
                         for q, p, a in _all_qpa(eval_data)))


class ZeroMetric(Metric[EI, Q, P, A]):
    """Always 0 — placeholder when only side-effects matter."""

    def calculate(self, eval_data: EvalDataSet) -> float:
        return 0.0


class QPAMetric(Generic[Q, P, A], abc.ABC):
    """Single-(query, prediction, actual) scoring hook
    (controller/Metric.scala QPAMetric) — compose with the aggregate
    metrics above via their calculate_one."""

    @abc.abstractmethod
    def calculate(self, query: Q, predicted: P, actual: A) -> float: ...
