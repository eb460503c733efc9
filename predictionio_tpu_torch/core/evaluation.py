"""Evaluation and hyperparameter tuning.

The port's copy of `predictionio_tpu/core/evaluation.py` (the reference's
Evaluation.scala:88, EngineParamsGenerator.scala:27, MetricEvaluator.scala
:215 and MetricEvaluatorResult :38-80): run the engine's `batch_eval`
over a list of EngineParams, score each with the primary metric, pick
the best setting (the first of equal scores), and render the one-line,
JSON and HTML results that the evaluation instance stores; with an
output path, write the best setting's engine.json params to `best.json`.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.metrics import Metric

logger = logging.getLogger(__name__)


class EngineParamsGenerator:
    """Provides the list of EngineParams to sweep
    (controller/EngineParamsGenerator.scala:27)."""

    engine_params_list: Sequence[EngineParams] = ()


class Evaluation:
    """Binds an engine to its tuning metric(s)
    (controller/Evaluation.scala:88)."""

    engine: Optional[Engine] = None
    metric: Optional[Metric] = None
    metrics: Sequence[Metric] = ()   # additional informational metrics

    @property
    def evaluator(self) -> "MetricEvaluator":
        if self.metric is None:
            raise ValueError("Evaluation.metric must be set")
        return MetricEvaluator(self.metric, list(self.metrics))


@dataclass(frozen=True)
class MetricScores:
    score: float
    other_scores: Sequence[float]
    engine_params: EngineParams


@dataclass
class MetricEvaluatorResult:
    """(controller/MetricEvaluator.scala:38-80)"""
    best_score: MetricScores
    best_engine_params: EngineParams
    best_idx: int
    metric_header: str
    other_metric_headers: Sequence[str]
    engine_params_scores: List[Tuple[EngineParams, MetricScores]] = field(
        default_factory=list)

    def one_liner(self) -> str:
        return (f"[{self.metric_header}] best: {self.best_score.score:.6f} "
                f"(params set {self.best_idx} of "
                f"{len(self.engine_params_scores)})")

    def to_json(self, engine: Optional[Engine] = None) -> str:
        def ep_json(ep: EngineParams):
            if engine is not None:
                return engine.engine_params_to_json(ep)
            return repr(ep)
        return json.dumps({
            "metric": self.metric_header,
            "otherMetrics": list(self.other_metric_headers),
            "bestScore": self.best_score.score,
            "bestIndex": self.best_idx,
            "bestEngineParams": ep_json(self.best_engine_params),
            "scores": [
                {"engineParams": ep_json(ep), "score": s.score,
                 "otherScores": list(s.other_scores)}
                for ep, s in self.engine_params_scores],
        }, indent=2)

    def to_html(self) -> str:
        rows = "".join(
            f"<tr><td>{i}</td><td>{s.score:.6f}</td>"
            f"<td><pre>{ep}</pre></td></tr>"
            for i, (ep, s) in enumerate(self.engine_params_scores))
        return (f"<html><body><h1>Metric: {self.metric_header}</h1>"
                f"<p>{self.one_liner()}</p>"
                f"<table border=1><tr><th>#</th><th>score</th>"
                f"<th>params</th></tr>{rows}</table></body></html>")


class MetricEvaluator:
    """Scores batch_eval output and picks the best engine params
    (controller/MetricEvaluator.scala:215 evaluateBase)."""

    def __init__(self, metric: Metric,
                 other_metrics: Sequence[Metric] = (),
                 output_path: Optional[str] = None):
        self.metric = metric
        self.other_metrics = list(other_metrics)
        self.output_path = output_path  # best.json target dir

    def evaluate_base(self, engine: Engine,
                      engine_params_list: Sequence[EngineParams]
                      ) -> MetricEvaluatorResult:
        evaluated = engine.batch_eval(engine_params_list)
        scores: List[Tuple[EngineParams, MetricScores]] = []
        for ep, eval_data in evaluated:
            score = self.metric.calculate(eval_data)
            others = [m.calculate(eval_data) for m in self.other_metrics]
            scores.append((ep, MetricScores(score, others, ep)))
            logger.info("Params %s -> %s = %.6f",
                        ep.algorithm_params_list, self.metric.header(), score)
        best_idx = 0
        for i in range(1, len(scores)):
            if self.metric.compare(scores[i][1].score,
                                   scores[best_idx][1].score) > 0:
                best_idx = i
        best_ep, best_score = scores[best_idx]
        result = MetricEvaluatorResult(
            best_score=best_score, best_engine_params=best_ep,
            best_idx=best_idx, metric_header=self.metric.header(),
            other_metric_headers=[m.header() for m in self.other_metrics],
            engine_params_scores=scores)
        if self.output_path:
            os.makedirs(self.output_path, exist_ok=True)
            # best.json lets `pio train` pick up tuned params
            # (MetricEvaluator.scala writes best.json the same way)
            best = engine.engine_params_to_json(best_ep)
            with open(os.path.join(self.output_path, "best.json"), "w") as f:
                json.dump(best, f, indent=2)
        return result
