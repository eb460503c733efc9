"""DASE components, the train pipeline and evaluation."""

from predictionio_tpu_torch.core.base import (Algorithm, DataSource,
                                              EmptyParams, FirstServing,
                                              IdentityPreparator,
                                              LAlgorithm, P2LAlgorithm,
                                              Params, Preparator,
                                              SanityCheck, Serving)
from predictionio_tpu_torch.core.engine import (Engine, EngineFactory,
                                                EngineParams, SimpleEngine,
                                                TrainResult)
from predictionio_tpu_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation,
                                                    MetricEvaluator,
                                                    MetricEvaluatorResult)
from predictionio_tpu_torch.core.fast_eval import FastEvalEngine
from predictionio_tpu_torch.core.metrics import (AverageMetric, Metric,
                                                 OptionAverageMetric,
                                                 OptionStdevMetric,
                                                 QPAMetric, StdevMetric,
                                                 SumMetric, ZeroMetric)

__all__ = ["Algorithm", "AverageMetric", "DataSource", "EmptyParams",
           "Engine", "EngineFactory", "EngineParams",
           "EngineParamsGenerator", "Evaluation", "FastEvalEngine",
           "FirstServing", "IdentityPreparator", "LAlgorithm", "Metric",
           "MetricEvaluator", "MetricEvaluatorResult", "OptionAverageMetric",
           "OptionStdevMetric", "P2LAlgorithm", "Params", "Preparator",
           "QPAMetric", "SanityCheck", "Serving", "SimpleEngine", "StdevMetric",
           "SumMetric",
           "TrainResult", "ZeroMetric"]
