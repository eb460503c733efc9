"""DASE components, the train pipeline and evaluation."""

from predictionio_tpu_torch.core.base import (Algorithm, AverageServing,
                                              DataSource, EmptyParams,
                                              FirstServing,
                                              IdentityPreparator,
                                              LAlgorithm, P2LAlgorithm,
                                              PAlgorithm, Params,
                                              Preparator, SanityCheck,
                                              Serving)
from predictionio_tpu_torch.core.engine import (Engine, EngineFactory,
                                                EngineParams, SimpleEngine,
                                                TrainResult, WorkflowParams)
from predictionio_tpu_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation,
                                                    MetricEvaluator,
                                                    MetricEvaluatorResult)
from predictionio_tpu_torch.core.fast_eval import FastEvalEngine
from predictionio_tpu_torch.core.params import (params_from_json,
                                                params_to_json)
from predictionio_tpu_torch.core.persistence import (PersistentModel,
                                                     PersistentModelLoader,
                                                     PersistentModelManifest,
                                                     RETRAIN)
from predictionio_tpu_torch.core.metrics import (AverageMetric, Metric,
                                                 OptionAverageMetric,
                                                 OptionStdevMetric,
                                                 QPAMetric, StdevMetric,
                                                 SumMetric, ZeroMetric)

__all__ = ["Algorithm", "AverageMetric", "AverageServing", "DataSource",
           "EmptyParams", "Engine", "EngineFactory", "EngineParams",
           "EngineParamsGenerator", "Evaluation", "FastEvalEngine",
           "FirstServing", "IdentityPreparator", "LAlgorithm", "Metric",
           "MetricEvaluator", "MetricEvaluatorResult", "OptionAverageMetric",
           "OptionStdevMetric", "P2LAlgorithm", "PAlgorithm", "Params",
           "PersistentModel", "PersistentModelLoader",
           "PersistentModelManifest", "Preparator", "QPAMetric", "RETRAIN",
           "SanityCheck", "Serving", "SimpleEngine", "StdevMetric",
           "SumMetric", "TrainResult", "WorkflowParams", "ZeroMetric",
           "params_from_json", "params_to_json"]
