"""Classification engine template: naive Bayes or a random forest over
aggregated user properties.

The port's counterpart of `predictionio_tpu/models/classification.py`
(the reference's scala-parallel-classification: MLlib NaiveBayes on the
`$set`-aggregated user properties attr0/attr1/attr2 with the label
`plan`, and the add-algorithm variant's RandomForest). Both algorithms
train on the device (`ops/naive_bayes.py`, `ops/forest.py`) and predict
on the host, as the reference's P2L models do. With `eval_k` set, the
data source splits the points into k folds (`core/cross_validation.py`)
for `Accuracy`, the template's metric.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core import (AverageMetric, DataSource, Engine,
                                         EngineFactory, EngineParams,
                                         FirstServing, P2LAlgorithm, Params,
                                         Preparator, SanityCheck)
from predictionio_tpu_torch.core.cross_validation import split_data
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.ops.forest import ForestModel, forest_train
from predictionio_tpu_torch.ops.naive_bayes import (MultinomialNBModel,
                                                    multinomial_nb_train)

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class LabeledPoint:
    label: float
    features: Tuple[float, ...]


@dataclass
class TrainingData(SanityCheck):
    labeled_points: List[LabeledPoint]

    def sanity_check(self):
        if not self.labeled_points:
            raise ValueError("labeled_points is empty; check the data source")


@dataclass(frozen=True)
class Query:
    attr0: float
    attr1: float
    attr2: float

    @staticmethod
    def from_dict(d: dict) -> "Query":
        return Query(attr0=float(d["attr0"]), attr1=float(d["attr1"]),
                     attr2=float(d["attr2"]))

    @property
    def features(self) -> np.ndarray:
        return np.array([self.attr0, self.attr1, self.attr2],
                        dtype=np.float32)


@dataclass(frozen=True)
class PredictedResult:
    label: float

    def to_dict(self):
        return {"label": self.label}


@dataclass(frozen=True)
class ActualResult:
    label: float


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None
    eval_k: Optional[int] = None  # k-fold read_eval when set


class ClassificationDataSource(DataSource):
    PARAMS_CLASS = DataSourceParams

    def __init__(self, params: Optional[DataSourceParams] = None):
        super().__init__(params or DataSourceParams())

    def _read_points(self) -> List[LabeledPoint]:
        props = PEventStore.aggregate_properties(
            app_name=self.params.app_name,
            channel_name=self.params.channel_name, entity_type="user",
            required=["plan", "attr0", "attr1", "attr2"])
        points = []
        for entity_id, pm in props.items():
            try:
                points.append(LabeledPoint(
                    label=pm.get("plan", float),
                    features=(pm.get("attr0", float), pm.get("attr1", float),
                              pm.get("attr2", float))))
            except Exception as e:
                logger.error("Cannot convert %s to LabeledPoint: %s",
                             entity_id, e)
                raise
        return points

    def read_training(self) -> TrainingData:
        return TrainingData(self._read_points())

    def read_eval(self):
        if not self.params.eval_k:
            return []
        return split_data(
            self.params.eval_k, self._read_points(), None,
            training_data_creator=TrainingData,
            query_creator=lambda p: Query(*p.features),
            actual_creator=lambda p: ActualResult(p.label))


class ClassificationPreparator(Preparator):
    def prepare(self, td: TrainingData) -> TrainingData:
        return td


def _points_xy(td: TrainingData):
    X = np.array([p.features for p in td.labeled_points], dtype=np.float32)
    y = np.array([p.label for p in td.labeled_points], dtype=np.float64)
    return X, y


@dataclass(frozen=True)
class NaiveBayesAlgorithmParams(Params):
    lam: float = 1.0  # MLlib's lambda smoothing
    device: Optional[str] = None   # None = the card; "cpu" only if asked


class NaiveBayesAlgorithm(P2LAlgorithm):
    """Multinomial naive Bayes (NaiveBayesAlgorithm.scala:19-25)."""
    PARAMS_CLASS = NaiveBayesAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[NaiveBayesAlgorithmParams] = None):
        super().__init__(params or NaiveBayesAlgorithmParams())
        self.last_train_telemetry: dict = {}

    def train(self, td: TrainingData) -> MultinomialNBModel:
        X, y = _points_xy(td)
        t0 = time.perf_counter()
        model = multinomial_nb_train(X, y, lam=self.params.lam,
                                     device=self.params.device)
        self.last_train_telemetry = {"points": len(y),
                                     "train_s": time.perf_counter() - t0}
        return model

    def predict(self, model: MultinomialNBModel, query: Query
                ) -> PredictedResult:
        return PredictedResult(label=model.predict(query.features))

    def batch_predict(self, model: MultinomialNBModel, queries):
        if not queries:
            return []
        X = np.stack([q.features for _, q in queries])
        scores = model.pi[None, :] + X.astype(np.float64) @ model.theta.T
        labels = model.labels[np.argmax(scores, axis=1)]
        return [(ix, PredictedResult(label=float(lab)))
                for (ix, _), lab in zip(queries, labels)]


@dataclass(frozen=True)
class RandomForestAlgorithmParams(Params):
    """Knob for knob the add-algorithm variant's params
    (RandomForestAlgorithm.scala:12-19)."""
    num_classes: int = 4
    num_trees: int = 10
    feature_subset_strategy: str = "auto"
    impurity: str = "gini"
    max_depth: int = 5
    max_bins: int = 32
    seed: int = 42
    device: Optional[str] = None   # None = the card; "cpu" only if asked


class RandomForestAlgorithm(P2LAlgorithm):
    """The add-algorithm variant (RandomForestAlgorithm.scala:23-52):
    grown on the device by `ops/forest.forest_train`, voted on the
    host."""
    PARAMS_CLASS = RandomForestAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[RandomForestAlgorithmParams] = None):
        super().__init__(params or RandomForestAlgorithmParams())
        self.last_train_telemetry: dict = {}

    def train(self, td: TrainingData) -> ForestModel:
        X, y = _points_xy(td)
        p = self.params
        t0 = time.perf_counter()
        model = forest_train(
            X, y, num_classes=p.num_classes, num_trees=p.num_trees,
            feature_subset_strategy=p.feature_subset_strategy,
            impurity=p.impurity, max_depth=p.max_depth,
            max_bins=p.max_bins, seed=p.seed, device=p.device)
        self.last_train_telemetry = {"points": len(y),
                                     "train_s": time.perf_counter() - t0}
        return model

    def predict(self, model: ForestModel, query: Query) -> PredictedResult:
        return PredictedResult(label=model.predict(query.features))

    def batch_predict(self, model: ForestModel, queries):
        if not queries:
            return []
        X = np.stack([q.features for _, q in queries]).astype(np.float32)
        labels = model.predict_batch(X)
        return [(ix, PredictedResult(label=float(lab)))
                for (ix, _), lab in zip(queries, labels)]


class Accuracy(AverageMetric):
    """The share of answers whose label is the actual one."""

    def calculate_one(self, query, predicted, actual) -> float:
        return 1.0 if predicted.label == actual.label else 0.0


class ClassificationEngineFactory(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine(
            {"": ClassificationDataSource},
            {"": ClassificationPreparator},
            {"naive": NaiveBayesAlgorithm,
             "randomforest": RandomForestAlgorithm},
            {"": FirstServing})

    @classmethod
    def engine_params(cls, key: str = "") -> EngineParams:
        return EngineParams(
            data_source_params=("", DataSourceParams()),
            preparator_params=("", None),
            algorithm_params_list=[("naive", NaiveBayesAlgorithmParams())],
            serving_params=("", None))
