"""Recommendation engine template: explicit ALS on ratings.

The port's counterpart of `predictionio_tpu/models/recommendation.py`
(`Rating`, `TrainingData`, `Query`, `PreparedData`,
`RecommendationPreparator`, `ALSAlgorithmParams`, `RecommendationModel`,
`ALSAlgorithm.train/predict/batch_predict` and the engine factory).

The data source takes `RatingsData` arrays through its params; reading
the event store, the filter variants (categories, creationYear, item
properties), fold-in and the pipelined `batch_predict_begin` are later
slices (ROADMAP.md).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.core import (DataSource, Engine, EngineFactory,
                                         EngineParams, FirstServing,
                                         P2LAlgorithm, Params, Preparator,
                                         SanityCheck)
from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.models.common import (ItemScoreResult,
                                                  RatingsData,
                                                  top_scores_to_result)
from predictionio_tpu_torch.ops.als import (ALSConfig, ALSModel, als_train,
                                            recommend_products, users_topk)
from predictionio_tpu_torch.ops.ratings import RatingsCOO, dedup_ratings

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Rating:
    user: str
    item: str
    rating: float
    t: int = 0  # event-time millis (dedup tie-break)


@dataclass
class TrainingData(SanityCheck):
    """`ratings` is columnar; a list of Rating rows is converted."""
    ratings: RatingsData

    def __post_init__(self):
        if isinstance(self.ratings, (list, tuple)):
            self.ratings = RatingsData.from_rows(self.ratings)

    def sanity_check(self):
        if not len(self.ratings):
            raise ValueError("ratings is empty; check the data source")


@dataclass(frozen=True)
class Query:
    user: str
    num: int

    @staticmethod
    def from_dict(d: dict) -> "Query":
        """Raises KeyError for a missing field, ValueError/TypeError for a
        malformed one (the server answers 400 for both)."""
        return Query(user=str(d["user"]), num=int(d["num"]))


@dataclass
class PreparedData:
    ratings_coo: RatingsCOO
    user_ix: EntityIdIxMap
    item_ix: EntityIdIxMap


@dataclass(frozen=True, eq=False)
class DataSourceParams(Params):
    """The training ratings themselves (the event-store read is a later
    slice)."""
    ratings: Optional[RatingsData] = None


class RecommendationDataSource(DataSource):
    def __init__(self, params: Optional[DataSourceParams] = None):
        super().__init__(params or DataSourceParams())

    def read_training(self) -> TrainingData:
        if self.params.ratings is None:
            raise ValueError("DataSourceParams.ratings is not set")
        return TrainingData(self.params.ratings)


@dataclass(frozen=True)
class PreparatorParams(Params):
    dedup: str = "latest"


class RecommendationPreparator(Preparator):
    """Builds the sorted vocabularies and the deduplicated COO."""

    def __init__(self, params: Optional[PreparatorParams] = None):
        super().__init__(params or PreparatorParams())

    def prepare(self, td: TrainingData) -> PreparedData:
        rd = td.ratings
        user_ix, ui = EntityIdIxMap.build_with_indices(rd.users)
        item_ix, ii = EntityIdIxMap.build_with_indices(rd.items)
        ui, ii, vals = dedup_ratings(ui, ii, rd.vals, rd.ts,
                                     self.params.dedup)
        coo = RatingsCOO(ui, ii, vals, len(user_ix), len(item_ix))
        return PreparedData(coo, user_ix, item_ix)


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lam: float = 0.01
    seed: Optional[int] = None
    # products' operand dtype (ops/als.py ALSConfig); None = float32 on
    # the card and on the CPU, the reference's answer off the TPU
    compute_dtype: Optional[str] = None
    sweep_chunk: int = 0           # ALSConfig.sweep_chunk; 0 = auto (1)
    solver: str = "auto"           # ops/solve.py spd_solve
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass
class RecommendationModel:
    als: ALSModel
    user_ix: EntityIdIxMap
    item_ix: EntityIdIxMap


class ALSAlgorithm(P2LAlgorithm):
    """Explicit ALS: train on the device, predict = top-k by u . v."""
    QUERY_CLASS = Query

    def __init__(self, params: Optional[ALSAlgorithmParams] = None):
        super().__init__(params or ALSAlgorithmParams())
        self.last_train_telemetry: dict = {}

    def train(self, pd: PreparedData) -> RecommendationModel:
        p = self.params
        if pd.ratings_coo.nnz == 0:
            raise ValueError("No ratings to train on")
        cfg = ALSConfig(rank=p.rank, iterations=p.num_iterations, lam=p.lam,
                        seed=p.seed if p.seed is not None else 0,
                        solver=p.solver,
                        compute_dtype=p.compute_dtype or "float32",
                        sweep_chunk=p.sweep_chunk)
        self.last_train_telemetry = {}
        model = als_train(pd.ratings_coo, cfg, device=p.device,
                          telemetry=self.last_train_telemetry)
        return RecommendationModel(model, pd.user_ix, pd.item_ix)

    def predict(self, model: RecommendationModel, query: Query
                ) -> ItemScoreResult:
        uix = model.user_ix.get(query.user, -1)
        if uix < 0:
            logger.info("No prediction for unknown user %s.", query.user)
            return ItemScoreResult(())
        scores, idx = recommend_products(model.als, uix, query.num)
        return top_scores_to_result(model.item_ix, scores, idx)

    def batch_predict(self, model: RecommendationModel, queries):
        """One batched top-k for every known user in `queries`."""
        out = {ix: ItemScoreResult(()) for ix, _ in queries}
        known = [(ix, q, model.user_ix.get(q.user, -1)) for ix, q in queries]
        known = [(ix, q, u) for ix, q, u in known if u >= 0]
        if known:
            k_max = max(q.num for _, q, _ in known)
            scores, idx = users_topk(model.als, [u for _, _, u in known],
                                     k_max)
            for row, (ix, q, _) in enumerate(known):
                out[ix] = top_scores_to_result(
                    model.item_ix, scores[row, :q.num], idx[row, :q.num])
        return list(out.items())


class RecommendationEngineFactory(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine({"": RecommendationDataSource},
                      {"": RecommendationPreparator},
                      {"als": ALSAlgorithm},
                      {"": FirstServing})

    @classmethod
    def engine_params(cls, ratings: RatingsData,
                      algorithm: Optional[ALSAlgorithmParams] = None,
                      preparator: Optional[PreparatorParams] = None
                      ) -> EngineParams:
        return EngineParams(
            data_source_params=("", DataSourceParams(ratings)),
            preparator_params=("", preparator or PreparatorParams()),
            algorithm_params_list=[("als",
                                    algorithm or ALSAlgorithmParams())],
            serving_params=("", None))
