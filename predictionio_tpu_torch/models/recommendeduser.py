"""Recommended-user engine template: implicit ALS over follow events.

The port's counterpart of `predictionio_tpu/models/recommendeduser.py`
(`FollowEvent`, `TrainingData`, `Query`, `UserScore`, `UserScoreResult`,
`PreparedData`, `DataSourceParams`, `RecommendedUserDataSource`,
`RecommendedUserPreparator`, `ALSAlgorithmParams`,
`RecommendedUserModel`, `RecommendedUserALSAlgorithm` and the engine
factory). The data source reads users' `$set` properties and `(user,
follow, user)` events; the algorithm sums each (follower, followed) pair's
follows and trains implicit ALS (alpha 1, the solver left at 'auto': on
the card every solve goes through `csrc/cg_solve.cu`), and keeps the
followed users' normalized factor table. A query names users; every
followed user is scored by its summed cosine similarity to theirs, the
query users excluded, under white and black lists, score > 0 kept.
`predict` ranks through `cosine_top_k`, `batch_predict` a whole batch
through one `masked_top_k_batch`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core import (DataSource, Engine, EngineFactory,
                                         EngineParams, FirstServing,
                                         P2LAlgorithm, Params, Preparator,
                                         SanityCheck)
from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.common import RatingsData, resolve_ids
from predictionio_tpu_torch.ops.als import ALSConfig, als_train
from predictionio_tpu_torch.ops.ratings import RatingsCOO, dedup_ratings
from predictionio_tpu_torch.ops.similarity import (build_filter_mask,
                                                   cosine_top_k,
                                                   masked_top_k_batch,
                                                   normalize_rows,
                                                   unpack_top_k_rows)

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class FollowEvent:
    user: str
    followed_user: str
    t: int = 0


@dataclass
class TrainingData(SanityCheck):
    """follow_events is columnar (RatingsData: users = followers, items =
    followed users, each 1); FollowEvent row lists are converted."""
    users: Dict[str, dict]
    follow_events: RatingsData

    def __post_init__(self):
        if isinstance(self.follow_events, (list, tuple)):
            self.follow_events = RatingsData(
                np.array([e.user for e in self.follow_events], dtype=str),
                np.array([e.followed_user for e in self.follow_events],
                         dtype=str),
                np.ones(len(self.follow_events), dtype=np.float32),
                np.array([e.t for e in self.follow_events],
                         dtype=np.int64))

    def sanity_check(self):
        if not len(self.follow_events):
            raise ValueError("follow_events is empty; check the data source")


@dataclass(frozen=True)
class Query:
    users: Tuple[str, ...]
    num: int
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    @staticmethod
    def from_dict(d: dict) -> "Query":
        """camelCase wire keys; KeyError/ValueError/TypeError for a
        missing or malformed field (the server answers 400)."""
        def opt(key):
            v = d.get(key)
            return tuple(v) if v is not None else None
        return Query(users=tuple(d["users"]), num=int(d["num"]),
                     white_list=opt("whiteList"), black_list=opt("blackList"))


@dataclass(frozen=True)
class UserScore:
    user: str
    score: float


@dataclass(frozen=True)
class UserScoreResult:
    similar_user_scores: Tuple[UserScore, ...]

    def to_dict(self) -> dict:
        return {"similarUserScores": [{"user": s.user, "score": s.score}
                                      for s in self.similar_user_scores]}


@dataclass
class PreparedData:
    td: TrainingData


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None


class RecommendedUserDataSource(DataSource):
    PARAMS_CLASS = DataSourceParams

    def __init__(self, params: Optional[DataSourceParams] = None):
        super().__init__(params or DataSourceParams())

    def read_training(self) -> TrainingData:
        app, chan = self.params.app_name, self.params.channel_name
        users = {eid: dict(pm.fields) for eid, pm in
                 PEventStore.aggregate_properties(
                     app_name=app, channel_name=chan,
                     entity_type="user").items()}
        fc = PEventStore.find_columnar(
            app_name=app, channel_name=chan, entity_type="user",
            event_names=["follow"], target_entity_type="user")
        follows = RatingsData(fc["entity_id"], fc["target_entity_id"],
                              np.ones(len(fc["t"]), dtype=np.float32),
                              fc["t"])
        return TrainingData(users=users, follow_events=follows)


class RecommendedUserPreparator(Preparator):
    def prepare(self, td: TrainingData) -> PreparedData:
        return PreparedData(td)


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    seed: Optional[int] = None
    # products' operand dtype (ops/als.py ALSConfig); None = float32 on
    # the card and on the CPU, the reference's answer off the TPU
    compute_dtype: Optional[str] = None
    sweep_chunk: int = 0           # ALSConfig.sweep_chunk; 0 = auto (1)
    fuse_iteration: bool = False   # ALSConfig.fuse_iteration
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass
class RecommendedUserModel:
    """The followed users' normalized factors (host numpy, and on
    `device` for serving) and their id map. A model restored from storage
    has no device until its algorithm places it."""
    followed_factors_normalized: np.ndarray   # [F, R] L2-normalized rows
    followed_ix: EntityIdIxMap
    device: Optional[torch.device] = None
    _table: Optional[torch.Tensor] = field(default=None, repr=False,
                                           compare=False)

    def table(self) -> torch.Tensor:
        """The normalized table on the model's device (uploaded once)."""
        if self._table is None:
            if self.device is None:
                raise RuntimeError(
                    "this RecommendedUserModel was restored without a "
                    "device; its algorithm's place_model puts it on one")
            self._table = torch.tensor(self.followed_factors_normalized,
                                       device=self.device)
        return self._table


class RecommendedUserALSAlgorithm(P2LAlgorithm):
    PARAMS_CLASS = ALSAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[ALSAlgorithmParams] = None):
        super().__init__(params or ALSAlgorithmParams())
        self.last_train_telemetry: dict = {}

    def train(self, pd: PreparedData) -> RecommendedUserModel:
        td = pd.td
        p = self.params
        if not len(td.follow_events):
            raise ValueError("No follow events to train on")
        fd = td.follow_events
        follower_ix, ui = EntityIdIxMap.build_with_indices(fd.users)
        followed_ix, ii = EntityIdIxMap.build_with_indices(fd.items)
        ui, ii, counts = dedup_ratings(ui, ii, fd.vals, policy="sum")
        coo = RatingsCOO(ui, ii, counts, len(follower_ix), len(followed_ix))
        cfg = ALSConfig(rank=p.rank, iterations=p.num_iterations, lam=p.lam,
                        sweep_chunk=p.sweep_chunk,
                        fuse_iteration=p.fuse_iteration,
                        implicit_prefs=True,
                        alpha=1.0, seed=p.seed if p.seed is not None else 0,
                        compute_dtype=p.compute_dtype or "float32")
        self.last_train_telemetry = {"ratings": coo.nnz}
        model = als_train(coo, cfg, device=p.device,
                          telemetry=self.last_train_telemetry)
        out = RecommendedUserModel(
            followed_factors_normalized=normalize_rows(model.item_factors),
            followed_ix=followed_ix, device=model.device)
        out.table()
        return out

    def place_model(self, model: RecommendedUserModel
                    ) -> RecommendedUserModel:
        """Upload a restored model's table to this algorithm's device
        (`params.device`; None = the card), once, before it serves."""
        model.device = resolve_device(self.params.device)
        model.table()
        return model

    def _query_rows(self, model: RecommendedUserModel, query: Query
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The query users' rows and the candidate mask (None when no
        query user is known)."""
        q_ix = resolve_ids(model.followed_ix, query.users)
        if len(q_ix) == 0:
            logger.info("No similarUserFeatures vector for query users %s.",
                        query.users)
            return q_ix, None
        white = (resolve_ids(model.followed_ix, query.white_list)
                 if query.white_list is not None else None)
        black = resolve_ids(model.followed_ix, query.black_list or ())
        mask = build_filter_mask(len(model.followed_ix),
                                 exclude=np.concatenate([q_ix, black]),
                                 white_list=white)
        return q_ix, mask

    @staticmethod
    def _to_result(model: RecommendedUserModel, scores: np.ndarray,
                   idx: np.ndarray) -> UserScoreResult:
        return UserScoreResult(tuple(
            UserScore(model.followed_ix.id_of(int(i)), float(s))
            for s, i in zip(scores, idx)))

    def predict(self, model: RecommendedUserModel, query: Query
                ) -> UserScoreResult:
        q_ix, mask = self._query_rows(model, query)
        if mask is None:
            return UserScoreResult(())
        scores, idx = cosine_top_k(model.table(),
                                   model.followed_factors_normalized[q_ix],
                                   query.num, mask)
        return self._to_result(model, scores, idx)

    def batch_predict(self, model: RecommendedUserModel, queries):
        """Each query collapses to its summed normalized vector; the batch
        is one masked matmul + top-k."""
        out = {ix: UserScoreResult(()) for ix, _ in queries}
        rows = []
        for ix, q in queries:
            q_ix, mask = self._query_rows(model, q)
            if mask is None:
                continue
            rows.append((ix, q,
                         model.followed_factors_normalized[q_ix].sum(axis=0),
                         mask))
        if rows:
            scores, idx = masked_top_k_batch(
                model.table(), np.stack([r[2] for r in rows]),
                np.stack([r[3] for r in rows]),
                max(q.num for _, q, _, _ in rows))
            for row, (ix, q, _, _) in enumerate(rows):
                s, i = unpack_top_k_rows(scores[row], idx[row], q.num)
                out[ix] = self._to_result(model, s, i)
        return list(out.items())


class RecommendedUserEngineFactory(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine({"": RecommendedUserDataSource},
                      {"": RecommendedUserPreparator},
                      {"als": RecommendedUserALSAlgorithm},
                      {"": FirstServing})

    @classmethod
    def engine_params(cls, key: str = "") -> EngineParams:
        return EngineParams(
            data_source_params=("", DataSourceParams()),
            preparator_params=("", None),
            algorithm_params_list=[("als", ALSAlgorithmParams())],
            serving_params=("", None))
