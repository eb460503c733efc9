"""Similar-product engine template: implicit ALS + cosine similarity.

The port's counterpart of `predictionio_tpu/models/similarproduct.py`
(`Item`, `ViewEvent`, `LikeEvent`, `TrainingData`, `Query`,
`SimilarProductPreparator`, `ALSAlgorithmParams`, `ItemMetadataModel`,
`SimilarProductModel`, `ALSAlgorithm` with `_build_ratings`, `train`,
`_build_mask`, `predict`, `batch_predict` and `batch_predict_begin`,
`LikeAlgorithm`, `DIMSUMAlgorithmParams`, `DIMSUMModel`,
`DIMSUMAlgorithm`, `SimilarProductDataSource` and the engine factory). View
events are summed into counts per (user, item), trained with implicit ALS,
and a query scores every item by its summed cosine similarity to the query
items' factors, under category, white-list, black-list and year filters.

The data source reads the event store as the reference does: users' and
items' `$set` properties (an item's `categories`), `view` events (and
`rate` events as views under `rate_as_view`) and, under
`read_like_events`, `like`/`dislike` events. It may also be handed the
items and events as arrays through its params; such params have no JSON
form, so an engine instance (`workflow.run_train`) cannot be trained from
them.

Online fold-in (`online/`): `read_training_touched` reads only the
touched entities' events and properties through the store's entity
pushdown, and `ALSAlgorithm.fold_in` (and `LikeAlgorithm`'s) re-solves
only the touched rows of the implicit factorization and refreshes the
normalized serve table; a newly `$set` and viewed item becomes
recommendable without a retrain.

The dimsum variant (`DIMSUMAlgorithm`, `DIMSUMModel`): the exact item-item
cosine similarity of binary view co-occurrence, its Gram accumulated on
the card (`ops/similarity.item_cosine_similarities`), kept as a host
[I, I] table that a query row-gathers and sums. The model persists itself
under `<PIO_FS_BASEDIR>/dimsum/<instance_id>` and the engine instance
stores only its manifest.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core import (DataSource, Engine, EngineFactory,
                                         EngineParams, FirstServing,
                                         P2LAlgorithm, Params, Preparator,
                                         SanityCheck)
from predictionio_tpu_torch.core.engine import restricted_loads
from predictionio_tpu_torch.core.persistence import PersistentModel
from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.data.storage.base import aggregate_event_names
from predictionio_tpu_torch.data.storage.registry import base_dir
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.common import (ItemScoreResult,
                                                  RatingsData, resolve_ids,
                                                  top_scores_to_result)
from predictionio_tpu_torch.online.fold_in import FoldInConfig, fold_in_coo
from predictionio_tpu_torch.ops.als import (ALSConfig, ALSModel, als_rmse,
                                            als_train)
from predictionio_tpu_torch.ops.ratings import RatingsCOO, dedup_ratings
from predictionio_tpu_torch.ops.solve import COUNTS
from predictionio_tpu_torch.ops.similarity import (build_filter_mask,
                                                   cosine_top_k,
                                                   item_cosine_similarities,
                                                   masked_top_k_batch_begin,
                                                   masked_topk_dims,
                                                   normalize_rows,
                                                   unpack_top_k_rows)
from predictionio_tpu_torch.utils.device_cache import cached_table
from predictionio_tpu_torch.compile import buckets as B

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Item:
    categories: Optional[Tuple[str, ...]] = None
    properties: Optional[dict] = None   # the full $set property bag


@dataclass(frozen=True)
class ViewEvent:
    user: str
    item: str
    t: int = 0


@dataclass(frozen=True)
class LikeEvent:
    """like (True) or dislike (False)."""
    user: str
    item: str
    like: bool
    t: int = 0


@dataclass
class TrainingData(SanityCheck):
    """view_events/like_events are columnar (RatingsData: a view is 1, a
    like +1, a dislike -1); ViewEvent/LikeEvent row lists are
    converted."""
    users: Dict[str, dict]
    items: Dict[str, Item]
    view_events: RatingsData
    like_events: Optional[RatingsData] = None
    # an entity-filtered read (read_training_touched): only the touched
    # entities' events and properties, input to a fold-in, never to a
    # train
    touched_only: bool = False

    def __post_init__(self):
        if isinstance(self.view_events, (list, tuple)):
            self.view_events = RatingsData(
                np.array([v.user for v in self.view_events], dtype=str),
                np.array([v.item for v in self.view_events], dtype=str),
                np.ones(len(self.view_events), dtype=np.float32),
                np.array([v.t for v in self.view_events], dtype=np.int64))
        if isinstance(self.like_events, (list, tuple)):
            self.like_events = RatingsData(
                np.array([e.user for e in self.like_events], dtype=str),
                np.array([e.item for e in self.like_events], dtype=str),
                np.array([1.0 if e.like else -1.0
                          for e in self.like_events], dtype=np.float32),
                np.array([e.t for e in self.like_events], dtype=np.int64))

    def sanity_check(self):
        if not len(self.view_events):
            raise ValueError("view_events is empty; check the data source")
        if not self.items:
            raise ValueError("items is empty; check the data source")


@dataclass(frozen=True)
class Query:
    items: Tuple[str, ...]
    num: int
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None
    # only items with year > recommend_from_year (undated items pass)
    recommend_from_year: Optional[int] = None

    @staticmethod
    def from_dict(d: dict) -> "Query":
        """camelCase wire keys. Raises KeyError for a missing field,
        ValueError/TypeError for a malformed one (the server answers 400
        for both)."""
        def opt(key):
            v = d.get(key)
            return tuple(v) if v is not None else None
        rfy = d.get("recommendFromYear")
        return Query(items=tuple(d["items"]), num=int(d["num"]),
                     categories=opt("categories"),
                     white_list=opt("whiteList"),
                     black_list=opt("blackList"),
                     recommend_from_year=(int(rfy) if rfy is not None
                                          else None))


@dataclass
class PreparedData:
    td: TrainingData


@dataclass(frozen=True, eq=False)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None
    # add-rateevent variant: rate events count as views as well
    rate_as_view: bool = False
    # multi variant: also read like/dislike events for LikeAlgorithm
    read_like_events: bool = False
    # the training data itself, instead of the event store
    items: Optional[Dict[str, Item]] = None
    view_events: Optional[RatingsData] = None
    like_events: Optional[RatingsData] = None


class SimilarProductDataSource(DataSource):
    """(multi/DataSource.scala readTraining: $set user, $set item with
    categories, view events, like/dislike events)."""
    PARAMS_CLASS = DataSourceParams

    def __init__(self, params: Optional[DataSourceParams] = None):
        super().__init__(params or DataSourceParams())

    def read_training(self) -> TrainingData:
        p = self.params
        if p.items is not None or p.view_events is not None:
            if p.items is None or p.view_events is None:
                raise ValueError("DataSourceParams.items and .view_events "
                                 "are set together")
            return TrainingData(users={}, items=dict(p.items),
                                view_events=p.view_events,
                                like_events=p.like_events)
        app, chan = p.app_name, p.channel_name
        users = {eid: pm.fields for eid, pm in
                 PEventStore.aggregate_properties(
                     app_name=app, channel_name=chan,
                     entity_type="user").items()}
        items = {}
        for eid, pm in PEventStore.aggregate_properties(
                app_name=app, channel_name=chan,
                entity_type="item").items():
            cats = pm.get_opt("categories", list)
            items[eid] = Item(tuple(cats) if cats is not None else None,
                              properties=pm.fields)
        vc = PEventStore.find_columnar(
            app_name=app, channel_name=chan, entity_type="user",
            event_names=["view", "rate"] if p.rate_as_view else ["view"],
            target_entity_type="item")
        views = RatingsData(vc["entity_id"], vc["target_entity_id"],
                            np.ones(len(vc["t"]), dtype=np.float32),
                            vc["t"])
        likes = None
        if p.read_like_events:
            lc = PEventStore.find_columnar(
                app_name=app, channel_name=chan, entity_type="user",
                event_names=["like", "dislike"], target_entity_type="item")
            likes = RatingsData(
                lc["entity_id"], lc["target_entity_id"],
                np.where(lc["event"] == "like", 1.0, -1.0
                         ).astype(np.float32), lc["t"])
        return TrainingData(users=users, items=items, view_events=views,
                            like_events=likes)

    def read_training_touched(self, touched_users,
                              touched_items) -> TrainingData:
        """The fold tick's entity-filtered read: the touched users' whole
        view (and like) histories and every event on a touched item,
        through the store's pushdown, and the properties of the touched
        entities only."""
        p = self.params
        app, chan = p.app_name, p.channel_name
        tu = [str(u) for u in touched_users]
        ti = [str(i) for i in touched_items]
        users = {u: dict(pm.fields)
                 for u, pm in self._aggregate_for("user", tu).items()}
        items = {}
        for eid, pm in self._aggregate_for("item", ti).items():
            cats = pm.get_opt("categories", list)
            items[eid] = Item(tuple(cats) if cats is not None else None,
                              properties=dict(pm.fields))
        vc = PEventStore.find_columnar_by_entities(
            app_name=app, channel_name=chan, entity_ids=tu,
            target_entity_ids=ti, entity_type="user",
            event_names=["view", "rate"] if p.rate_as_view else ["view"],
            target_entity_type="item")
        views = RatingsData(vc["entity_id"], vc["target_entity_id"],
                            np.ones(len(vc["t"]), dtype=np.float32),
                            vc["t"])
        likes = None
        if p.read_like_events:
            lc = PEventStore.find_columnar_by_entities(
                app_name=app, channel_name=chan, entity_ids=tu,
                target_entity_ids=ti, entity_type="user",
                event_names=["like", "dislike"], target_entity_type="item")
            likes = RatingsData(
                lc["entity_id"], lc["target_entity_id"],
                np.where(lc["event"] == "like", 1.0, -1.0
                         ).astype(np.float32), lc["t"])
        return TrainingData(users=users, items=items, view_events=views,
                            like_events=likes, touched_only=True)

    def _aggregate_for(self, entity_type: str, entity_ids) -> dict:
        """Properties folded for an id set: a point read an id, the app
        and channel resolved once."""
        app_id, channel_id = PEventStore.resolve(self.params.app_name,
                                                 self.params.channel_name)
        events = []
        for eid in entity_ids:
            events.extend(PEventStore.events.find(
                app_id=app_id, channel_id=channel_id,
                entity_type=entity_type, entity_id=eid,
                event_names=list(aggregate_event_names())))
        return aggregate_properties(events)


class SimilarProductPreparator(Preparator):
    def prepare(self, td: TrainingData) -> PreparedData:
        return PreparedData(td)


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # products' operand dtype (ops/als.py ALSConfig); None = float32 on
    # the card and on the CPU, the reference's answer off the TPU
    compute_dtype: Optional[str] = None
    # property keys copied onto each ItemScore (missing -> null)
    return_properties: Tuple[str, ...] = ()
    sweep_chunk: int = 0           # ALSConfig.sweep_chunk; 0 = auto (1)
    fuse_iteration: bool = False   # ALSConfig.fuse_iteration
    solver: str = "auto"           # ops/solve.py spd_solve
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass(kw_only=True)
class ItemMetadataModel:
    """Id maps + item metadata shared by the similar-product models."""
    item_ix: EntityIdIxMap
    items: Dict[str, Item]
    item_categories: List[Optional[set]]      # by dense index
    item_years: Optional[np.ndarray] = None   # float32, NaN = undated

    @staticmethod
    def derive_years(items: Dict[str, Item],
                     item_ix: EntityIdIxMap) -> np.ndarray:
        years = np.full(len(item_ix), np.nan, dtype=np.float32)
        for ix in range(len(item_ix)):
            item = items.get(item_ix.id_of(ix))
            y = (item.properties or {}).get("year") if item else None
            if y is not None:
                years[ix] = float(y)
        return years

    @staticmethod
    def derive_categories(items: Dict[str, Item], item_ix: EntityIdIxMap
                          ) -> List[Optional[set]]:
        """Each item's categories as a set, by dense index (None
        without)."""
        out = []
        for ix in range(len(item_ix)):
            item = items.get(item_ix.id_of(ix))
            out.append(set(item.categories) if item and item.categories
                       else None)
        return out

    @classmethod
    def metadata_kwargs(cls, items: Dict[str, Item],
                        item_ix: EntityIdIxMap) -> dict:
        """Constructor kwargs for the shared fields, derived once from the
        training data's items."""
        return dict(item_ix=item_ix, items=dict(items),
                    item_categories=cls.derive_categories(items, item_ix),
                    item_years=cls.derive_years(items, item_ix))

    def properties_of(self, keys: Tuple[str, ...]):
        """ItemScore property passthrough: requested keys always present,
        missing -> None."""
        if not keys:
            return None

        def get(ix: int):
            item = self.items.get(self.item_ix.id_of(ix))
            p = (item.properties if item and item.properties else {})
            return {k: p.get(k) for k in keys}
        return get


@dataclass(kw_only=True)
class SimilarProductModel(ItemMetadataModel):
    """Normalized item factors (served, on `device`) + id maps + item
    metadata; the raw factors and the user side ride along. A model
    restored from storage has no device until its algorithm places it."""
    item_factors_normalized: np.ndarray   # [I, R] L2-normalized rows
    device: Optional[torch.device]
    item_factors_raw: Optional[np.ndarray] = None   # [I, R]
    user_factors: Optional[np.ndarray] = None       # [U, R]
    user_ix: Optional[EntityIdIxMap] = None

    def table(self) -> torch.Tensor:
        """The normalized item table on the model's device: a view of its
        padded upload, which the upload cache holds (uploaded once,
        `utils/device_cache.cached_table`)."""
        if self.device is None:
            raise RuntimeError(
                "this SimilarProductModel was restored without a "
                "device; its algorithm's place_model puts it on one")
        return cached_table(self.item_factors_normalized, self.device)


class ALSAlgorithm(P2LAlgorithm):
    PARAMS_CLASS = ALSAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[ALSAlgorithmParams] = None):
        super().__init__(params or ALSAlgorithmParams())
        self.last_train_telemetry: dict = {}

    def _build_ratings(self, td: TrainingData
                       ) -> Tuple[EntityIdIxMap, EntityIdIxMap, RatingsCOO]:
        """View counts, ((u, i), 1).reduceByKey(_ + _). The item
        vocabulary covers every $set item (so items without views still
        resolve) and every viewed item; users are those with views."""
        if not len(td.view_events):
            raise ValueError("No view events to train on")
        views = td.view_events
        user_ix, ui = EntityIdIxMap.build_with_indices(views.users)
        item_ix = EntityIdIxMap.build(np.concatenate(
            [np.array(list(td.items), dtype=str), views.items.astype(str)]))
        ii = item_ix.to_indices_array(views.items)
        ui, ii, counts = dedup_ratings(ui, ii, views.vals, policy="sum")
        return user_ix, item_ix, RatingsCOO(ui, ii, counts,
                                            len(user_ix), len(item_ix))

    def train(self, pd: PreparedData) -> SimilarProductModel:
        td = pd.td
        p = self.params
        user_ix, item_ix, coo = self._build_ratings(td)
        cfg = ALSConfig(rank=p.rank, iterations=p.num_iterations, lam=p.lam,
                        implicit_prefs=True, alpha=p.alpha,
                        seed=p.seed if p.seed is not None else 0,
                        solver=p.solver,
                        compute_dtype=p.compute_dtype or "float32",
                        sweep_chunk=p.sweep_chunk,
                        fuse_iteration=p.fuse_iteration)
        self.last_train_telemetry = {"ratings": coo.nnz}
        model = als_train(coo, cfg, device=p.device,
                          telemetry=self.last_train_telemetry)
        return SimilarProductModel(
            item_factors_normalized=normalize_rows(model.item_factors),
            device=model.device, item_factors_raw=model.item_factors,
            user_factors=model.user_factors, user_ix=user_ix,
            **ItemMetadataModel.metadata_kwargs(td.items, item_ix))

    def place_model(self, model: SimilarProductModel
                    ) -> SimilarProductModel:
        """Upload a restored model's table to this algorithm's device
        (`params.device`; None = the card), once, before it serves."""
        model.device = resolve_device(self.params.device)
        model.table()
        return model

    def _fold_users_present(self, td: TrainingData) -> set:
        """Users with events: the only ones the fold may mint rows for (a
        user with only a `$set` stays cold-start)."""
        if not len(td.view_events):
            return set()
        return set(np.unique(td.view_events.users).astype(str))

    def _fold_ratings(self, td: TrainingData, user_ix: EntityIdIxMap,
                      item_ix: EntityIdIxMap) -> RatingsCOO:
        """`td`'s view counts on fixed (grown) vocabularies: the fold's
        `_build_ratings`, which would build vocabularies of its own."""
        views = td.view_events
        ui = user_ix.to_indices_array(views.users)
        ii = item_ix.to_indices_array(views.items)
        keep = (ui >= 0) & (ii >= 0)
        ui, ii, counts = dedup_ratings(ui[keep], ii[keep], views.vals[keep],
                                       policy="sum")
        return RatingsCOO(ui, ii, counts, len(user_ix), len(item_ix))

    def fold_data(self, model: SimilarProductModel, td: TrainingData,
                  touched_users, touched_items):
        """What a fold of `td` into `model` solves: (grown user map, grown
        item map, the COO on them, touched user indices, touched item
        indices). Users grow only with events; items grow when viewed or
        `$set`, as train's item vocabulary covers every `$set` item."""
        present_u = self._fold_users_present(td)
        user_ix, _ = model.user_ix.grow(
            u for u in map(str, touched_users) if u in present_u)
        item_ix, _ = model.item_ix.grow(str(i) for i in touched_items)
        coo = self._fold_ratings(td, user_ix, item_ix)
        tu = user_ix.to_indices([str(u) for u in touched_users])
        ti = item_ix.to_indices([str(i) for i in touched_items])
        return user_ix, item_ix, coo, tu[tu >= 0], ti[ti >= 0]

    def fold_config(self) -> FoldInConfig:
        """Implicit, two sweeps, the solver left at 'auto' as the
        reference's template leaves it (so the card's CG kernel, whatever
        solver trained the model), the train's compute dtype."""
        p = self.params
        return FoldInConfig(lam=p.lam, alpha=p.alpha, implicit_prefs=True,
                            sweeps=2,
                            compute_dtype=p.compute_dtype or "float32",
                            sweep_chunk=p.sweep_chunk)

    def fold_in(self, model: SimilarProductModel, td: TrainingData,
                touched_users, touched_items, preparator_params=None
                ) -> Tuple[SimilarProductModel, dict]:
        """Implicit (Hu-Koren) fold-in: re-solve only the touched user and
        item rows of the view-count factorization and refresh the
        normalized serve table. After an entity-filtered read (`td` holds
        only the touched items' `$set`), untouched items keep the deployed
        metadata. A model without the raw factors and the user side
        raises. Returns (new model, report) as the recommendation
        template's `fold_in`."""
        if model.item_factors_raw is None or model.user_factors is None \
                or model.user_ix is None:
            raise ValueError(
                "model lacks online-update state; retrain once with this "
                "build before attaching the delta scheduler")
        user_ix, item_ix, coo, tu, ti = self.fold_data(
            model, td, touched_users, touched_items)
        als = ALSModel(model.user_factors, model.item_factors_raw,
                       model.item_factors_raw.shape[1], model.device)
        before = dict(vars(COUNTS))
        new_als, stats = fold_in_coo(
            als, coo, tu, ti, self.fold_config(),
            device=resolve_device(self.params.device),
            resident_key=f"fold:{type(self).__name__}:{id(self)}")
        if stats.degenerate:
            return model, {"algorithm": type(self).__name__,
                           "degenerate": True, "wallS": stats.wall_s}
        items = ({**model.items, **td.items} if td.touched_only
                 else td.items)
        new_model = SimilarProductModel(
            item_factors_normalized=normalize_rows(new_als.item_factors),
            device=new_als.device, item_factors_raw=new_als.item_factors,
            user_factors=new_als.user_factors, user_ix=user_ix,
            **ItemMetadataModel.metadata_kwargs(items, item_ix))
        return new_model, {
            "algorithm": type(self).__name__,
            "loss": als_rmse(new_als, coo),
            "userRows": stats.n_user_rows, "itemRows": stats.n_item_rows,
            "newUsers": stats.n_new_users, "newItems": stats.n_new_items,
            "wallS": stats.wall_s, "residentHit": stats.resident_hit,
            "sentinelRollback": stats.sentinel_rollback,
            "guardWallS": stats.guard_wall_s,
            "solverCalls": stats.solver_calls,
            "launches": {k: v - before[k] for k, v in vars(COUNTS).items()
                         if v != before[k]}}

    @staticmethod
    def _build_mask(model: ItemMetadataModel, query: Query,
                    q_ix: np.ndarray) -> np.ndarray:
        """Candidate mask shared by the single and batched paths; the
        query items are excluded."""
        white = (resolve_ids(model.item_ix, query.white_list)
                 if query.white_list is not None else None)
        black = resolve_ids(model.item_ix, query.black_list or ())
        mask = build_filter_mask(
            len(model.item_ix), exclude=np.concatenate([q_ix, black]),
            white_list=white, item_categories=model.item_categories,
            categories=set(query.categories) if query.categories else None)
        if query.recommend_from_year is not None and \
                model.item_years is not None:
            dated = ~np.isnan(model.item_years)
            mask &= ~(dated & (model.item_years <= query.recommend_from_year))
        return mask

    def predict(self, model: SimilarProductModel, query: Query
                ) -> ItemScoreResult:
        q_ix = resolve_ids(model.item_ix, query.items)
        if len(q_ix) == 0:
            logger.info("No productFeatures vector for query items %s.",
                        query.items)
            return ItemScoreResult(())
        scores, idx = cosine_top_k(model.table(),
                                   model.item_factors_normalized[q_ix],
                                   query.num,
                                   self._build_mask(model, query, q_ix))
        return top_scores_to_result(
            model.item_ix, scores, idx,
            properties_of=model.properties_of(self.params.return_properties))

    def batch_predict(self, model: SimilarProductModel, queries):
        """`batch_predict_begin(...)()`."""
        return self.batch_predict_begin(model, queries)()

    def batch_predict_begin(self, model: SimilarProductModel, queries):
        """The cosine score is linear over the query items, so each query
        collapses to one summed normalized vector and the whole batch is
        one masked matmul + top-k, enqueued now
        (`masked_top_k_batch_begin`). Returns `finish() -> [(ix,
        result)]`, which waits for the result and builds the answers (it
        may run on another thread)."""
        out = {ix: ItemScoreResult(()) for ix, _ in queries}
        rows = []  # (ix, query, qsum [R], mask [I])
        for ix, q in queries:
            q_ix = resolve_ids(model.item_ix, q.items)
            if len(q_ix) == 0:
                logger.info("No productFeatures vector for query items %s.",
                            q.items)
                continue
            rows.append((ix, q,
                         model.item_factors_normalized[q_ix].sum(axis=0),
                         self._build_mask(model, q, q_ix)))
        fetch = None
        if rows:
            fetch = masked_top_k_batch_begin(
                model.table(), np.stack([r[2] for r in rows]),
                np.stack([r[3] for r in rows]),
                max(q.num for _, q, _, _ in rows))

        def finish():
            if fetch is not None:
                scores, idx = fetch()
                props_of = model.properties_of(
                    self.params.return_properties)
                for row, (ix, q, _, _) in enumerate(rows):
                    s, i = unpack_top_k_rows(scores[row], idx[row], q.num)
                    out[ix] = top_scores_to_result(model.item_ix, s, i,
                                                   properties_of=props_of)
            return list(out.items())
        return finish

    def aot_warm_specs(self, model: SimilarProductModel,
                       batch_hint: int = 16) -> list:
        """(label, dims, owners) rows of the cosine serve executable over
        the micro-batcher's pow2 ladder (1 up to the window) at the
        smallest top-k bucket: what `compile.aot.warm_models` captures at
        deploy and swap time, before the model takes a query."""
        from predictionio_tpu_torch.obs import costmon
        from predictionio_tpu_torch.ops.similarity import register_aot_specs
        register_aot_specs()
        table = model.table()
        return [(costmon.BATCH_PREDICT_MASKED,
                 masked_topk_dims(table.shape[0], table.shape[1], b,
                                  B.K_FLOOR, filter_positive=True),
                 (table,))
                for b in B.batch_ladder(batch_hint)]


class LikeAlgorithm(ALSAlgorithm):
    """Implicit ALS on like/dislike events: the latest event per (user,
    item) wins, like = +1, dislike = -1 (confidence with preference 0).
    Served by the same cosine scan as ALSAlgorithm."""

    def _build_ratings(self, td: TrainingData
                       ) -> Tuple[EntityIdIxMap, EntityIdIxMap, RatingsCOO]:
        likes = td.like_events
        if likes is None or not len(likes):
            raise ValueError("No like/dislike events to train on "
                             "(set read_like_events on the data source)")
        user_ix, ui = EntityIdIxMap.build_with_indices(likes.users)
        item_ix = EntityIdIxMap.build(np.concatenate(
            [np.array(list(td.items), dtype=str), likes.items.astype(str)]))
        ii = item_ix.to_indices_array(likes.items)
        ui, ii, vals = dedup_ratings(ui, ii, likes.vals, likes.ts,
                                     policy="latest")
        return user_ix, item_ix, RatingsCOO(ui, ii, vals,
                                            len(user_ix), len(item_ix))

    def _fold_users_present(self, td: TrainingData) -> set:
        if td.like_events is None or not len(td.like_events):
            return set()
        return set(np.unique(td.like_events.users).astype(str))

    def _fold_ratings(self, td: TrainingData, user_ix: EntityIdIxMap,
                      item_ix: EntityIdIxMap) -> RatingsCOO:
        likes = td.like_events
        if likes is None or not len(likes):
            raise ValueError("No like/dislike events to fold in")
        ui = user_ix.to_indices_array(likes.users)
        ii = item_ix.to_indices_array(likes.items)
        keep = (ui >= 0) & (ii >= 0)
        ui, ii, vals = dedup_ratings(ui[keep], ii[keep], likes.vals[keep],
                                     likes.ts[keep], policy="latest")
        return RatingsCOO(ui, ii, vals, len(user_ix), len(item_ix))


@dataclass(frozen=True)
class DIMSUMAlgorithmParams(Params):
    """dimsum variant (DIMSUMAlgorithm.scala:23): `threshold` drops
    similarities below it. The similarity is exact, not DIMSUM's sampling
    approximation."""
    threshold: float = 0.0
    return_properties: Tuple[str, ...] = ()
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass(kw_only=True)
class DIMSUMModel(ItemMetadataModel, PersistentModel):
    """Item-item similarity rows (host numpy) + id maps + item metadata.
    It persists itself (the reference's IPersistentModel save to
    /tmp/<id>; here `<PIO_FS_BASEDIR>/dimsum/<instance_id>`): the table
    as `similarities.npy`, the maps and metadata as `maps.pkl`, read back
    through the engine's restricted unpickler."""
    similarities: np.ndarray              # [I, I] f32, zero diagonal

    @classmethod
    def _dir(cls, instance_id: str) -> str:
        return os.path.join(base_dir(), "dimsum", instance_id)

    def save(self, instance_id: str, params) -> bool:
        import pickle
        d = self._dir(instance_id)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "similarities.npy"), self.similarities)
        with open(os.path.join(d, "maps.pkl"), "wb") as f:
            pickle.dump({"item_ix": self.item_ix, "items": self.items,
                         "item_categories": self.item_categories,
                         "item_years": self.item_years}, f)
        return True

    @classmethod
    def load(cls, instance_id: str, params) -> "DIMSUMModel":
        d = cls._dir(instance_id)
        sims = np.load(os.path.join(d, "similarities.npy"))
        with open(os.path.join(d, "maps.pkl"), "rb") as f:
            maps = restricted_loads(f.read(), instance_id)
        return cls(similarities=sims, **maps)


class DIMSUMAlgorithm(P2LAlgorithm):
    """dimsum variant (DIMSUMAlgorithm.scala:67-220): all-pairs item
    cosine similarity from binary view co-occurrence, computed at train
    time on `params.device`; a query sums its items' similarity rows on
    the host (the model is the score table) under the similar-product
    filters, score > 0 kept."""
    PARAMS_CLASS = DIMSUMAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[DIMSUMAlgorithmParams] = None):
        super().__init__(params or DIMSUMAlgorithmParams())
        self.last_train_telemetry: dict = {}

    def train(self, pd: PreparedData) -> DIMSUMModel:
        td = pd.td
        if not len(td.view_events):
            raise ValueError("No view events to train on")
        views = td.view_events
        user_ix, ui = EntityIdIxMap.build_with_indices(views.users)
        item_ix = EntityIdIxMap.build(np.concatenate(
            [np.array(list(td.items), dtype=str), views.items.astype(str)]))
        ii = item_ix.to_indices_array(views.items)
        self.last_train_telemetry = {"views": len(views),
                                     "users": len(user_ix),
                                     "items": len(item_ix)}
        sims = item_cosine_similarities(
            ui, ii, len(user_ix), len(item_ix),
            threshold=self.params.threshold, device=self.params.device,
            telemetry=self.last_train_telemetry)
        return DIMSUMModel(
            similarities=sims,
            **ItemMetadataModel.metadata_kwargs(td.items, item_ix))

    def predict(self, model: DIMSUMModel, query: Query) -> ItemScoreResult:
        q_ix = resolve_ids(model.item_ix, query.items)
        if len(q_ix) == 0:
            logger.info("No similarity row for query items %s.", query.items)
            return ItemScoreResult(())
        scores = model.similarities[q_ix].sum(axis=0)
        mask = ALSAlgorithm._build_mask(model, query, q_ix)
        scores = np.where(mask & (scores > 0), scores, -np.inf)
        k = min(query.num, len(scores))
        idx = np.argpartition(-scores, k - 1)[:k]
        idx = idx[np.argsort(-scores[idx], kind="stable")]
        keep = np.isfinite(scores[idx])
        return top_scores_to_result(
            model.item_ix, scores[idx][keep], idx[keep],
            properties_of=model.properties_of(self.params.return_properties))


class SimilarProductEngineFactory(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine({"": SimilarProductDataSource},
                      {"": SimilarProductPreparator},
                      {"als": ALSAlgorithm, "likealgo": LikeAlgorithm,
                       "dimsum": DIMSUMAlgorithm},
                      {"": FirstServing})

    @classmethod
    def engine_params(cls, items: Dict[str, Item], view_events: RatingsData,
                      algorithm: Optional[ALSAlgorithmParams] = None,
                      like_events: Optional[RatingsData] = None
                      ) -> EngineParams:
        return EngineParams(
            data_source_params=("", DataSourceParams(
                items=items, view_events=view_events,
                like_events=like_events)),
            preparator_params=("", None),
            algorithm_params_list=[("als",
                                    algorithm or ALSAlgorithmParams())],
            serving_params=("", None))
