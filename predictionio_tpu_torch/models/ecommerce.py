"""E-commerce recommendation template: implicit ALS + live business rules.

The port's counterpart of `predictionio_tpu/models/ecommerce.py`
(`RateEvent`, `TrainingData`, `Query`, `PreparedData`,
`DataSourceParams`, `ECommerceDataSource`, `ECommercePreparator`,
`ECommAlgorithmParams`, `ECommerceModel`, `ECommAlgorithm` and the engine
factory). The data source reads users' and items' `$set` properties (an
item's `categories`) and `rate`/`buy` events (a buy counts as
`buy_rating`); the algorithm keeps the latest rating of each (user, item)
and trains implicit ALS with the solver left at 'auto', as the reference
does: on the card every solve goes through `csrc/cg_solve.cu`.

At serve time the business rules are read live from the event store
(`LEventStore.find_by_entity`, 200 ms each): the user's seen items
(`seen_events`, when `unseen_only`) and the latest
`constraint/unavailableItems` `$set` are excluded with the query's black
list; a read that fails or misses its deadline is logged and excludes
nothing, as in the reference. A known user is scored by the raw dot
product with every item (score > 0 kept); a user without a factor row
falls back to the summed cosine similarity of their 10 most recent
`view`ed items; a user with neither gets an empty answer. The reads stay
on the host and only change the candidate mask. `batch_predict` reads
`unavailableItems` once a batch, the per-user rules on a pool of at most
8 threads, and ranks the batch in at most two device calls; there is no
`batch_predict_begin`, as in the reference, so the server runs it
synchronously and the deploy warm-up skips it.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.core import (DataSource, Engine, EngineFactory,
                                         EngineParams, FirstServing,
                                         P2LAlgorithm, Params, Preparator,
                                         SanityCheck)
from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.data.store import LEventStore, PEventStore
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.common import (ItemScoreResult,
                                                  RatingsData, resolve_ids,
                                                  top_scores_to_result)
from predictionio_tpu_torch.models.similarproduct import (Item,
                                                          ItemMetadataModel)
from predictionio_tpu_torch.ops.als import (ALSConfig, ALSModel, als_train,
                                            recommend_products)
from predictionio_tpu_torch.ops.ratings import RatingsCOO, dedup_ratings
from predictionio_tpu_torch.ops.similarity import (build_filter_mask,
                                                   cosine_top_k,
                                                   masked_top_k_batch,
                                                   normalize_rows,
                                                   unpack_top_k_rows)

logger = logging.getLogger(__name__)

#: the live reads' deadline (ALSAlgorithm.scala's 200 ms Duration)
POINT_READ_TIMEOUT_MS = 200


@dataclass(frozen=True)
class RateEvent:
    user: str
    item: str
    rating: float
    t: int


@dataclass
class TrainingData(SanityCheck):
    """rate_events is columnar (RatingsData); RateEvent row lists are
    converted."""
    users: Dict[str, dict]
    items: Dict[str, Item]
    rate_events: RatingsData

    def __post_init__(self):
        if isinstance(self.rate_events, (list, tuple)):
            self.rate_events = RatingsData.from_rows(self.rate_events)

    def sanity_check(self):
        if not len(self.rate_events):
            raise ValueError("rate_events is empty; check the data source")


@dataclass(frozen=True)
class Query:
    user: str
    num: int
    categories: Optional[Tuple[str, ...]] = None
    white_list: Optional[Tuple[str, ...]] = None
    black_list: Optional[Tuple[str, ...]] = None

    @staticmethod
    def from_dict(d: dict) -> "Query":
        """camelCase wire keys; KeyError/ValueError/TypeError for a
        missing or malformed field (the server answers 400)."""
        def opt(key):
            v = d.get(key)
            return tuple(v) if v is not None else None
        return Query(user=str(d["user"]), num=int(d["num"]),
                     categories=opt("categories"),
                     white_list=opt("whiteList"),
                     black_list=opt("blackList"))


@dataclass
class PreparedData:
    td: TrainingData


@dataclass(frozen=True)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None
    rate_events: Tuple[str, ...] = ("rate", "buy")
    buy_rating: float = 4.0


class ECommerceDataSource(DataSource):
    PARAMS_CLASS = DataSourceParams

    def __init__(self, params: Optional[DataSourceParams] = None):
        super().__init__(params or DataSourceParams())

    def read_training(self) -> TrainingData:
        app, chan = self.params.app_name, self.params.channel_name
        users = {eid: dict(pm.fields) for eid, pm in
                 PEventStore.aggregate_properties(
                     app_name=app, channel_name=chan,
                     entity_type="user").items()}
        items = {}
        for eid, pm in PEventStore.aggregate_properties(
                app_name=app, channel_name=chan,
                entity_type="item").items():
            cats = pm.get_opt("categories", list)
            items[eid] = Item(tuple(cats) if cats is not None else None)
        rc = PEventStore.find_columnar(
            app_name=app, channel_name=chan, property_field="rating",
            entity_type="user", event_names=list(self.params.rate_events),
            target_entity_type="item")
        is_rate = rc["event"] == "rate"
        missing = is_rate & np.isnan(rc["prop"])
        if missing.any():
            raise ValueError(
                f"{int(missing.sum())} 'rate' event(s) lack the required "
                "'rating' property")
        vals = np.where(is_rate, rc["prop"],
                        np.float32(self.params.buy_rating)
                        ).astype(np.float32)
        rates = RatingsData(rc["entity_id"], rc["target_entity_id"],
                            vals, rc["t"])
        return TrainingData(users=users, items=items, rate_events=rates)


class ECommercePreparator(Preparator):
    def prepare(self, td: TrainingData) -> PreparedData:
        return PreparedData(td)


@dataclass(frozen=True)
class ECommAlgorithmParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None   # the serve-time reads' channel
    unseen_only: bool = True
    seen_events: Tuple[str, ...] = ("buy", "view")
    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    alpha: float = 1.0
    seed: Optional[int] = None
    # products' operand dtype (ops/als.py ALSConfig); None = float32 on
    # the card and on the CPU, the reference's answer off the TPU
    compute_dtype: Optional[str] = None
    sweep_chunk: int = 0           # ALSConfig.sweep_chunk; 0 = auto (1)
    fuse_iteration: bool = False   # ALSConfig.fuse_iteration
    device: Optional[str] = None   # None = the card; "cpu" only if asked


@dataclass
class ECommerceModel:
    """The factor tables (host numpy) and their device copies, which
    serving reads: the raw tables for a known user's dot product, the
    normalized item table for the new-user fallback. A model restored
    from storage has no device until its algorithm places it."""
    rank: int
    user_factors: np.ndarray               # [U, R]
    item_factors: np.ndarray               # [I, R]
    item_factors_normalized: np.ndarray    # [I, R]
    user_ix: EntityIdIxMap
    item_ix: EntityIdIxMap
    items: Dict[str, Item]
    item_categories: List[Optional[set]]
    device: Optional[torch.device] = None
    _als: Optional[ALSModel] = field(default=None, repr=False,
                                     compare=False)
    _normalized: Optional[torch.Tensor] = field(default=None, repr=False,
                                                compare=False)

    def _require_device(self) -> torch.device:
        if self.device is None:
            raise RuntimeError(
                "this ECommerceModel was restored without a device; its "
                "algorithm's place_model puts it on one")
        return self.device

    def als(self) -> ALSModel:
        """The raw tables as an `ALSModel` on the model's device."""
        if self._als is None:
            self._als = ALSModel(self.user_factors, self.item_factors,
                                 self.rank, self._require_device())
        return self._als

    def table(self) -> torch.Tensor:
        """The normalized item table on the model's device."""
        if self._normalized is None:
            self._normalized = torch.tensor(self.item_factors_normalized,
                                            device=self._require_device())
        return self._normalized

    def place(self) -> None:
        """Upload every table serving reads (once)."""
        self.als().tables()
        self.table()


class ECommAlgorithm(P2LAlgorithm):
    PARAMS_CLASS = ECommAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[ECommAlgorithmParams] = None):
        super().__init__(params or ECommAlgorithmParams())
        self.last_train_telemetry: dict = {}

    @staticmethod
    def _build_ratings(td: TrainingData
                       ) -> Tuple[EntityIdIxMap, EntityIdIxMap, RatingsCOO]:
        """The users with rate/buy events, every `$set` or rated item, and
        the latest rating of each (user, item) (train-with-rate-event)."""
        if not len(td.rate_events):
            raise ValueError("No rate events to train on")
        rd = td.rate_events
        user_ix, ui = EntityIdIxMap.build_with_indices(rd.users)
        item_ix = EntityIdIxMap.build(np.concatenate(
            [np.array(list(td.items), dtype=str), rd.items.astype(str)]))
        ii = item_ix.to_indices_array(rd.items)
        ui, ii, vals = dedup_ratings(ui, ii, rd.vals, rd.ts, "latest")
        return user_ix, item_ix, RatingsCOO(ui, ii, vals, len(user_ix),
                                            len(item_ix))

    def train(self, pd: PreparedData) -> ECommerceModel:
        td = pd.td
        p = self.params
        user_ix, item_ix, coo = self._build_ratings(td)
        cfg = ALSConfig(rank=p.rank, iterations=p.num_iterations, lam=p.lam,
                        sweep_chunk=p.sweep_chunk,
                        fuse_iteration=p.fuse_iteration,
                        implicit_prefs=True,
                        alpha=p.alpha,
                        seed=p.seed if p.seed is not None else 0,
                        compute_dtype=p.compute_dtype or "float32")
        self.last_train_telemetry = {"ratings": coo.nnz}
        model = als_train(coo, cfg, device=p.device,
                          telemetry=self.last_train_telemetry)
        out = ECommerceModel(
            rank=p.rank, user_factors=model.user_factors,
            item_factors=model.item_factors,
            item_factors_normalized=normalize_rows(model.item_factors),
            user_ix=user_ix, item_ix=item_ix, items=dict(td.items),
            item_categories=ItemMetadataModel.derive_categories(td.items,
                                                                item_ix),
            device=model.device, _als=model)
        out.table()
        return out

    def place_model(self, model: ECommerceModel) -> ECommerceModel:
        """Upload a restored model's tables to this algorithm's device
        (`params.device`; None = the card), once, before it serves."""
        model.device = resolve_device(self.params.device)
        model.place()
        return model

    # -- live business rules (ALSAlgorithm.scala:161-215) ------------------
    def _seen_items(self, user: str) -> List[str]:
        if not self.params.unseen_only:
            return []
        try:
            events = LEventStore.find_by_entity(
                app_name=self.params.app_name,
                channel_name=self.params.channel_name, entity_type="user",
                entity_id=user, event_names=list(self.params.seen_events),
                target_entity_type="item",
                timeout_ms=POINT_READ_TIMEOUT_MS)
            return [e.target_entity_id for e in events
                    if e.target_entity_id]
        except Exception as e:
            logger.error("Error when reading seen events: %s", e)
            return []

    def _unavailable_items(self) -> List[str]:
        try:
            events = LEventStore.find_by_entity(
                app_name=self.params.app_name,
                channel_name=self.params.channel_name,
                entity_type="constraint", entity_id="unavailableItems",
                event_names=["$set"], limit=1, latest=True,
                timeout_ms=POINT_READ_TIMEOUT_MS)
            if events:
                return list(events[0].properties.get_string_list("items"))
        except Exception as e:
            logger.error("Error when reading unavailableItems: %s", e)
        return []

    def _build_mask(self, model: ECommerceModel, query: Query,
                    seen: List[str], unavailable: List[str]) -> np.ndarray:
        """Candidate mask shared by the single and batched paths: the
        query's black list, the live seen items and unavailableItems are
        excluded (ALSAlgorithm.scala:217-257)."""
        black = list(query.black_list or ()) + seen + unavailable
        white = (resolve_ids(model.item_ix, query.white_list)
                 if query.white_list is not None else None)
        return build_filter_mask(
            len(model.item_ix),
            exclude=resolve_ids(model.item_ix, black),
            white_list=white, item_categories=model.item_categories,
            categories=set(query.categories) if query.categories else None)

    def predict(self, model: ECommerceModel, query: Query
                ) -> ItemScoreResult:
        mask = self._build_mask(model, query, self._seen_items(query.user),
                                self._unavailable_items())
        uix = model.user_ix.get(query.user, -1)
        if uix >= 0:
            scores, idx = self._dot_topk(model, int(uix), query.num, mask)
            return top_scores_to_result(model.item_ix, scores, idx)
        logger.info("No userFeature found for user %s.", query.user)
        return self._predict_new_user(model, query, mask)

    @staticmethod
    def _dot_topk(model: ECommerceModel, uix: int, num: int,
                  mask: np.ndarray):
        """A known user's raw dot-product top-k (`recommend_products`),
        the excluded items at -inf; the reference keeps score > 0."""
        scores, idx = recommend_products(model.als(), uix, num,
                                         exclude=np.nonzero(~mask)[0])
        keep = np.isfinite(scores) & (scores > 0)
        return scores[keep], idx[keep]

    def _recent_view_indices(self, model: ECommerceModel,
                             user: str) -> np.ndarray:
        """Dense indices of the user's 10 most recent viewed items, the
        fallback's input (ALSAlgorithm.scala:283-364)."""
        try:
            recent = LEventStore.find_by_entity(
                app_name=self.params.app_name,
                channel_name=self.params.channel_name, entity_type="user",
                entity_id=user, event_names=["view"],
                target_entity_type="item", limit=10, latest=True,
                timeout_ms=POINT_READ_TIMEOUT_MS)
            recent_items = {e.target_entity_id for e in recent
                            if e.target_entity_id}
        except Exception as e:
            logger.error("Error when reading recent events: %s", e)
            recent_items = set()
        r_ix = resolve_ids(model.item_ix, sorted(recent_items))
        if len(r_ix) == 0:
            logger.info("No productFeatures vector for recent items %s.",
                        recent_items)
        return r_ix

    def _predict_new_user(self, model: ECommerceModel, query: Query,
                          mask: np.ndarray) -> ItemScoreResult:
        """The recent-views cosine fallback."""
        r_ix = self._recent_view_indices(model, query.user)
        if len(r_ix) == 0:
            return ItemScoreResult(())
        scores, idx = cosine_top_k(model.table(),
                                   model.item_factors_normalized[r_ix],
                                   query.num, mask)
        return top_scores_to_result(model.item_ix, scores, idx)

    def batch_predict(self, model: ECommerceModel, queries):
        """The batched path: `unavailableItems` is read once for the
        batch, the per-user reads run on a pool of at most 8 threads
        (I/O-bound, 200 ms each), and the batch needs at most two
        `masked_top_k_batch` calls: the known users' raw dot scores and
        the new users' summed cosines."""
        out = {ix: ItemScoreResult(()) for ix, _ in queries}
        unavailable = self._unavailable_items()
        known = []     # (ix, query, user_vec [R], mask [I])
        fallback = []  # (ix, query, qsum [R], mask [I])
        with ThreadPoolExecutor(max_workers=min(8, max(1, len(queries)))) \
                as pool:
            seen_futs = {ix: pool.submit(self._seen_items, q.user)
                         for ix, q in queries}
            recent_futs = {ix: pool.submit(self._recent_view_indices,
                                           model, q.user)
                           for ix, q in queries
                           if model.user_ix.get(q.user, -1) < 0}
            for ix, q in queries:
                mask = self._build_mask(model, q, seen_futs[ix].result(),
                                        unavailable)
                uix = model.user_ix.get(q.user, -1)
                if uix >= 0:
                    known.append((ix, q, model.user_factors[int(uix)],
                                  mask))
                    continue
                logger.info("No userFeature found for user %s.", q.user)
                recent = recent_futs[ix].result()
                if len(recent) == 0:
                    continue
                qsum = model.item_factors_normalized[recent].sum(axis=0)
                fallback.append((ix, q, qsum, mask))
        for rows, table in ((known, model.als().tables()[1]),
                            (fallback, model.table())):
            if not rows:
                continue
            scores, idx = masked_top_k_batch(
                table, np.stack([r[2] for r in rows]),
                np.stack([r[3] for r in rows]),
                max(q.num for _, q, _, _ in rows))
            for row, (ix, q, _, _) in enumerate(rows):
                s, i = unpack_top_k_rows(scores[row], idx[row], q.num)
                out[ix] = top_scores_to_result(model.item_ix, s, i)
        return list(out.items())


class ECommerceEngineFactory(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine({"": ECommerceDataSource}, {"": ECommercePreparator},
                      {"ecomm": ECommAlgorithm}, {"": FirstServing})

    @classmethod
    def engine_params(cls, key: str = "") -> EngineParams:
        return EngineParams(
            data_source_params=("", DataSourceParams()),
            preparator_params=("", None),
            algorithm_params_list=[("ecomm", ECommAlgorithmParams())],
            serving_params=("", None))
