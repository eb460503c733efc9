"""Recommendation engine template: explicit ALS on rate/buy events.

The port's counterpart of `predictionio_tpu/models/recommendation.py`
(`Rating`, `TrainingData`, `Query`, `PreparedData`, `DataSourceParams`,
`RecommendationDataSource._read_ratings/_ratings_from_cols/_read_items`,
`RecommendationPreparator`, `ALSAlgorithmParams`, `RecommendationModel`
with its query filters, `ALSAlgorithm.train/predict/batch_predict/
batch_predict_begin` and the engine factory). The data source reads
rate/buy events from the event store (a buy counts as `buy_rating`;
duplicate ratings keep the latest event) and, for the filter variants,
the items' `$set` properties; a query may ask for `categories` and
`creationYear`.

A data source may also be handed `RatingsData` arrays through its params
(`DataSourceParams.ratings`); such params have no JSON form, so an
engine instance (`workflow.run_train`) cannot be trained from them.

Online fold-in (`online/`): `read_training_touched` reads only the
touched users' and items' complete histories (and the touched items'
properties) through the store's entity pushdown, and
`ALSAlgorithm.fold_in` re-solves only those rows of a deployed model
(`online/fold_in.fold_in_coo`), replaying the preparator's dedup and
exclusion list on grown vocabularies.

Evaluation: with `eval_k` set, `read_eval` splits the rating rows into
k folds by row index modulo k; each fold trains on the others and asks
one query a test-fold user (`eval_query_num` items), whose held-out
ratings are the `ActualResult`. `PrecisionAtK` is the template's tuning
metric.

The streamed read: with `DataSourceParams.stream` (or, when it is None,
`PIO_DATAPLANE_STREAM` set to 1/true/yes/on) the training and evaluation
reads go through the bulk data plane (`dataplane/`): chunked store
cursors decoded chunk by chunk while the interned ids, values and times
double-buffer onto `DataSourceParams.device` (the card unless the caller
names the CPU). The `RatingsData` is built from the decoded host chunks,
row for row the batch read, as in the reference; the staged segments are
not used by the train.

The sharded layout: `ALSAlgorithmParams.factor_sharding='model'` trains,
folds and serves the factor tables as `parallel/sharded_table.
ShardedTable`s split `model_shards` ways (0: one shard a process) over
`parallel/mesh.model_mesh`; `MeshALSAlgorithm` (algorithm name
`als-mesh`) always does, and persists them through
`ShardedALSModelCheckpoint` (one file a shard and a manifest,
`utils/checkpoint.py`) instead of the model blob.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core import (DataSource, Engine, EngineFactory,
                                         EngineParams, FirstServing, Metric,
                                         P2LAlgorithm, Params,
                                         PersistentModel,
                                         PersistentModelLoader, Preparator,
                                         SanityCheck)
from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.bimap import EntityIdIxMap
from predictionio_tpu_torch.data.storage.base import aggregate_event_names
from predictionio_tpu_torch.data.store import PEventStore
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.common import (ItemScoreResult,
                                                  RatingRow, RatingsData,
                                                  top_scores_to_result)
from predictionio_tpu_torch.online.fold_in import FoldInConfig, fold_in_coo
from predictionio_tpu_torch.ops.als import (ALSConfig, ALSModel, als_rmse,
                                            als_train, recommend_products,
                                            recommend_products_sharded,
                                            users_topk_serve_begin)
from predictionio_tpu_torch.parallel.sharded_table import (gather_rows,
                                                           is_sharded)
from predictionio_tpu_torch.ops.ratings import RatingsCOO, dedup_ratings
from predictionio_tpu_torch.ops.solve import COUNTS
from predictionio_tpu_torch.ops.similarity import (build_filter_mask,
                                                   masked_top_k_batch,
                                                   masked_top_k_batch_begin,
                                                   unpack_top_k_rows)
from predictionio_tpu_torch.compile import buckets as B

logger = logging.getLogger(__name__)

#: queries a batched top-k of `ALSAlgorithm.batch_predict` (evaluation)
EVAL_CHUNK = 8192


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
    items: Optional[dict] = None  # id -> property dict (read_items)
    # an entity-filtered read (read_training_touched): only the touched
    # entities' complete histories, input to a fold-in, never to a train
    touched_only: bool = False

    def __post_init__(self):
        if isinstance(self.ratings, (list, tuple)):
            self.ratings = RatingsData.from_rows(self.ratings)

    def sanity_check(self):
        if not len(self.ratings):
            raise ValueError("ratings is empty; check the data source")


@dataclass(frozen=True)
class Query:
    """The base query is (user, num); the custom-query and
    filter-by-category variants add creationYear and categories
    (custom-query/Engine.scala:6, filter-by-category/Engine.scala:6-10)."""
    user: str
    num: int
    categories: Optional[Tuple[str, ...]] = None
    creation_year: Optional[int] = None

    @staticmethod
    def from_dict(d: dict) -> "Query":
        """Raises KeyError for a missing field, ValueError/TypeError for a
        malformed one (the server answers 400 for both)."""
        cats = d.get("categories")
        return Query(user=str(d["user"]), num=int(d["num"]),
                     categories=tuple(cats) if cats is not None else None,
                     creation_year=(int(d["creationYear"])
                                    if d.get("creationYear") is not None
                                    else None))


@dataclass
class PreparedData:
    ratings_coo: RatingsCOO
    user_ix: EntityIdIxMap
    item_ix: EntityIdIxMap
    items: Optional[dict] = None  # id -> property dict


@dataclass(frozen=True, eq=False)
class DataSourceParams(Params):
    app_name: str = "default"
    channel_name: Optional[str] = None
    event_names: Tuple[str, ...] = ("rate", "buy")
    buy_rating: float = 4.0  # the rating a buy event counts as
    # custom-query / filter-by-category variants: read the items' $set
    # properties (categories, creationYear, ...) for the query filters
    read_items: bool = False
    eval_k: Optional[int] = None    # k-fold read_eval when set
    eval_query_num: int = 10        # each eval query's num
    # the training ratings themselves, instead of the event store
    ratings: Optional[RatingsData] = None
    # the bulk data plane: stream the store read through chunked cursors
    # and double-buffered device staging. None defers to
    # PIO_DATAPLANE_STREAM. The streamed read equals the batch read row
    # for row, so this moves time, never results.
    stream: Optional[bool] = None
    # where a streamed read stages (None: the card)
    device: Optional[str] = None


@dataclass(frozen=True)
class ActualResult:
    """The ratings the test fold holds for the queried user (the
    evaluation's ground truth), in row order."""
    ratings: Tuple[RatingRow, ...]


class RecommendationDataSource(DataSource):
    PARAMS_CLASS = DataSourceParams

    def __init__(self, params: Optional[DataSourceParams] = None):
        super().__init__(params or DataSourceParams())

    def _read_ratings(self) -> RatingsData:
        """One projected scan into flat numpy arrays (DataSource.scala
        :20-46 eventsRDD -> ratingsRDD, without per-event objects), or
        the same rows streamed through the bulk data plane."""
        p = self.params
        if self._stream_active():
            return self._read_ratings_streamed()
        cols = PEventStore.find_columnar(
            app_name=p.app_name, channel_name=p.channel_name,
            property_field="rating", entity_type="user",
            target_entity_type="item", event_names=list(p.event_names))
        return self._ratings_from_cols(cols, p)

    def _stream_active(self) -> bool:
        if self.params.stream is not None:
            return bool(self.params.stream)
        return os.environ.get("PIO_DATAPLANE_STREAM", "").lower() in (
            "1", "true", "yes", "on")

    def _read_ratings_streamed(self) -> RatingsData:
        """The same read through the bulk data plane: chunks decoded one
        by one (overlapped with the reader thread) while the numeric
        training columns double-buffer onto the device. The chunks never
        split a millisecond and every conversion is row-wise, so the
        concatenation is row for row the one-shot scan."""
        from predictionio_tpu_torch.dataplane import (BulkLoadExecutor,
                                                      StreamInterner)
        p = self.params
        users_in, items_in = StreamInterner(), StreamInterner()

        def decode(chunk):
            return self._ratings_from_cols(chunk, p)

        def encode(rd):
            # interned dense ids now; remap_to_sorted reconciles them
            # with the preparator's sorted vocabulary at the end
            return {"user_ix": users_in.encode(rd.users),
                    "item_ix": items_in.encode(rd.items),
                    "vals": rd.vals, "t": rd.ts}

        result = BulkLoadExecutor(device=p.device).run(
            p.app_name, channel_name=p.channel_name,
            property_field="rating", decode=decode, encode=encode,
            entity_type="user", target_entity_type="item",
            event_names=list(p.event_names))
        st = result.stats
        logger.info(
            "streamed ratings read: %d rows / %d chunks, read %.2fs "
            "decode %.2fs h2d %.1f MB overlap %.0f%% builds(steady) %d",
            st.rows, st.chunks, st.read_s, st.decode_s,
            st.h2d_bytes / 1e6, 100.0 * st.h2d_overlap_frac,
            st.steady_compiles)
        parts = result.decoded
        if not parts:
            return RatingsData(
                np.array([], dtype=str), np.array([], dtype=str),
                np.array([], dtype=np.float32),
                np.array([], dtype=np.int64))
        return RatingsData(
            np.concatenate([r.users for r in parts]),
            np.concatenate([r.items for r in parts]),
            np.concatenate([r.vals for r in parts]),
            np.concatenate([r.ts for r in parts]))

    @staticmethod
    def _ratings_from_cols(cols, p) -> RatingsData:
        is_rate = cols["event"] == "rate"
        missing = is_rate & np.isnan(cols["prop"])
        if missing.any():
            raise ValueError(
                f"{int(missing.sum())} 'rate' event(s) lack the required "
                f"'rating' property (first entity: "
                f"{cols['entity_id'][missing][0]!r})")
        vals = np.where(is_rate, cols["prop"],
                        np.float32(p.buy_rating)).astype(np.float32)
        return RatingsData(cols["entity_id"], cols["target_entity_id"],
                           vals, cols["t"])

    def _read_items(self) -> Optional[dict]:
        if not self.params.read_items:
            return None
        return {eid: dict(pm.fields) for eid, pm in
                PEventStore.aggregate_properties(
                    app_name=self.params.app_name,
                    channel_name=self.params.channel_name,
                    entity_type="item").items()}

    def read_training(self) -> TrainingData:
        if self.params.ratings is not None:
            return TrainingData(self.params.ratings)
        return TrainingData(self._read_ratings(), items=self._read_items())

    def read_eval(self):
        """k folds of the rating rows by row index modulo k; one query a
        test-fold user, sorted by user id, with that user's held-out
        ratings as the actual."""
        p = self.params
        if not p.eval_k:
            return []
        ratings = (p.ratings if p.ratings is not None
                   else self._read_ratings())
        row_ix = np.arange(len(ratings))
        folds = []
        for fold in range(p.eval_k):
            test_mask = (row_ix % p.eval_k) == fold
            test = ratings.select(test_mask)
            # a stable sort by user keeps each user's rows in row order
            order = np.argsort(test.users, kind="stable")
            users = test.users[order]
            starts = np.flatnonzero(np.r_[True, users[1:] != users[:-1]]
                                    )[:len(users)]
            rows = list(map(RatingRow, users.tolist(),
                            test.items[order].tolist(),
                            test.vals[order].tolist(),
                            test.ts[order].tolist()))
            ends = np.r_[starts[1:], len(rows)].tolist()
            qa = [(Query(user=rows[lo].user, num=p.eval_query_num),
                   ActualResult(tuple(rows[lo:hi])))
                  for lo, hi in zip(starts.tolist(), ends)]
            folds.append((TrainingData(ratings.select(~test_mask)), None,
                          qa))
        return folds

    def read_training_touched(self, touched_users,
                              touched_items) -> TrainingData:
        """The fold tick's entity-filtered read: the touched users'
        complete rating histories and every rating on a touched item (the
        rows the touched-row solves consume, so their dedup and
        regularizers see whole histories), and the touched items'
        properties, through the store's pushdown
        (`find_columnar_by_entities`), not a corpus scan."""
        p = self.params
        cols = PEventStore.find_columnar_by_entities(
            app_name=p.app_name, channel_name=p.channel_name,
            entity_ids=[str(u) for u in touched_users],
            target_entity_ids=[str(i) for i in touched_items],
            property_field="rating", entity_type="user",
            target_entity_type="item", event_names=list(p.event_names))
        items = None
        if p.read_items:
            items = self._read_items_for([str(i) for i in touched_items])
        return TrainingData(self._ratings_from_cols(cols, p), items=items,
                            touched_only=True)

    def _read_items_for(self, item_ids) -> dict:
        """$set/$unset/$delete folded for the given items only: a point
        read an item, the app and channel resolved once."""
        app_id, channel_id = PEventStore.resolve(self.params.app_name,
                                                 self.params.channel_name)
        events = []
        for iid in item_ids:
            events.extend(PEventStore.events.find(
                app_id=app_id, channel_id=channel_id, entity_type="item",
                entity_id=iid, event_names=list(aggregate_event_names())))
        return {eid: dict(pm.fields)
                for eid, pm in aggregate_properties(events).items()}


@dataclass(frozen=True)
class PreparatorParams(Params):
    dedup: str = "latest"
    # custom-prepartor variant (Preparator.scala:13-27): newline-separated
    # item ids excluded from training before the vocabulary is built
    exclude_items_file: Optional[str] = None


def excluded_items(params: PreparatorParams) -> List[str]:
    """The sorted ids of `exclude_items_file` (none without one)."""
    if not params.exclude_items_file:
        return []
    with open(params.exclude_items_file) as f:
        return sorted({line.strip() for line in f if line.strip()})


class RecommendationPreparator(Preparator):
    """Builds the sorted vocabularies and the deduplicated COO."""
    PARAMS_CLASS = PreparatorParams

    def __init__(self, params: Optional[PreparatorParams] = None):
        super().__init__(params or PreparatorParams())

    def prepare(self, td: TrainingData) -> PreparedData:
        rd = td.ratings
        no_train = excluded_items(self.params)
        if no_train:
            rd = rd.select(~np.isin(rd.items, no_train))
        user_ix, ui = EntityIdIxMap.build_with_indices(rd.users)
        item_ix, ii = EntityIdIxMap.build_with_indices(rd.items)
        ui, ii, vals = dedup_ratings(ui, ii, rd.vals, rd.ts,
                                     self.params.dedup)
        coo = RatingsCOO(ui, ii, vals, len(user_ix), len(item_ix))
        return PreparedData(coo, user_ix, item_ix, items=td.items)


@dataclass(frozen=True)
class ALSAlgorithmParams(Params):
    rank: int = 10
    num_iterations: int = 10
    lam: float = 0.01
    seed: Optional[int] = None
    # products' operand dtype (ops/als.py ALSConfig); None = float32 on
    # the card and on the CPU, the reference's answer off the TPU
    compute_dtype: Optional[str] = None
    # custom-query variant: property keys copied onto each ItemScore in
    # the result JSON (e.g. ("creationYear",)); needs read_items
    return_properties: Tuple[str, ...] = ()
    sweep_chunk: int = 0           # ALSConfig.sweep_chunk; 0 = auto (1)
    fuse_iteration: bool = False   # ALSConfig.fuse_iteration
    solver: str = "auto"           # ops/solve.py spd_solve
    device: Optional[str] = None   # None = the card; "cpu" only if asked
    # 'model' trains, folds and serves the factor tables split by rows
    # over the mesh's model axis (module docstring); 'replicated' keeps
    # one whole table
    factor_sharding: str = "replicated"
    model_shards: int = 0          # S with 'model'; 0 = one a process


@dataclass
class RecommendationModel:
    als: ALSModel
    user_ix: EntityIdIxMap
    item_ix: EntityIdIxMap
    # by dense item index; present when the data source read items
    item_properties: Optional[List[Optional[dict]]] = None
    # derived at train time, so a query's mask is vectorized
    item_categories: Optional[List[Optional[set]]] = None
    item_years: Optional[np.ndarray] = None  # float32, NaN = undated

    @staticmethod
    def derive_filters(item_properties):
        if item_properties is None:
            return None, None
        cats = [set(p["categories"]) if p and p.get("categories") else None
                for p in item_properties]
        years = np.array(
            [float(p["creationYear"])
             if p and p.get("creationYear") is not None else np.nan
             for p in item_properties], dtype=np.float32)
        return cats, years

    def properties_of(self, keys: Tuple[str, ...]):
        """ItemScore property passthrough: the requested keys are always
        present (missing -> None/null, the Option[Int] wire shape of
        custom-query/Engine.scala:12)."""
        if not keys or self.item_properties is None:
            return None
        props = self.item_properties

        def get(ix: int):
            p = props[ix] or {}
            return {k: p.get(k) for k in keys}
        return get

    def allowed_mask(self, query: Query) -> Optional[np.ndarray]:
        """Candidate mask of the filter variants; None = no filtering.
        categories: an item must share one (an empty list filters
        nothing); creationYear: undated items pass, dated items need a
        year >= the query's (custom-query/ALSAlgorithm.scala:141-148)."""
        want_cats = set(query.categories) if query.categories else None
        if want_cats is None and query.creation_year is None:
            return None
        mask = build_filter_mask(len(self.item_ix),
                                 item_categories=self.item_categories,
                                 categories=want_cats)
        if query.creation_year is not None and self.item_years is not None:
            dated = ~np.isnan(self.item_years)
            mask &= ~(dated & (self.item_years < query.creation_year))
        return mask


class ALSAlgorithm(P2LAlgorithm):
    """Explicit ALS: train on the device, predict = top-k by u . v."""
    PARAMS_CLASS = ALSAlgorithmParams
    QUERY_CLASS = Query

    def __init__(self, params: Optional[ALSAlgorithmParams] = None):
        super().__init__(params or ALSAlgorithmParams())
        self.last_train_telemetry: dict = {}

    @property
    def sharded(self) -> bool:
        """Whether this algorithm trains the model-sharded layout."""
        return self.params.factor_sharding == "model"

    def mesh(self):
        """The process-wide mesh of the sharded layout on this
        algorithm's device: `model_shards` wide, or one shard a
        process."""
        from predictionio_tpu_torch.parallel.mesh import (model_mesh,
                                                          world_size)
        return model_mesh(self.params.model_shards or world_size(),
                          self.params.device)

    def train(self, pd: PreparedData) -> RecommendationModel:
        p = self.params
        if pd.ratings_coo.nnz == 0:
            raise ValueError("No ratings to train on")
        cfg = ALSConfig(rank=p.rank, iterations=p.num_iterations, lam=p.lam,
                        seed=p.seed if p.seed is not None else 0,
                        solver=p.solver,
                        compute_dtype=p.compute_dtype or "float32",
                        sweep_chunk=p.sweep_chunk,
                        fuse_iteration=p.fuse_iteration,
                        factor_sharding=("model" if self.sharded
                                         else "replicated"),
                        keep_sharded=self.sharded)
        self.last_train_telemetry = {"ratings": pd.ratings_coo.nnz}
        mesh = {"mesh": self.mesh()} if self.sharded else {}
        model = als_train(pd.ratings_coo, cfg, device=p.device,
                          telemetry=self.last_train_telemetry, **mesh)
        item_properties = None
        if pd.items is not None:
            item_properties = [pd.items.get(pd.item_ix.id_of(ix))
                               for ix in range(len(pd.item_ix))]
        cats, years = RecommendationModel.derive_filters(item_properties)
        return RecommendationModel(model, pd.user_ix, pd.item_ix,
                                   item_properties=item_properties,
                                   item_categories=cats, item_years=years)

    def place_model(self, model: RecommendationModel
                    ) -> RecommendationModel:
        """Upload a restored model's tables to this algorithm's device
        (`params.device`; None = the card), once, before it serves. A
        sharded model uploads its item table's shards; its user rows are
        read from the host mirrors."""
        als = model.als
        als.device = resolve_device(self.params.device)
        if is_sharded(als.item_factors):
            from predictionio_tpu_torch.parallel.mesh import model_mesh
            als.item_factors.device(model_mesh(als.item_factors.n_shards,
                                               als.device))
        else:
            als.tables()
        return model

    @staticmethod
    def _item_table(als: ALSModel):
        """The item table the masked top-k ranks: the sharded table
        itself, or the whole table on the device."""
        return (als.item_factors if is_sharded(als.item_factors)
                else als.tables()[1])

    def predict(self, model: RecommendationModel, query: Query
                ) -> ItemScoreResult:
        uix = model.user_ix.get(query.user, -1)
        if uix < 0:
            logger.info("No prediction for unknown user %s.", query.user)
            return ItemScoreResult(())
        props_of = model.properties_of(self.params.return_properties)
        mask = model.allowed_mask(query)
        if mask is None:
            top = (recommend_products_sharded
                   if is_sharded(model.als.item_factors)
                   else recommend_products)
            scores, idx = top(model.als, uix, query.num)
            return top_scores_to_result(model.item_ix, scores, idx,
                                        properties_of=props_of)
        scores, idx = masked_top_k_batch(
            self._item_table(model.als),
            gather_rows(model.als.user_factors, [uix]), mask[None],
            query.num, filter_positive=False, device=model.als.device)
        s, i = unpack_top_k_rows(scores[0], idx[0], query.num)
        return top_scores_to_result(model.item_ix, s, i,
                                    properties_of=props_of)

    def batch_predict(self, model: RecommendationModel, queries):
        """`batch_predict_begin(...)()` over chunks of `EVAL_CHUNK`
        queries: an evaluation asks one query a user, and one top-k over
        all of them would hold a [users, items] score table."""
        queries = list(queries)
        out = []
        for lo in range(0, len(queries), EVAL_CHUNK):
            out.extend(self.batch_predict_begin(
                model, queries[lo:lo + EVAL_CHUNK])())
        return out

    def batch_predict_begin(self, model: RecommendationModel, queries):
        """The serve window's predict, in two stages: partition the
        queries into known users without filters (one batched top-k,
        `users_topk_serve_begin`) and those whose query carries filters
        (one masked batched top-k, `masked_top_k_batch_begin`), enqueue
        both now and return `finish() -> [(ix, result)]`, which waits for
        their results and builds the answers (it may run on another
        thread)."""
        props_of = model.properties_of(self.params.return_properties)
        out = {ix: ItemScoreResult(()) for ix, _ in queries}
        plain, masked = [], []
        for ix, q in queries:
            uix = model.user_ix.get(q.user, -1)
            if uix < 0:
                logger.info("No prediction for unknown user %s.", q.user)
                continue
            mask = model.allowed_mask(q)
            (plain if mask is None else masked).append((ix, q, uix, mask))
        fetches = []
        if plain:
            fetches.append((plain, users_topk_serve_begin(
                model.als, [uix for _, _, uix, _ in plain],
                min(max(q.num for _, q, _, _ in plain), model.als.n_items))))
        if masked:
            fetches.append((masked, masked_top_k_batch_begin(
                self._item_table(model.als),
                gather_rows(model.als.user_factors,
                            [uix for _, _, uix, _ in masked]),
                np.stack([mask for _, _, _, mask in masked]),
                max(q.num for _, q, _, _ in masked), filter_positive=False,
                device=model.als.device)))

        def finish():
            for rows, fetch in fetches:
                scores, idx = fetch()
                for row, (ix, q, _, _) in enumerate(rows):
                    s, i = unpack_top_k_rows(scores[row], idx[row], q.num)
                    out[ix] = top_scores_to_result(model.item_ix, s, i,
                                                   properties_of=props_of)
            return list(out.items())
        return finish

    def fold_data(self, model: RecommendationModel, td: TrainingData,
                  touched_users, touched_items,
                  preparator_params: Optional[PreparatorParams] = None):
        """What a fold of `td` into `model` solves: (grown user map, grown
        item map, the deduplicated COO on them, touched user indices,
        touched item indices). The preparator's exclusion list and dedup
        are replayed (prepare() itself would rebuild the vocabularies and
        move the deployed dense indices); only entities with ratings
        grow, so a property-only `$set` of an unseen id mints no zero
        row."""
        prep = preparator_params or PreparatorParams()
        rd = td.ratings
        no_train = excluded_items(prep)
        if no_train:
            rd = rd.select(~np.isin(rd.items, no_train))
            excluded = set(no_train)
            touched_items = [i for i in touched_items
                             if str(i) not in excluded]
        present_u = set(np.unique(rd.users).astype(str))
        present_i = set(np.unique(rd.items).astype(str))
        user_ix, _ = model.user_ix.grow(
            u for u in map(str, touched_users) if u in present_u)
        item_ix, _ = model.item_ix.grow(
            i for i in map(str, touched_items) if i in present_i)
        ui = user_ix.to_indices_array(rd.users)
        ii = item_ix.to_indices_array(rd.items)
        keep = (ui >= 0) & (ii >= 0)
        ui, ii, vals = dedup_ratings(ui[keep], ii[keep], rd.vals[keep],
                                     rd.ts[keep], prep.dedup)
        coo = RatingsCOO(ui, ii, vals, len(user_ix), len(item_ix))
        tu = user_ix.to_indices([str(u) for u in touched_users])
        ti = item_ix.to_indices([str(i) for i in touched_items])
        return user_ix, item_ix, coo, tu[tu >= 0], ti[ti >= 0]

    def fold_config(self, sharded: bool = False) -> FoldInConfig:
        """The fold's solve config from this algorithm's params: two
        sweeps, the solver left at 'auto' as the reference's template
        leaves it (so the card's CG kernel), the train's compute dtype,
        and the layout of the model it folds into."""
        p = self.params
        return FoldInConfig(lam=p.lam, sweeps=2,
                            compute_dtype=p.compute_dtype or "float32",
                            sweep_chunk=p.sweep_chunk,
                            factor_sharding=("model" if sharded
                                             else "replicated"))

    def fold_in(self, model: RecommendationModel, td: TrainingData,
                touched_users, touched_items,
                preparator_params: Optional[PreparatorParams] = None
                ) -> Tuple[RecommendationModel, dict]:
        """Absorb fresh events without a retrain: grow the vocabularies
        with the touched entities that have ratings, then re-solve only
        the touched rows against `td`, the current data of those entities
        (`fold_data`, `online/fold_in.fold_in_coo`, the train's ALS-WR
        equations). New items carry `td`'s properties, or None. Returns
        (new model, report); the report's loss is what the scheduler's
        drift gate reads, `solverCalls` and `launches` what the fold ran
        on its device. A tick with nothing solvable returns `model`
        itself."""
        user_ix, item_ix, coo, tu, ti = self.fold_data(
            model, td, touched_users, touched_items, preparator_params)
        before = dict(vars(COUNTS))
        new_als, stats = fold_in_coo(
            model.als, coo, tu, ti,
            self.fold_config(is_sharded(model.als.user_factors)),
            device=resolve_device(self.params.device),
            resident_key=f"fold:{type(self).__name__}:{id(self)}")
        if stats.degenerate:
            return model, {"algorithm": type(self).__name__,
                           "degenerate": True, "wallS": stats.wall_s}
        item_properties = model.item_properties
        if item_properties is not None and len(item_ix) > len(
                item_properties):
            items = td.items or {}
            item_properties = list(item_properties) + [
                items.get(item_ix.id_of(ix))
                for ix in range(len(item_properties), len(item_ix))]
        cats, years = RecommendationModel.derive_filters(item_properties)
        new_model = RecommendationModel(
            new_als, user_ix, item_ix, item_properties=item_properties,
            item_categories=cats, item_years=years)
        report = {
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
        if stats.sharded:
            report["sharding"] = {"layout": "model",
                                  "shards": new_als.user_factors.n_shards}
        return new_model, report

    def aot_warm_specs(self, model: RecommendationModel,
                       batch_hint: int = 16) -> list:
        """(label, dims, owners) rows of the serve executables over the
        micro-batcher's pow2 ladder (1 up to the window) at the smallest
        top-k bucket: what `compile.aot.warm_models` captures at deploy
        and swap time, before the model takes a query. The reference
        warms the plain top-k only; the port also warms the masked one a
        filtered query takes, as its deploy warm-up always has. A sharded
        model's rows carry its shard layout (`s`); across processes the
        ranking gathers its candidates by a collective, which no graph
        holds, so nothing is warmed."""
        from predictionio_tpu_torch.obs import costmon
        from predictionio_tpu_torch.ops import als as ALS
        from predictionio_tpu_torch.ops import similarity as SIM
        from predictionio_tpu_torch.parallel.mesh import world_size
        if world_size() > 1:
            return []
        ALS.register_aot_specs()
        SIM.register_aot_specs()
        als = model.als
        ladder = B.batch_ladder(batch_hint)
        table = self._item_table(als)

        def masked_dims(b):
            dims = SIM.masked_topk_dims(als.n_items, als.rank, b,
                                        B.K_FLOOR, filter_positive=False)
            if is_sharded(table):
                i_b = ALS.batch_predict_dims(als, b, B.K_FLOOR)["i"]
                dims.update(i=i_b, k=min(dims["k"], i_b), s=table.n_shards)
            return dims
        return ([(costmon.BATCH_PREDICT,
                  ALS.batch_predict_dims(als, b, B.K_FLOOR), (als,))
                 for b in ladder]
                + [(costmon.BATCH_PREDICT_MASKED, masked_dims(b), (table,))
                   for b in ladder])


class ShardedALSModelCheckpoint(PersistentModel, PersistentModelLoader):
    """The sharded layout's persistence: the factor tables are written
    one file a shard with a manifest (`utils/checkpoint.save_sharded`,
    under `checkpoint_dir(instance_id)`), the id maps beside them, and
    only a manifest naming this loader goes into the model store. The
    item properties go beside them (`items.json`; the reference's
    checkpoint drops them, so its restored model serves no filter), and
    the query filters are derived from them again on a restore. A
    restore re-shards to the reader's shard count (its algorithm's
    `model_shards`, else the saved count) and keeps the shards its
    process holds."""

    def __init__(self, model: Optional[RecommendationModel] = None):
        self.model = model

    def save(self, instance_id: str, params) -> bool:
        from predictionio_tpu_torch.parallel.mesh import process_index
        from predictionio_tpu_torch.utils.checkpoint import (checkpoint_dir,
                                                             save_sharded)
        d = checkpoint_dir(instance_id)
        ok = save_sharded(os.path.join(d, "factors"),
                          {"user_factors": self.model.als.user_factors,
                           "item_factors": self.model.als.item_factors})
        if process_index() == 0:
            np.savez(os.path.join(d, "vocab.npz"),
                     users=np.asarray(self.model.user_ix.ids, dtype=str),
                     items=np.asarray(self.model.item_ix.ids, dtype=str))
            if self.model.item_properties is not None:
                with open(os.path.join(d, "items.json"), "w") as f:
                    json.dump(self.model.item_properties, f)
        return ok

    def load(self, instance_id: str, params) -> RecommendationModel:
        from predictionio_tpu_torch.data.bimap import BiMap
        from predictionio_tpu_torch.parallel.mesh import model_mesh
        from predictionio_tpu_torch.utils.checkpoint import (
            MANIFEST, checkpoint_dir, restore_sharded)
        d = checkpoint_dir(instance_id)
        path = os.path.join(d, "factors")
        shards = getattr(params, "model_shards", 0)
        if not shards:
            with open(os.path.join(path, MANIFEST)) as f:
                shards = max(ent.get("shards", 1)
                             for ent in json.load(f).values())
        mesh = model_mesh(shards, getattr(params, "device", None))
        tables = restore_sharded(path, {"user_factors": mesh,
                                        "item_factors": mesh})
        with np.load(os.path.join(d, "vocab.npz")) as z:
            user_ix = EntityIdIxMap(BiMap(
                {str(u): i for i, u in enumerate(z["users"])}))
            item_ix = EntityIdIxMap(BiMap(
                {str(it): i for i, it in enumerate(z["items"])}))
        props = None
        if os.path.exists(os.path.join(d, "items.json")):
            with open(os.path.join(d, "items.json")) as f:
                props = json.load(f)
        cats, years = RecommendationModel.derive_filters(props)
        uf, vf = tables["user_factors"], tables["item_factors"]
        return RecommendationModel(ALSModel(uf, vf, uf.rank, None),
                                   user_ix, item_ix, item_properties=props,
                                   item_categories=cats, item_years=years)


class MeshALSAlgorithm(ALSAlgorithm):
    """The sharded placement (the reference's PAlgorithm role,
    engine.json algorithm name `als-mesh`): the factor tables are
    trained, folded and served split over the mesh's model axis whatever
    `factor_sharding` says, and persist through
    `ShardedALSModelCheckpoint` rather than the model blob."""
    placement = "mesh"

    @property
    def sharded(self) -> bool:
        return True

    def make_persistent_model(self, model: RecommendationModel):
        return ShardedALSModelCheckpoint(model)


class PrecisionAtK(Metric):
    """Precision@K with a positive-rating threshold (the template's
    tuning metric): a query whose actuals hold no positive is skipped,
    an empty answer scores 0."""

    def __init__(self, k: int = 10, rating_threshold: float = 2.0):
        self.k = k
        self.rating_threshold = rating_threshold

    def header(self) -> str:
        return f"PrecisionAtK(k={self.k}, threshold={self.rating_threshold})"

    def calculate(self, eval_data) -> float:
        vals = []
        for _, qpa in eval_data:
            for q, p, a in qpa:
                positives = {r.item for r in a.ratings
                             if r.rating >= self.rating_threshold}
                if not positives:
                    continue
                top = [s.item for s in p.item_scores[:self.k]]
                if not top:
                    vals.append(0.0)
                    continue
                hits = sum(1 for item in top if item in positives)
                vals.append(hits / min(self.k, len(top)))
        return float("nan") if not vals else float(np.mean(vals))


class RecommendationEngineFactory(EngineFactory):
    @classmethod
    def apply(cls) -> Engine:
        return Engine({"": RecommendationDataSource},
                      {"": RecommendationPreparator},
                      {"als": ALSAlgorithm, "als-mesh": MeshALSAlgorithm},
                      {"": FirstServing})

    @classmethod
    def engine_params(cls, ratings: RatingsData,
                      algorithm: Optional[ALSAlgorithmParams] = None,
                      preparator: Optional[PreparatorParams] = None
                      ) -> EngineParams:
        """Params that train on `ratings` arrays (not the event store)."""
        return EngineParams(
            data_source_params=("", DataSourceParams(ratings=ratings)),
            preparator_params=("", preparator or PreparatorParams()),
            algorithm_params_list=[("als",
                                    algorithm or ALSAlgorithmParams())],
            serving_params=("", None))
