"""Metadata records and the abstract DAO / event-store interfaces.

The port's copy of the part of `predictionio_tpu/data/storage/base.py`
that training, evaluation, deployment and event collection use: the
records `App`, `AccessKey`, `Channel`, `EngineInstance`,
`EvaluationInstance` and `Model` (the reference's Apps, AccessKeys,
Channels, EngineInstances, EvaluationInstances and Models DAOs), their
abstract DAOs, and `Events`, one
synchronous interface for the reference's LEvents (LEvents.scala:37) and
the bulk-read role of PEvents (PEvents.scala:35), with the default
`find_columnar` and `aggregate_properties` that a backend without a query
engine inherits, and `columnar_from_union_rows`, the merge an
entity-filtered pushdown (`find_columnar_by_entities`, the fold-in's
read) assembles its columns with.
"""

from __future__ import annotations

import abc
import datetime as _dt
import re
from dataclasses import dataclass, field, replace
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import \
    aggregate_properties as fold_properties
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event, from_millis, to_millis

# Sentinel for "filter requires this field to be absent" (the reference's
# Option[Option[String]] = Some(None) case in LEvents.futureFind).
ABSENT = object()

#: default rows per chunk of `Events.find_columnar_chunked`: ~256k rows
#: keep a chunk's wire columns at 10-25 MB while amortizing each window's
#: index seek
DEFAULT_CHUNK_ROWS = 262_144


# ---------------------------------------------------------------------------
# Metadata records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class App:
    id: int
    name: str
    description: Optional[str] = None


@dataclass(frozen=True)
class AccessKey:
    key: str
    appid: int
    events: Sequence[str] = ()  # whitelist; empty = all events allowed


_CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")


@dataclass(frozen=True)
class Channel:
    id: int
    name: str  # unique within an app
    appid: int

    NAME_CONSTRAINT = ("Only alphanumeric and - characters are allowed and "
                       "max length is 16.")

    def __post_init__(self):
        if not Channel.is_valid_name(self.name):
            raise ValueError(f"Invalid channel name: {self.name}. "
                             f"{Channel.NAME_CONSTRAINT}")

    @staticmethod
    def is_valid_name(name: str) -> bool:
        return bool(_CHANNEL_NAME_RE.match(name))


@dataclass(frozen=True)
class EngineInstance:
    """One training run record (EngineInstances.scala:43-58)."""
    id: str
    status: str
    start_time: _dt.datetime
    end_time: _dt.datetime
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    spark_conf: Dict[str, str] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""

    def with_(self, **kw) -> "EngineInstance":
        return replace(self, **kw)


@dataclass(frozen=True)
class EvaluationInstance:
    """One evaluation run record (EvaluationInstances.scala)."""
    id: str = ""
    status: str = ""
    start_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc))
    end_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc))
    evaluation_class: str = ""
    engine_params_generator_class: str = ""
    batch: str = ""
    env: Dict[str, str] = field(default_factory=dict)
    spark_conf: Dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""

    def with_(self, **kw) -> "EvaluationInstance":
        return replace(self, **kw)


@dataclass(frozen=True)
class Model:
    """Serialized trained model blob (Models.scala:30)."""
    id: str
    models: bytes


# ---------------------------------------------------------------------------
# Metadata DAO interfaces
# ---------------------------------------------------------------------------

class Apps(abc.ABC):
    @abc.abstractmethod
    def insert(self, app: App) -> Optional[int]:
        """Insert; returns the generated id when app.id == 0."""

    @abc.abstractmethod
    def get(self, app_id: int) -> Optional[App]: ...

    @abc.abstractmethod
    def get_by_name(self, name: str) -> Optional[App]: ...

    @abc.abstractmethod
    def get_all(self) -> List[App]: ...

    @abc.abstractmethod
    def update(self, app: App) -> bool: ...

    @abc.abstractmethod
    def delete(self, app_id: int) -> bool: ...


class AccessKeys(abc.ABC):
    @abc.abstractmethod
    def insert(self, k: AccessKey) -> Optional[str]:
        """Insert; generates a random key when k.key is empty."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[AccessKey]: ...

    @abc.abstractmethod
    def get_all(self) -> List[AccessKey]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[AccessKey]: ...

    @abc.abstractmethod
    def update(self, k: AccessKey) -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class Channels(abc.ABC):
    @abc.abstractmethod
    def insert(self, channel: Channel) -> Optional[int]: ...

    @abc.abstractmethod
    def get(self, channel_id: int) -> Optional[Channel]: ...

    @abc.abstractmethod
    def get_by_app_id(self, app_id: int) -> List[Channel]: ...

    @abc.abstractmethod
    def delete(self, channel_id: int) -> bool: ...


class EngineInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EngineInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def get_latest_completed(self, engine_id: str, engine_version: str,
                             engine_variant: str
                             ) -> Optional[EngineInstance]: ...

    @abc.abstractmethod
    def get_completed(self, engine_id: str, engine_version: str,
                      engine_variant: str) -> List[EngineInstance]: ...

    @abc.abstractmethod
    def update(self, i: EngineInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class EvaluationInstances(abc.ABC):
    @abc.abstractmethod
    def insert(self, i: EvaluationInstance) -> str: ...

    @abc.abstractmethod
    def get(self, instance_id: str) -> Optional[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_all(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def get_completed(self) -> List[EvaluationInstance]: ...

    @abc.abstractmethod
    def update(self, i: EvaluationInstance) -> bool: ...

    @abc.abstractmethod
    def delete(self, instance_id: str) -> bool: ...


class Models(abc.ABC):
    @abc.abstractmethod
    def insert(self, model: Model) -> None: ...

    @abc.abstractmethod
    def get(self, model_id: str) -> Optional[Model]: ...

    @abc.abstractmethod
    def delete(self, model_id: str) -> bool: ...


# ---------------------------------------------------------------------------
# Event store interface (LEvents + PEvents unified, synchronous)
# ---------------------------------------------------------------------------

class Events(abc.ABC):
    """Event CRUD + query per (appId, channelId) namespace (LEvents.scala
    :50-164 and the bulk-read role of PEvents.scala:77)."""

    @abc.abstractmethod
    def init(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Initialize storage for an (app, channel) namespace."""

    @abc.abstractmethod
    def remove(self, app_id: int, channel_id: Optional[int] = None) -> bool:
        """Remove all events of a namespace."""

    def close(self) -> None:
        pass

    @abc.abstractmethod
    def insert(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Insert one event; returns its eventId."""

    def insert_batch(self, events: Sequence[Event], app_id: int,
                     channel_id: Optional[int] = None) -> List[str]:
        return [self.insert(e, app_id, channel_id) for e in events]

    def insert_columnar(self, batch, app_id: int,
                        channel_id: Optional[int] = None) -> List[str]:
        """Bulk write from a `ColumnarBatch` of parallel arrays. The
        default builds `Event` objects and rides `insert_batch`; a
        backend with a vectorized path overrides it."""
        return self.insert_batch(batch.to_events(), app_id, channel_id)

    @abc.abstractmethod
    def get(self, event_id: str, app_id: int,
            channel_id: Optional[int] = None) -> Optional[Event]: ...

    @abc.abstractmethod
    def delete(self, event_id: str, app_id: int,
               channel_id: Optional[int] = None) -> bool: ...

    @abc.abstractmethod
    def find(self, app_id: int, channel_id: Optional[int] = None,
             start_time: Optional[_dt.datetime] = None,
             until_time: Optional[_dt.datetime] = None,
             entity_type: Optional[str] = None,
             entity_id: Optional[str] = None,
             event_names: Optional[Sequence[str]] = None,
             target_entity_type=None,  # str | ABSENT | None
             target_entity_id=None,    # str | ABSENT | None
             limit: Optional[int] = None,
             reversed_order: bool = False) -> Iterator[Event]:
        """Query events (LEvents.futureFind semantics, LEvents.scala:164).

        `target_entity_type=ABSENT` matches events with no target entity
        (the reference's Some(None)); `None` means no filter. `limit=-1`
        means no limit. `reversed_order` sorts by eventTime descending."""

    def find_columnar(self, app_id: int,
                      channel_id: Optional[int] = None,
                      property_field: Optional[str] = None,
                      **filters) -> Dict[str, np.ndarray]:
        """Columnar bulk read for training: {'entity_id',
        'target_entity_id', 'event', 't', 'prop'} as flat numpy arrays.
        `prop` is float32 (NaN where `property_field` is missing) and only
        present when `property_field` is given; `t` is event-time millis.
        Backends with a query engine override this with a projected scan;
        this default streams `find`."""
        return events_to_columnar(
            self.find(app_id, channel_id=channel_id, **filters),
            property_field)

    def find_columnar_chunked(self, app_id: int,
                              channel_id: Optional[int] = None,
                              property_field: Optional[str] = None,
                              chunk_rows: Optional[int] = None,
                              start_time: Optional[_dt.datetime] = None,
                              until_time: Optional[_dt.datetime] = None,
                              **filters) -> Iterator[Dict[str, np.ndarray]]:
        """Streaming columnar read: a generator of `find_columnar`-shaped
        column dicts of about `chunk_rows` rows each (default
        `DEFAULT_CHUNK_ROWS`), in ascending event time; the bulk data
        plane's cursor (`dataplane.reader.ChunkReader` drains it).

        A chunk ends only at a complete millisecond: a millisecond's rows
        are never split across chunks, and a single-millisecond burst
        larger than `chunk_rows` comes back whole as one oversized chunk.
        So the chunks concatenate to exactly one `find_columnar` call over
        the same range, each backend's order within a millisecond kept.
        It is a forward cursor, not a snapshot: rows inserted mid-stream
        at or after the cursor are seen, rows behind it are not.

        This default is keyset pagination through `find_columnar` (the
        `start_time` cursor and `limit`), which SQLite answers from its
        time index. `reversed_order` and `limit` are refused: bound the
        stream by `until_time`."""
        if filters.pop("reversed_order", False):
            raise ValueError(
                "find_columnar_chunked streams ascending event time only")
        if filters.pop("limit", None) not in (None, -1):
            raise ValueError(
                "find_columnar_chunked is unbounded; bound by until_time")
        chunk_rows = int(chunk_rows or DEFAULT_CHUNK_ROWS)
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        cursor = start_time
        while True:
            cols = self.find_columnar(
                app_id, channel_id=channel_id,
                property_field=property_field, start_time=cursor,
                until_time=until_time, limit=chunk_rows + 1, **filters)
            t = cols["t"]
            if len(t) <= chunk_rows:
                # no more than a chunk is left past the cursor: the last
                if len(t):
                    yield cols
                return
            last = int(t[-1])
            cut = int(np.searchsorted(t, last, side="left"))
            if cut == 0:
                # the whole window is one millisecond, larger than a
                # chunk: read that millisecond whole, never split it
                cols = self.find_columnar(
                    app_id, channel_id=channel_id,
                    property_field=property_field,
                    start_time=from_millis(last),
                    until_time=from_millis(last + 1), limit=-1, **filters)
                if len(cols["t"]):
                    yield cols
                cursor = from_millis(last + 1)
            else:
                # drop the trailing, possibly incomplete millisecond: the
                # next window reads it whole
                yield {k: v[:cut] for k, v in cols.items()}
                cursor = from_millis(last)

    def aggregate_properties(self, app_id: int,
                             channel_id: Optional[int] = None,
                             entity_type: str = "",
                             start_time: Optional[_dt.datetime] = None,
                             until_time: Optional[_dt.datetime] = None,
                             required: Optional[Sequence[str]] = None
                             ) -> Dict[str, PropertyMap]:
        """Aggregate $set/$unset/$delete into per-entity PropertyMaps
        (LEvents.futureAggregateProperties / PEvents.aggregateProperties)."""
        events = self.find(
            app_id=app_id, channel_id=channel_id, start_time=start_time,
            until_time=until_time, entity_type=entity_type,
            event_names=list(aggregate_event_names()))
        result = fold_properties(events)
        if required:
            req = set(required)
            result = {k: v for k, v in result.items()
                      if req.issubset(v.key_set)}
        return result


def aggregate_event_names():
    return ("$set", "$unset", "$delete")


def columnar_from_union_rows(rows_by_id: Dict[str, tuple],
                             property_field: Optional[str] = None,
                             limit: Optional[int] = None
                             ) -> Dict[str, np.ndarray]:
    """The `find_columnar` columns of an entity-union read: `rows_by_id`
    maps event id -> (entityid, targetentityid, event, eventtime[,
    prop]), so a row that matched both the entity and the target side
    counts once. Sorted by event time (stable: equal times keep the
    order the rows were read in), `limit` applied after the merge."""
    rows = sorted(rows_by_id.values(), key=lambda r: int(r[3]))
    if limit is not None and limit >= 0:
        rows = rows[:limit]
    if not rows:
        out = {"entity_id": np.array([], dtype=str),
               "target_entity_id": np.array([], dtype=str),
               "event": np.array([], dtype=str),
               "t": np.array([], dtype=np.int64)}
        if property_field is not None:
            out["prop"] = np.array([], dtype=np.float32)
        return out
    ents, tgts, names, ts, *rest = zip(*rows)
    out = {
        "entity_id": np.array(ents, dtype=str),
        "target_entity_id": np.array([x or "" for x in tgts], dtype=str),
        "event": np.array(names, dtype=str),
        "t": np.array([int(t) for t in ts], dtype=np.int64),
    }
    if property_field is not None:
        out["prop"] = np.array(
            [np.nan if v is None else float(v) for v in rest[0]],
            dtype=np.float32)
    return out


def events_to_columnar(events, property_field: Optional[str] = None
                       ) -> Dict[str, np.ndarray]:
    """[Event] -> the `find_columnar` column dict."""
    ents: list = []
    tgts: list = []
    names: list = []
    ts: list = []
    props: list = []
    for e in events:
        ents.append(e.entity_id)
        tgts.append(e.target_entity_id or "")
        names.append(e.event)
        ts.append(to_millis(e.event_time))
        if property_field is not None:
            v = e.properties.get_opt(property_field, float)
            props.append(np.nan if v is None else v)
    out = {
        "entity_id": np.array(ents, dtype=str),
        "target_entity_id": np.array(tgts, dtype=str),
        "event": np.array(names, dtype=str),
        "t": np.array(ts, dtype=np.int64),
    }
    if property_field is not None:
        out["prop"] = np.array(props, dtype=np.float32)
    return out


def match_event(e: Event,
                start_time=None, until_time=None, entity_type=None,
                entity_id=None, event_names=None, target_entity_type=None,
                target_entity_id=None) -> bool:
    """The find() filter semantics as a predicate, for backends that
    cannot push filters down."""
    if start_time is not None and e.event_time < start_time:
        return False
    if until_time is not None and e.event_time >= until_time:
        return False
    if entity_type is not None and e.entity_type != entity_type:
        return False
    if entity_id is not None and e.entity_id != entity_id:
        return False
    if event_names is not None and e.event not in event_names:
        return False
    if target_entity_type is not None:
        if target_entity_type is ABSENT:
            if e.target_entity_type is not None:
                return False
        elif e.target_entity_type != target_entity_type:
            return False
    if target_entity_id is not None:
        if target_entity_id is ABSENT:
            if e.target_entity_id is not None:
                return False
        elif e.target_entity_id != target_entity_id:
            return False
    return True
