"""Batch views over the event stream.

The port's copy of `predictionio_tpu/data/view.py`, the reference's view
layer (view/{LBatchView,PBatchView,DataView}.scala):

  - `BatchView`: a materialized snapshot of an app's events with filter,
    aggregate-properties and time-ordered per-entity folds
    (LBatchView.scala:104-200, PBatchView's aggregation);
  - `data_view`: the raw events as a flat fixed-schema column table;
  - `create_view`: DataView.create (DataView.scala:58-109). A user
    conversion maps each Event to a typed record (or None to drop it);
    the records become a named-column numpy table, cached on disk under
    `$PIO_FS_BASEDIR/view` keyed by a hash of the time range and the
    version (the reference's parquet cache becomes an .npz).

All three read through the port's `EventStore`, so any registered
events backend serves them. Views are host numpy tables: nothing here
touches the card.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import hashlib
import os
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.aggregator import aggregate_properties
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event, to_millis
from predictionio_tpu_torch.data.store.event_store import EventStore


class BatchView:
    """Materialized snapshot of an app's events (LBatchView/PBatchView)."""

    def __init__(self, app_name: str, store: Optional[EventStore] = None,
                 channel_name: Optional[str] = None,
                 start_time: Optional[_dt.datetime] = None,
                 until_time: Optional[_dt.datetime] = None):
        store = store or EventStore()
        self.events = list(store.find(
            app_name=app_name, channel_name=channel_name,
            start_time=start_time, until_time=until_time))

    def aggregate_properties(self, entity_type: str,
                             start_time: Optional[_dt.datetime] = None,
                             until_time: Optional[_dt.datetime] = None
                             ) -> Dict[str, PropertyMap]:
        """Per-entity property state, optionally bounded to a time window
        (LBatchView.aggregateProperties, :156-171)."""
        return aggregate_properties(
            e for e in self.filter(entity_type=entity_type,
                                   start_time=start_time,
                                   until_time=until_time))

    def filter(self, **kw) -> Sequence[Event]:
        from predictionio_tpu_torch.data.storage.base import match_event
        return [e for e in self.events if match_event(e, **kw)]

    def aggregate_by_entity_ordered(self, init, op: Callable,
                                    **filters) -> Dict[str, object]:
        """Fold events per entity in event-time order
        (EventSeq.aggregateByEntityOrdered, LBatchView.scala:121-127):
        ``op(acc, event) -> acc`` starting from ``init`` for each
        entityId."""
        groups: Dict[str, list] = {}
        for e in self.filter(**filters):
            groups.setdefault(e.entity_id, []).append(e)
        out = {}
        for eid, evs in groups.items():
            evs.sort(key=lambda e: to_millis(e.event_time))
            acc = init
            for e in evs:
                acc = op(acc, e)
            out[eid] = acc
        return out


class ColumnarView:
    """Named-column numpy table — the DataFrame analog of DataView.create.
    Columns are flat arrays; rows are aligned across columns."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        lens = {len(v) for v in columns.values()}
        if len(lens) > 1:
            raise ValueError("ragged columns: "
                             f"{ {k: len(v) for k, v in columns.items()} }")
        self.columns = dict(columns)

    @property
    def names(self):
        return list(self.columns)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def filter(self, mask: np.ndarray) -> "ColumnarView":
        return ColumnarView({k: v[mask] for k, v in self.columns.items()})

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self.columns)

    @staticmethod
    def load(path: str) -> "ColumnarView":
        with np.load(path, allow_pickle=False) as z:
            return ColumnarView({k: z[k] for k in z.files})


def _records_to_columns(records) -> Dict[str, np.ndarray]:
    """Typed records (dataclass / namedtuple / mapping) -> column arrays.
    Numeric fields become float64/int64 columns; everything else becomes a
    unicode column."""
    first = records[0]
    if dataclasses.is_dataclass(first):
        names = [f.name for f in dataclasses.fields(first)]
        get = lambda r, n: getattr(r, n)            # noqa: E731
    elif hasattr(first, "_fields"):                  # namedtuple
        names = list(first._fields)
        get = lambda r, n: getattr(r, n)            # noqa: E731
    elif isinstance(first, Mapping):
        names = list(first)
        get = lambda r, n: r[n]                     # noqa: E731
    else:
        raise TypeError(
            "conversion must return a dataclass, namedtuple, or mapping; "
            f"got {type(first).__name__}")
    cols = {}
    for n in names:
        vals = [get(r, n) for r in records]
        v0 = vals[0]
        if isinstance(v0, bool):
            cols[n] = np.array(vals, dtype=bool)
        elif isinstance(v0, int):
            cols[n] = np.array(vals, dtype=np.int64)
        elif isinstance(v0, float):
            cols[n] = np.array(vals, dtype=np.float64)
        else:
            cols[n] = np.array([str(v) for v in vals], dtype=str)
    return cols


def create_view(app_name: str,
                conversion: Callable[[Event], Optional[object]],
                name: str = "", version: str = "",
                channel_name: Optional[str] = None,
                start_time: Optional[_dt.datetime] = None,
                until_time: Optional[_dt.datetime] = None,
                store: Optional[EventStore] = None,
                cache_dir: Optional[str] = None) -> ColumnarView:
    """DataView.create analog (reference: view/DataView.scala:58-109):
    apply ``conversion`` to every event (None drops the event), build a
    named-column table, and cache it on disk keyed by a hash of the fixed
    time range and ``version`` (bump ``version`` whenever the conversion
    changes, exactly the reference's contract). ``until_time`` defaults to
    now, *fixed at first call*, so the cache key is stable."""
    end_time = until_time or _dt.datetime.now(_dt.timezone.utc)
    key = hashlib.sha1(
        f"{start_time}-{end_time}-{version}".encode()).hexdigest()[:12]
    base = cache_dir or os.path.join(
        os.environ.get("PIO_FS_BASEDIR",
                       os.path.expanduser("~/.pio_store")), "view")
    path = os.path.join(base, f"{name}-{app_name}-{key}.npz")
    if os.path.exists(path):
        return ColumnarView.load(path)
    store = store or EventStore()
    records = [r for e in store.find(app_name=app_name,
                                     channel_name=channel_name,
                                     start_time=start_time,
                                     until_time=end_time)
               if (r := conversion(e)) is not None]
    view = ColumnarView(_records_to_columns(records) if records else {})
    os.makedirs(base, exist_ok=True)
    view.save(path)
    return view


def data_view(app_name: str, store: Optional[EventStore] = None,
              channel_name: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Flattened columnar view of events (DataView.create -> DataFrame,
    view/DataView.scala:58): columns eventId/event/entityType/entityId/
    targetEntityType/targetEntityId/eventTimeMillis/prId."""
    store = store or EventStore()
    events = list(store.find(app_name=app_name, channel_name=channel_name))
    def col(f, dtype=object):
        return np.array([f(e) for e in events], dtype=dtype)
    return {
        "eventId": col(lambda e: e.event_id or ""),
        "event": col(lambda e: e.event),
        "entityType": col(lambda e: e.entity_type),
        "entityId": col(lambda e: e.entity_id),
        "targetEntityType": col(lambda e: e.target_entity_type or ""),
        "targetEntityId": col(lambda e: e.target_entity_id or ""),
        "eventTimeMillis": col(lambda e: to_millis(e.event_time),
                               dtype=np.int64),
        "prId": col(lambda e: e.pr_id or ""),
    }
