"""Columnar event batches: the bulk-write form of many events.

The port's copy of `ColumnarBatch` from `predictionio_tpu/data/columnar.py`:
one object of parallel arrays instead of n event objects. A column is a
per-row list of length `n`, a scalar broadcast to every row, or `None`
(absent); `entity_id` is always a list and anchors `n`. `eventTime`
values are ISO-8601 strings (None = the time of the write). The bulk
import `Events.insert_columnar` takes one.
"""

from __future__ import annotations

from typing import List

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import (Event, parse_event_time,
                                               utcnow)


class ColumnarBatch:
    """Normalized parallel-array event batch."""

    __slots__ = ("n", "event", "entity_type", "entity_id",
                 "target_entity_type", "target_entity_id", "properties",
                 "event_time", "event_id")

    def __init__(self, n, event, entity_type, entity_id,
                 target_entity_type=None, target_entity_id=None,
                 properties=None, event_time=None, event_id=None):
        self.n = n
        self.event = event
        self.entity_type = entity_type
        self.entity_id = entity_id
        self.target_entity_type = target_entity_type
        self.target_entity_id = target_entity_id
        self.properties = properties
        self.event_time = event_time
        self.event_id = event_id

    def cell(self, name: str, i: int):
        col = getattr(self, name)
        if col is None or isinstance(col, str):
            return col            # absent or broadcast scalar
        return col[i]

    def row_event(self, i: int, default_time=None) -> Event:
        """Row `i` as an `Event` (the default `insert_columnar` path)."""
        t = self.cell("event_time", i)
        props = None if self.properties is None else self.properties[i]
        kwargs = {}
        if self.event_id is not None:
            kwargs["event_id"] = self.event_id[i]
        return Event(
            event=self.cell("event", i),
            entity_type=self.cell("entity_type", i),
            entity_id=self.entity_id[i],
            target_entity_type=self.cell("target_entity_type", i) or None,
            target_entity_id=(None if self.target_entity_id is None
                              else self.target_entity_id[i] or None),
            properties=DataMap(props or {}),
            event_time=(parse_event_time(t) if t
                        else (default_time or utcnow())),
            **kwargs)

    def to_events(self) -> List[Event]:
        now = utcnow()
        return [self.row_event(i, default_time=now) for i in range(self.n)]
