"""Property aggregation: fold `$set/$unset/$delete` events into PropertyMaps.

The port's copy of `predictionio_tpu/data/aggregator.py` (the
reference's `EventOp` monoid, PEventAggregator.scala and
LEventAggregator.scala:39). The fold is a commutative, associative merge:
the order of events does not matter, only their event times do.

Semantics:
  - `$set`    records each property value with its event time; merge keeps
              the latest-time value per key, and the latest overall set time.
  - `$unset`  records an unset time per key; a key is dropped if its unset
              time is >= its set time.
  - `$delete` drops the whole entity if delete time >= last set time;
              otherwise drops keys whose set time is <= delete time.
  - first/last updated track min/max event time over the special events.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event, to_millis

SPECIAL_EVENTS = ("$set", "$unset", "$delete")


@dataclass(frozen=True)
class _SetProp:
    # key -> (json value, set time millis)
    fields: Dict[str, Tuple[Any, int]]
    t: int  # latest set time (valid even with empty fields)

    def merge(self, other: "_SetProp") -> "_SetProp":
        combined = dict(self.fields)
        for k, (v, t) in other.fields.items():
            if k not in combined or t > combined[k][1]:
                combined[k] = (v, t)
        return _SetProp(combined, max(self.t, other.t))


@dataclass(frozen=True)
class _UnsetProp:
    fields: Dict[str, int]  # key -> latest unset time millis

    def merge(self, other: "_UnsetProp") -> "_UnsetProp":
        combined = dict(self.fields)
        for k, t in other.fields.items():
            if k not in combined or t > combined[k]:
                combined[k] = t
        return _UnsetProp(combined)


@dataclass(frozen=True)
class EventOp:
    """Mergeable aggregation state for one entity."""

    set_prop: Optional[_SetProp] = None
    unset_prop: Optional[_UnsetProp] = None
    delete_t: Optional[int] = None
    first_updated: Optional[_dt.datetime] = None
    last_updated: Optional[_dt.datetime] = None

    @staticmethod
    def from_event(e: Event) -> "EventOp":
        t = to_millis(e.event_time)
        if e.event == "$set":
            return EventOp(
                set_prop=_SetProp({k: (v, t) for k, v in e.properties.items()}, t),
                first_updated=e.event_time, last_updated=e.event_time)
        if e.event == "$unset":
            return EventOp(
                unset_prop=_UnsetProp({k: t for k in e.properties.key_set}),
                first_updated=e.event_time, last_updated=e.event_time)
        if e.event == "$delete":
            return EventOp(delete_t=t,
                           first_updated=e.event_time, last_updated=e.event_time)
        return EventOp()

    def merge(self, other: "EventOp") -> "EventOp":
        def opt_merge(a, b, f):
            if a is None:
                return b
            if b is None:
                return a
            return f(a, b)

        return EventOp(
            set_prop=opt_merge(self.set_prop, other.set_prop,
                               lambda a, b: a.merge(b)),
            unset_prop=opt_merge(self.unset_prop, other.unset_prop,
                                 lambda a, b: a.merge(b)),
            delete_t=opt_merge(self.delete_t, other.delete_t, max),
            first_updated=opt_merge(self.first_updated, other.first_updated, min),
            last_updated=opt_merge(self.last_updated, other.last_updated, max),
        )

    def to_property_map(self) -> Optional[PropertyMap]:
        """Resolve to the final PropertyMap, or None if never-$set / deleted."""
        if self.set_prop is None:
            return None
        set_fields = self.set_prop.fields
        unset_keys = set()
        if self.unset_prop is not None:
            unset_keys = {k for k, ut in self.unset_prop.fields.items()
                          if k in set_fields and ut >= set_fields[k][1]}
        if self.delete_t is not None:
            if self.delete_t >= self.set_prop.t:
                return None
            delete_keys = {k for k, (_, st) in set_fields.items()
                           if self.delete_t >= st}
        else:
            delete_keys = set()
        final = {k: v for k, (v, _) in set_fields.items()
                 if k not in unset_keys and k not in delete_keys}
        assert self.first_updated is not None and self.last_updated is not None
        return PropertyMap(final, self.first_updated, self.last_updated)


def aggregate_properties(events: Iterable[Event]) -> Dict[str, PropertyMap]:
    """Fold special events into per-entity PropertyMaps, keyed by entityId.

    Entities whose final state is deleted (or never ``$set``) are omitted,
    matching PEventAggregator.aggregateProperties (PEventAggregator.scala:198).
    """
    ops: Dict[str, EventOp] = {}
    for e in events:
        if e.event not in SPECIAL_EVENTS:
            continue
        op = EventOp.from_event(e)
        prev = ops.get(e.entity_id)
        ops[e.entity_id] = op if prev is None else prev.merge(op)
    out: Dict[str, PropertyMap] = {}
    for entity_id, op in ops.items():
        pm = op.to_property_map()
        if pm is not None:
            out[entity_id] = pm
    return out


def merge_aggregations(parts: Iterable[Dict[str, EventOp]]
                       ) -> Dict[str, EventOp]:
    """Merge per-partition aggregation states (entity -> `EventOp`), as
    the reference's aggregateByKey combines its partitions."""
    merged: Dict[str, EventOp] = {}
    for part in parts:
        for k, op in part.items():
            prev = merged.get(k)
            merged[k] = op if prev is None else prev.merge(op)
    return merged
