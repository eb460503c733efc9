"""The event model and its validation rules.

The port's copy of `predictionio_tpu/data/event.py`: the immutable
`Event` record (entity, optional target entity, JSON properties, event
time; Event.scala:39-57) and its JSON wire format (`to_dict`/`to_json`,
`from_dict`/`from_json`, `format_event_time`: the reference's
EventJson4sSupport.APISerializer), millisecond time conversions,
event-id minting, and `EventValidation`, the reserved-name rules for the
special `$set`/`$unset`/`$delete` events and the `pio_` prefix
(Event.scala:65-163).
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import threading as _threading
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

from predictionio_tpu_torch.data.datamap import DataMap

UTC = _dt.timezone.utc


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def to_millis(t: _dt.datetime) -> int:
    return int(t.timestamp() * 1000)


def from_millis(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=UTC)


def parse_event_time(s: str) -> _dt.datetime:
    """Parse an ISO-8601 timestamp (the wire format of eventTime)."""
    t = _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t


def format_event_time(t: _dt.datetime) -> str:
    """ISO-8601 with milliseconds, the reference's wire format."""
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    base = t.strftime("%Y-%m-%dT%H:%M:%S")
    ms = t.microsecond // 1000
    off = t.utcoffset() or _dt.timedelta(0)
    if off == _dt.timedelta(0):
        tz = "Z"
    else:
        total = int(off.total_seconds())
        sign = "+" if total >= 0 else "-"
        total = abs(total)
        tz = f"{sign}{total // 3600:02d}:{(total % 3600) // 60:02d}"
    return f"{base}.{ms:03d}{tz}"


@dataclass(frozen=True)
class Event:
    """One event in the event store (Event.scala:39-57)."""

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=utcnow)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=utcnow)
    event_id: Optional[str] = None

    def with_id(self, event_id: str, minted: bool = False) -> "Event":
        """A copy carrying `event_id`. `minted` (the id is fresh random
        hex this process made) is taken for the reference's signature and
        not kept: only the spill WAL reads it there, and the port has no
        spill until `resilience/` is ported."""
        return replace(self, event_id=event_id)

    # -- the JSON wire format (EventJson4sSupport.APISerializer) -----------
    def to_dict(self) -> dict:
        d = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "targetEntityType": self.target_entity_type,
            "targetEntityId": self.target_entity_id,
            "properties": self.properties.fields,
            "eventTime": format_event_time(self.event_time),
            "tags": list(self.tags),
            "prId": self.pr_id,
            "creationTime": format_event_time(self.creation_time),
        }
        return {k: v for k, v in d.items() if v is not None}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        for name in ("event", "entityType", "entityId"):
            if name not in d:
                raise ValueError(f"field {name} is required")
        props = d.get("properties") or {}
        if not isinstance(props, dict):
            raise ValueError("field properties must be a JSON object")
        now = utcnow()
        return cls(
            event=d["event"],
            entity_type=d["entityType"],
            entity_id=str(d["entityId"]),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=(str(d["targetEntityId"])
                              if d.get("targetEntityId") is not None
                              else None),
            properties=DataMap(props),
            event_time=(parse_event_time(d["eventTime"])
                        if d.get("eventTime") else now),
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            creation_time=(parse_event_time(d["creationTime"])
                           if d.get("creationTime") else now),
            event_id=d.get("eventId"),
        )

    @classmethod
    def from_json(cls, s: str) -> "Event":
        return cls.from_dict(json.loads(s))


_id_pool = _threading.local()


def new_event_id() -> str:
    """128 random bits as 32 lowercase hex digits, drawn 128 ids at a
    time into a thread-local pool."""
    off = getattr(_id_pool, "off", None)
    buf = getattr(_id_pool, "buf", None)
    if buf is None or off >= len(buf):
        buf = _id_pool.buf = os.urandom(2048).hex()
        off = 0
    _id_pool.off = off + 32
    return buf[off:off + 32]


def new_event_ids(n: int) -> list:
    """`n` fresh event ids (the shape of `new_event_id`) in one urandom
    draw, for the columnar bulk write."""
    hexes = os.urandom(16 * n).hex()
    return [hexes[i << 5:(i + 1) << 5] for i in range(n)]


class EventValidation:
    """Validation rules for events (Event.scala:65-163)."""

    SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
    BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
    BUILTIN_PROPERTIES: frozenset = frozenset()

    @staticmethod
    def is_reserved_prefix(name: str) -> bool:
        return name.startswith("$") or name.startswith("pio_")

    @classmethod
    def is_special_event(cls, name: str) -> bool:
        return name in cls.SPECIAL_EVENTS

    @classmethod
    def is_builtin_entity_type(cls, name: str) -> bool:
        return name in cls.BUILTIN_ENTITY_TYPES

    @classmethod
    def validate(cls, e: Event) -> None:
        def require(cond: bool, msg: str) -> None:
            if not cond:
                raise ValueError(msg)

        require(bool(e.event), "event must not be empty.")
        require(bool(e.entity_type), "entityType must not be empty string.")
        require(bool(e.entity_id), "entityId must not be empty string.")
        require(e.target_entity_type is None or bool(e.target_entity_type),
                "targetEntityType must not be empty string")
        require(e.target_entity_id is None or bool(e.target_entity_id),
                "targetEntityId must not be empty string.")
        require((e.target_entity_type is None) == (e.target_entity_id is None),
                "targetEntityType and targetEntityId must be specified "
                "together.")
        require(not (e.event == "$unset" and e.properties.is_empty()),
                "properties cannot be empty for $unset event")
        require(not cls.is_reserved_prefix(e.event)
                or cls.is_special_event(e.event),
                f"{e.event} is not a supported reserved event name.")
        require(not cls.is_special_event(e.event)
                or (e.target_entity_type is None
                    and e.target_entity_id is None),
                f"Reserved event {e.event} cannot have targetEntity")
        require(not cls.is_reserved_prefix(e.entity_type)
                or cls.is_builtin_entity_type(e.entity_type),
                f"The entityType {e.entity_type} is not allowed. "
                "'pio_' is a reserved name prefix.")
        require(e.target_entity_type is None
                or not cls.is_reserved_prefix(e.target_entity_type)
                or cls.is_builtin_entity_type(e.target_entity_type),
                f"The targetEntityType {e.target_entity_type} is not "
                "allowed. 'pio_' is a reserved name prefix.")
        for k in e.properties.key_set:
            require(not cls.is_reserved_prefix(k)
                    or k in cls.BUILTIN_PROPERTIES,
                    f"The property {k} is not allowed. "
                    "'pio_' is a reserved name prefix.")
