"""Columnar event batches: the bulk-write form of many events.

The port's copy of `predictionio_tpu/data/columnar.py`: one object of
parallel arrays instead of n event objects. A column is a per-row list of
length `n`, a scalar broadcast to every row, or `None` (absent);
`entity_id` is always a list and anchors `n`. `eventTime` values are
ISO-8601 strings (None = the time of the write). The bulk import
`Events.insert_columnar` takes one.

The wire body of the event server's `POST /events/columnar.json`:

    {"event":            "rate" | [...n],
     "entityType":       "user" | [...n],
     "entityId":         [...n],                     (required, the anchor)
     "targetEntityType": str | [...n] | null,
     "targetEntityId":   [...n] | null,
     "properties":       [{...} ...n] | null,
     "eventTime":        iso8601 | [...n] | null,    (null = server now)
     "eventId":          [...n] | null}              (null = server mints)

`normalize_columnar` shape-checks one (a malformed table rejects the
whole request) and `validate_rows` applies `EventValidation` row by row,
so a bad row is a per-record 4xx while the good rows land.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import (Event, EventValidation,
                                               format_event_time,
                                               parse_event_time, utcnow)

#: columns that may be a scalar (broadcast) or a per-row list
_BROADCAST = ("event", "entity_type", "target_entity_type", "event_time")

_WIRE_KEYS = {
    "event": "event",
    "entityType": "entity_type",
    "entityId": "entity_id",
    "targetEntityType": "target_entity_type",
    "targetEntityId": "target_entity_id",
    "properties": "properties",
    "eventTime": "event_time",
    "eventId": "event_id",
}


class ColumnarBatch:
    """Normalized parallel-array event batch."""

    __slots__ = ("n", "event", "entity_type", "entity_id",
                 "target_entity_type", "target_entity_id", "properties",
                 "event_time", "event_id", "minted")

    def __init__(self, n, event, entity_type, entity_id,
                 target_entity_type=None, target_entity_id=None,
                 properties=None, event_time=None, event_id=None,
                 minted=False):
        self.n = n
        self.event = event
        self.entity_type = entity_type
        self.entity_id = entity_id
        self.target_entity_type = target_entity_type
        self.target_entity_id = target_entity_id
        self.properties = properties
        self.event_time = event_time
        self.event_id = event_id
        #: True when this process minted `event_id` (the event server's
        #: pre-assign): fresh distinct lowercase hex, so nativelog keeps
        #: its minted-id fast path (no escaping, no dedup, no overwrite
        #: probe). Never set for ids that came over the wire.
        self.minted = minted

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

    def to_wire(self) -> dict:
        """The JSON wire body of this batch (the remote events DAO sends
        `insert_columnar` as one POST)."""
        return {wire: getattr(self, attr)
                for wire, attr in _WIRE_KEYS.items()
                if getattr(self, attr) is not None}

    def slice_rows(self, lo: int, hi: int) -> "ColumnarBatch":
        """Rows [lo, hi) as a new batch (list slices, so nativelog's
        pipelined bulk write and the remote DAO's pages cut cheaply)."""

        def cut(col):
            if col is None or isinstance(col, str):
                return col
            return col[lo:hi]

        return ColumnarBatch(
            hi - lo, cut(self.event), cut(self.entity_type),
            self.entity_id[lo:hi], cut(self.target_entity_type),
            cut(self.target_entity_id), cut(self.properties),
            cut(self.event_time), cut(self.event_id), minted=self.minted)

    def select(self, keep: Sequence[int]) -> "ColumnarBatch":
        """A new batch holding only the ``keep`` rows (the write route
        compacts away per-record rejections before the bulk insert)."""

        def pick(col):
            if col is None or isinstance(col, str):
                return col
            return [col[i] for i in keep]

        return ColumnarBatch(
            len(keep), pick(self.event), pick(self.entity_type),
            pick(self.entity_id), pick(self.target_entity_type),
            pick(self.target_entity_id), pick(self.properties),
            pick(self.event_time), pick(self.event_id),
            minted=self.minted)


def events_to_wire(events: Sequence[Event]) -> dict:
    """The columnar wire body of a list of `Event` objects (the remote
    DAO's `insert_batch`). Name and type columns that are constant
    collapse to broadcast scalars, and all-absent target columns drop;
    ids are sent when every event carries one, else the server mints."""

    def collapse(col, required):
        if len(set(col)) == 1:
            v = col[0]
            return v if (v or required) else None
        return col

    d = {
        "event": collapse([e.event for e in events], True),
        "entityType": collapse([e.entity_type for e in events], True),
        "entityId": [e.entity_id for e in events],
        "targetEntityType": collapse(
            [e.target_entity_type for e in events], False),
        "targetEntityId": [e.target_entity_id or "" for e in events],
        "properties": [e.properties.fields if e.properties else {}
                       for e in events],
        "eventTime": [format_event_time(e.event_time) for e in events],
    }
    if d["targetEntityType"] is None:
        del d["targetEntityType"], d["targetEntityId"]
    ids = [e.event_id for e in events]
    if all(ids):
        d["eventId"] = ids
    return d


def _as_column(value, n: int, key: str, broadcast: bool):
    """A wire value as a normalized column: list (checked to length n),
    scalar (broadcast allowed), or None."""
    if value is None:
        return None
    if isinstance(value, list):
        if len(value) != n:
            raise ValueError(
                f"column {key} has {len(value)} rows; entityId has {n}")
        return value
    if broadcast:
        return value
    raise ValueError(f"column {key} must be an array")


def normalize_columnar(d: dict) -> ColumnarBatch:
    """Parse + shape-check one columnar wire body. Raises ValueError on
    a malformed TABLE (wrong shapes, missing required columns) — those
    reject the whole request; per-ROW problems are left to
    ``validate_rows`` so they can 4xx individually."""
    if not isinstance(d, dict):
        raise ValueError("columnar body must be a JSON object")
    unknown = set(d) - set(_WIRE_KEYS) - {"returnIds"}
    if unknown:
        raise ValueError(
            f"unknown columnar key(s): {', '.join(sorted(unknown))}")
    ids = d.get("entityId")
    if not isinstance(ids, list):
        raise ValueError("entityId must be an array (it anchors the "
                         "batch length)")
    n = len(ids)
    if d.get("event") is None:
        raise ValueError("field event is required")
    if d.get("entityType") is None:
        raise ValueError("field entityType is required")
    cols = {}
    for wire, attr in _WIRE_KEYS.items():
        if attr == "entity_id":
            continue
        cols[attr] = _as_column(d.get(wire), n, wire,
                                broadcast=attr in _BROADCAST)
    # ids arrive as strings on every path; numbers coerce like the
    # object route's Event.from_dict (entityId str(...) coercion)
    ids = [x if isinstance(x, str) else str(x) for x in ids]
    tids = cols["target_entity_id"]
    if tids is not None:
        cols["target_entity_id"] = [
            x if isinstance(x, str) or x is None else str(x)
            for x in tids]
    eids = cols["event_id"]
    if eids is not None:
        # same str coercion as the id columns: SQLite would otherwise
        # store a numeric cell as an int
        cols["event_id"] = [
            x if isinstance(x, str) or x is None else str(x)
            for x in eids]
    return ColumnarBatch(n, cols["event"], cols["entity_type"], ids,
                         cols["target_entity_type"],
                         cols["target_entity_id"], cols["properties"],
                         cols["event_time"], cols["event_id"])


def validate_rows(b: ColumnarBatch,
                  allowed_events=None) -> Tuple[Optional[list], list]:
    """Apply the object routes' ``EventValidation`` rules per row.

    Returns ``(keep, failures)``: ``keep`` is None when every row
    passed (the hot path — no index list is materialized), else the
    row indexes to insert; ``failures`` is ``[(index, status, message)]``
    for the per-record 4xxs. Broadcast columns are validated ONCE —
    a scalar "event": "rate" costs one reserved-name check for the
    whole batch, not n."""
    ev = EventValidation

    def name_err(name) -> Optional[Tuple[int, str]]:
        if not name:
            return 400, "event must not be empty."
        if allowed_events and name not in allowed_events:
            return 403, f"{name} events are not allowed"
        if ev.is_reserved_prefix(name) and not ev.is_special_event(name):
            return 400, f"{name} is not a supported reserved event name."
        return None

    def etype_err(t) -> Optional[Tuple[int, str]]:
        if not t:
            return 400, "entityType must not be empty string."
        if ev.is_reserved_prefix(t) and not ev.is_builtin_entity_type(t):
            return (400, f"The entityType {t} is not allowed. "
                         "'pio_' is a reserved name prefix.")
        return None

    def ttype_err(t) -> Optional[Tuple[int, str]]:
        if t and ev.is_reserved_prefix(t) \
                and not ev.is_builtin_entity_type(t):
            return (400, f"The targetEntityType {t} is not allowed. "
                         "'pio_' is a reserved name prefix.")
        return None

    # broadcast-column checks run once; a bad scalar fails the whole
    # batch deterministically (every row would fail identically)
    for col, check in ((b.event, name_err), (b.entity_type, etype_err),
                       (b.target_entity_type, ttype_err)):
        if isinstance(col, str):
            err = check(col)
            if err is not None:
                if err[0] == 403:
                    raise PermissionError(err[1])
                raise ValueError(err[1])
    # eventTime cells must parse here, per row: a malformed timestamp
    # that only surfaced at insert time would 400 the whole request
    # instead of its own row
    et = b.event_time
    bad_times: Optional[set] = None
    if isinstance(et, str):
        try:
            parse_event_time(et)
        except ValueError:
            raise ValueError(f"eventTime {et!r} is not an ISO-8601 "
                             "timestamp")
    elif et is not None:
        bad = set()
        for i, x in enumerate(et):
            if x:
                try:
                    parse_event_time(x)
                except ValueError:
                    bad.add(i)
        bad_times = bad or None

    scalar_event = isinstance(b.event, str)
    scalar_special = scalar_event and ev.is_special_event(b.event)
    scalar_etype = isinstance(b.entity_type, str)
    scalar_ttype = isinstance(b.target_entity_type, str) \
        or b.target_entity_type is None
    tids = b.target_entity_id
    # -- whole-column happy path: with broadcast name/type columns the
    # only per-row hazards are empty ids, broken target pairing, and
    # bad property cells — each disproved by one C-speed pass (all(),
    # set(map(type,...)), one set.union over every props dict).
    # Anything suspicious falls through to the per-row loop, which
    # produces the exact row indexes for the 4xxs.
    if scalar_event and scalar_etype and scalar_ttype \
            and bad_times is None:
        if tids is None:
            pair_ok = b.target_entity_type is None
        else:
            pair_ok = (b.target_entity_type is not None
                       and not scalar_special and all(tids))
        if pair_ok and all(b.entity_id):
            props = b.properties
            if props is None:
                if b.event != "$unset":
                    return None, []
            else:
                tps = set(map(type, props))
                keys = None
                if tps == {dict}:
                    keys = set().union(*props)
                elif tps <= {dict, type(None)}:
                    keys = set().union(*(p for p in props if p))
                if keys is not None and not any(
                        ev.is_reserved_prefix(k)
                        and k not in ev.BUILTIN_PROPERTIES
                        for k in keys):
                    if b.event != "$unset" or all(props):
                        return None, []
    failures: list = []
    keep: Optional[list] = None

    def fail(i, status, msg):
        nonlocal keep
        if keep is None:
            keep = list(range(i))
        failures.append((i, status, msg))

    ttype_scalar_set = isinstance(b.target_entity_type, str)
    for i in range(b.n):
        err = None
        if not scalar_event:
            err = name_err(b.event[i])
        if err is None and not scalar_etype:
            err = etype_err(b.entity_type[i])
        if err is None and not b.entity_id[i]:
            err = 400, "entityId must not be empty string."
        if err is None:
            tid = tids[i] if tids is not None else None
            ttype = b.target_entity_type if ttype_scalar_set else (
                b.target_entity_type[i] if b.target_entity_type else None)
            if not scalar_ttype:
                err = ttype_err(ttype)
            if err is None and bool(tid) != bool(ttype):
                err = (400, "targetEntityType and targetEntityId must "
                            "be specified together.")
            if err is None and tid:
                special = (scalar_special if scalar_event
                           else ev.is_special_event(b.event[i]))
                if special:
                    name = b.event if scalar_event else b.event[i]
                    err = (400, f"Reserved event {name} cannot have "
                                "targetEntity")
        if err is None and b.properties is not None:
            props = b.properties[i]
            if props is not None and not isinstance(props, dict):
                err = 400, "field properties must be a JSON object"
            elif props:
                for k in props:
                    if ev.is_reserved_prefix(k) \
                            and k not in ev.BUILTIN_PROPERTIES:
                        err = (400, f"The property {k} is not allowed. "
                                    "'pio_' is a reserved name prefix.")
                        break
        if err is None and bad_times is not None and i in bad_times:
            err = (400, f"eventTime {et[i]!r} is not an ISO-8601 "
                        "timestamp")
        if err is None:
            name = b.event if scalar_event else b.event[i]
            if name == "$unset" and not (b.properties is not None
                                         and b.properties[i]):
                err = 400, "properties cannot be empty for $unset event"
        if err is not None:
            fail(i, *err)
        elif keep is not None:
            keep.append(i)
    return keep, failures
