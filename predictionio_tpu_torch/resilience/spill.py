"""Durable ingest spill: a local write-ahead log behind the event store.

The port's copy of `predictionio_tpu/resilience/spill.py`; a WAL either
package writes, the other reads record for record.

The event server never loses an acknowledged event: when a store write
fails (or its circuit breaker is open) the server appends the event to
a local append-only WAL and answers `201 {"spilled": true}`; a
background `SpillReplayer` drains the WAL into the store on recovery,
in insertion order and deduplicated by event id, so the fold's tail
read sees each replayed event exactly once.

Each record is

    <u32 payload_len> <u32 crc32(payload)> <payload bytes>

where the payload is the compact JSON envelope `{"appId", "channelId",
"event"[, "traceId"]}` (the WAL spans namespaces; `traceId` is the
ingest trace the client was answered under). A crash mid-append leaves
a torn tail that fails the length or CRC check; `_recover()` truncates
it on open, so any byte prefix of a flushed WAL is a valid WAL.

The drain cursor (the byte offset of the first record not replayed)
lives in a sidecar written through a temp file and `os.replace`. The
worst a crash can do is replay the record between an insert and its
cursor advance again, which is idempotent: events spill with their ids
assigned, and the replayer checks the id before it inserts.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import zlib
from typing import Iterator, List, Optional, Tuple

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.obs.slo import lock_probe, timed_acquire
from predictionio_tpu_torch.obs.trace import TRACER
from predictionio_tpu_torch.resilience.policy import TRANSIENT_ERRORS

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<II")   # payload length, crc32(payload)


class SpillWAL:
    """Append-only spill log + crash-atomic drain cursor.

    Thread-safe: ingest threads append while the replayer reads; the
    lock covers file mutation (append, truncate-on-drain, cursor
    write), reads run against a size snapshot taken under it.
    """

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.cursor_path = path + ".cursor"
        self.fsync = fsync
        self._lock = threading.RLock()
        # contention probe: spill appends are the ingest ACK path
        # during an outage, so writer wait on this lock is ack latency,
        # surfaced as pio_lock_wait_seconds{lock=spill_wal_append}
        self._append_lock_wait = lock_probe("spill_wal_append")
        # serializes cursor-file persistence outside the append lock,
        # so spill acks never queue behind the replayer's cursor fsync
        self._cursor_io_lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._cursor = self._read_cursor()
        self._size = self._recover()
        if self._cursor > self._size:
            # cursor outlived a WAL the recovery truncated: clamp
            self._cursor = self._size
            self._write_cursor(self._cursor)
        # O(1) pending_count: maintained on append/checkpoint, seeded
        # by one header-only scan (payloads skipped) at open
        self._pending_records = self._count_records_from(self._cursor)
        self._f = open(self.path, "ab")

    # -- framing ------------------------------------------------------------
    def _recover(self) -> int:
        """Scan the log, truncating a torn tail (crash mid-append) to
        the last whole record; returns the valid size."""
        if not os.path.exists(self.path):
            return 0
        valid = 0
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                valid += _HEADER.size + length
        actual = os.path.getsize(self.path)
        if actual != valid:
            logger.warning("spill WAL %s: truncating torn tail "
                           "(%d -> %d bytes)", self.path, actual, valid)
            with open(self.path, "r+b") as f:
                f.truncate(valid)
        return valid

    def _count_records_from(self, offset: int) -> int:
        """Header-only record count from ``offset`` to the valid end
        (payloads are seeked over, not read/decoded)."""
        if offset >= self._size or not os.path.exists(self.path):
            return 0
        n = 0
        with open(self.path, "rb") as f:
            f.seek(offset)
            pos = offset
            while pos < self._size:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, _ = _HEADER.unpack(header)
                f.seek(length, 1)
                pos += _HEADER.size + length
                n += 1
        return n

    def _read_cursor(self) -> int:
        try:
            with open(self.cursor_path) as f:
                return int(f.read().strip() or 0)
        except (FileNotFoundError, ValueError):
            return 0

    def _write_cursor(self, offset: int):
        tmp = f"{self.cursor_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(offset))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.cursor_path)

    # -- write side ---------------------------------------------------------
    def append(self, event: Event, app_id: int,
               channel_id: Optional[int] = None) -> str:
        """Durably spill one event; assigns an event id if the event has
        none (the id the client is ACKed with, and the replay dedup
        key). Returns the id."""
        eid = event.event_id or new_event_id()
        envelope = {"appId": app_id, "channelId": channel_id,
                    "event": event.with_id(eid).to_dict()}
        # the original ingest trace id rides the WAL frame: a replay,
        # even by a restarted process whose event map is gone,
        # re-enters the store under the trace the client was answered
        # with
        tid = TRACER.current_trace_id()
        if tid:
            envelope["traceId"] = tid
        payload = json.dumps(envelope,
                             separators=(",", ":")).encode("utf-8")
        record = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        with timed_acquire(self._lock, self._append_lock_wait):
            self._f.write(record)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._size += len(record)
            self._pending_records += 1
        return eid

    def append_many(self, events, app_id: int,
                    channel_id: Optional[int] = None) -> List[str]:
        """Durably spill a whole batch under ONE lock / write / fsync —
        the columnar bulk-write route's outage path (per-event fsyncs
        during an outage would throttle exactly the burst the WAL
        exists to absorb). Ids are assigned where missing; insertion
        order is the list order, as the replayer expects."""
        eids = []
        frames = []
        tid = TRACER.current_trace_id()
        for event in events:
            eid = event.event_id or new_event_id()
            eids.append(eid)
            envelope = {"appId": app_id, "channelId": channel_id,
                        "event": event.with_id(eid).to_dict()}
            if tid:
                envelope["traceId"] = tid
            payload = json.dumps(envelope,
                                 separators=(",", ":")).encode("utf-8")
            frames.append(
                _HEADER.pack(len(payload), zlib.crc32(payload)) + payload)
        blob = b"".join(frames)
        with timed_acquire(self._lock, self._append_lock_wait):
            self._f.write(blob)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self._size += len(blob)
            self._pending_records += len(frames)
        return eids

    # -- read side ----------------------------------------------------------
    def pending(self) -> Iterator[
            Tuple[int, int, Optional[int], Event, Optional[str]]]:
        """Yield ``(offset_after_record, app_id, channel_id, event,
        trace_id)`` for every un-replayed record, in insertion order
        (``trace_id`` is the original ingest trace, None for frames
        written outside any trace)."""
        with self._lock:
            start, end = self._cursor, self._size
        if start >= end:
            return
        with open(self.path, "rb") as f:
            f.seek(start)
            pos = start
            while pos < end:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    return               # racing recovery truncation
                length, crc = _HEADER.unpack(header)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                pos += _HEADER.size + length
                d = json.loads(payload.decode("utf-8"))
                yield (pos, d["appId"], d.get("channelId"),
                       Event.from_dict(d["event"]), d.get("traceId"))

    def pending_count(self) -> int:
        with self._lock:
            return self._pending_records

    def pending_bytes(self) -> int:
        with self._lock:
            return max(self._size - self._cursor, 0)

    def checkpoint(self, offset: int, records: Optional[int] = None):
        """Advance the drain cursor (crash-atomic). ``records`` is how
        many records the caller consumed up to ``offset`` (the replayer
        always knows); without it the count is recomputed by a
        header-only scan. A fully-drained WAL is compacted back to zero
        bytes so it never grows unboundedly across spill episodes.

        Cursor-file persistence (open + fsync + replace) runs OUTSIDE
        the append lock: a replayer checkpointing mid-recovery must not
        convoy concurrent spill ACKs behind its cursor IO. Safe because
        the cursor is advisory-monotonic: the write under
        ``_cursor_io_lock`` re-reads the latest in-memory cursor, and a
        crash that persists a stale (lower) offset only re-replays
        records the drain already id-dedups."""
        with self._lock:
            if offset <= self._cursor:
                return
            self._cursor = min(offset, self._size)
            if self._cursor >= self._size:
                # fully drained: reset file + cursor instead of letting
                # the pair creep upward forever
                self._f.truncate(0)
                self._f.seek(0)
                self._size = 0
                self._cursor = 0
                self._pending_records = 0
            elif records is not None:
                self._pending_records = max(
                    0, self._pending_records - records)
            else:
                self._pending_records = self._count_records_from(
                    self._cursor)
        self._persist_cursor()

    def _persist_cursor(self):
        """Write the freshest in-memory cursor to the sidecar. The IO
        lock serializes writers; each one re-snapshots ``_cursor`` so
        out-of-order checkpoint threads still persist the newest
        value."""
        with self._cursor_io_lock:
            with self._lock:
                cur = self._cursor
            self._write_cursor(cur)

    def close(self):
        with self._lock:
            self._f.close()


# -- operator inspection (the CLI's `spill`) ----------------------------------
#
# Read-only views over a WAL another process may be writing: no handle
# is kept, nothing is truncated (a torn tail is REPORTED, not repaired —
# repair belongs to the owning server's SpillWAL open).

def _iter_frames(path: str):
    """Read-only frame walk: yield ``(end_offset, payload_bytes)`` for
    every whole CRC-valid record, stopping at a torn tail. The one
    framing parser behind every CLI-side view (the owning server's
    SpillWAL keeps its own handle-and-lock-based readers)."""
    try:
        f = open(path, "rb")
    except FileNotFoundError:
        return
    with f:
        pos = 0
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                return
            length, crc = _HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            pos += _HEADER.size + length
            yield pos, payload


def _read_cursor_file(path: str) -> int:
    try:
        with open(path + ".cursor") as f:
            return int(f.read().strip() or 0)
    except (FileNotFoundError, ValueError):
        return 0


def scan_wal(path: str) -> dict:
    """Frame-walk a WAL file without mutating it. Returns totals plus
    the quarantine sidecar's record count."""
    out = {"path": path, "exists": os.path.exists(path),
           "totalRecords": 0, "pendingRecords": 0, "pendingBytes": 0,
           "cursor": _read_cursor_file(path), "validBytes": 0,
           "tornBytes": 0, "quarantined": 0}
    if out["exists"]:
        valid = 0
        for end, _payload in _iter_frames(path):
            valid = end
            out["totalRecords"] += 1
            if end > out["cursor"]:
                out["pendingRecords"] += 1
        out["validBytes"] = valid
        out["tornBytes"] = max(os.path.getsize(path) - valid, 0)
        out["pendingBytes"] = max(valid - min(out["cursor"], valid), 0)
    out["quarantined"] = count_quarantined(path)
    return out


def count_quarantined(path: str) -> int:
    """Record count of WAL ``path``'s quarantine sidecar — a line
    count (the sidecar is one JSON record per line), NOT a WAL
    frame-walk. The cheap read incident capture uses mid-outage."""
    qpath = path + ".quarantine"
    if not os.path.exists(qpath):
        return 0
    with open(qpath) as f:
        return sum(1 for line in f if line.strip())


def iter_pending(path: str, limit: Optional[int] = None):
    """Yield the un-replayed records' envelopes
    (``{"appId", "channelId", "event"}`` dicts) read-only, oldest
    first."""
    n = 0
    cursor = _read_cursor_file(path)
    for end, payload in _iter_frames(path):
        if end <= cursor:
            continue
        yield json.loads(payload.decode("utf-8"))
        n += 1
        if limit is not None and n >= limit:
            return


def read_quarantine(path: str) -> list:
    """The quarantine sidecar's records (``path`` is the WAL path)."""
    qpath = path + ".quarantine"
    out = []
    try:
        with open(qpath) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    except FileNotFoundError:
        pass
    return out


def requeue_quarantined(path: str, events=None) -> Tuple[int, int]:
    """Retry every quarantined record against the primary event store
    directly (the operator fixed whatever made the healthy store reject
    it — a schema change rolled back, a property whitelist updated).

    Deliberately NOT a WAL re-append: the owning server's ``SpillWAL``
    caches its size/cursor, so a second writer's records would be
    invisible to the live replayer — and a drain that empties the
    server's view truncates the file, silently deleting them. Direct
    inserts (id-deduped, the replayer's own idempotency rule) have no
    multi-writer hazard. Records the store still rejects stay
    quarantined. Returns ``(inserted_or_deduped, still_quarantined)``.
    """
    records = read_quarantine(path)
    if not records:
        return 0, 0
    if events is None:
        from predictionio_tpu_torch.data.storage.registry import Storage
        events = Storage.get_events()
    kept = []
    done = 0
    for rec in records:
        event = Event.from_dict(rec["event"])
        app_id, channel_id = rec["appId"], rec.get("channelId")
        try:
            existing = (events.get(event.event_id, app_id, channel_id)
                        if event.event_id else None)
            if existing is None:
                events.insert(event, app_id, channel_id)
            done += 1
        except Exception as e:
            kept.append(dict(rec, error=str(e)))
            logger.warning("requeue: store still rejects event %s: %s",
                           event.event_id, e)
    qpath = path + ".quarantine"
    tmp = f"{qpath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        for rec in kept:
            f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, qpath)
    if not kept:
        os.remove(qpath)
    logger.info("requeue: %d record(s) into the store, %d still "
                "quarantined (%s)", done, len(kept), path)
    return done, len(kept)


class SpillReplayer:
    """Background drain of a ``SpillWAL`` into the primary event store.

    Order-preserving (records replay in insertion order; a failure
    stops the drain at that record rather than skipping it) and
    idempotent (get-check by event id before insert — a crash between
    an insert and its cursor advance re-replays into an overwrite/skip,
    never a duplicate). Inserts run under the store's circuit breaker
    and a jittered retry policy, so a replayer probing a still-down
    backend backs off instead of hammering it.
    """

    def __init__(self, wal: SpillWAL, events, app_breaker=None,
                 policy=None, interval_s: float = 1.0, registry=None,
                 batch_checkpoint: int = 32, quarantine_after: int = 5):
        from predictionio_tpu_torch.resilience.policy import RetryPolicy
        self.wal = wal
        self.events = events
        self.breaker = app_breaker
        self.policy = policy or RetryPolicy(max_attempts=2,
                                            base_delay_s=0.05)
        self.interval_s = interval_s
        self.batch_checkpoint = max(1, batch_checkpoint)
        # poisoned-record guard: a record the HEALTHY store rejects
        # this many drains in a row is moved to the quarantine sidecar
        # so it cannot wedge every later-spilled event behind it
        self.quarantine_after = max(1, quarantine_after)
        self._head_fail_offset: Optional[int] = None
        self._head_fail_count = 0
        self.replayed = 0
        self.deduped = 0
        self.quarantined = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from predictionio_tpu_torch.obs import get_registry
            registry = get_registry()
        self._c_replayed = registry.counter(
            "pio_spill_replayed_total",
            "Spilled events drained into the primary event store")
        self._c_deduped = registry.counter(
            "pio_spill_deduped_total",
            "Replay records skipped because the id already existed "
            "(crash-window re-replays)")
        self._c_quarantined = registry.counter(
            "pio_spill_quarantined_total",
            "Replay records the healthy store rejected repeatedly, "
            "moved to the .quarantine sidecar (alert: these need "
            "operator attention)")

    #: the shared outage-class error set (resilience.TRANSIENT_ERRORS —
    #: the same classification the event server spills on). Anything
    #: else is a deterministic rejection by a REACHABLE store — a
    #: breaker success, and quarantine bait.
    TRANSIENT_ERRORS = TRANSIENT_ERRORS

    def _insert_one(self, app_id, channel_id, event: Event,
                    trace_id: Optional[str] = None) -> bool:
        """One record into the primary store; True = inserted, False =
        deduped. Raises on (breaker-gated, retried) failure.

        ``trace_id`` (the frame's original ingest trace) is
        re-activated around the insert — discarded from the ring (the
        original trace already committed; a duplicate commit under the
        same id would shadow it) but LIVE as context, so a remote
        store hop carries X-PIO-Trace-Id and any flight record emitted
        under the write stamps the original id — and re-registered in
        the event map so a later fold tick links the original trace,
        not nothing."""
        if trace_id:
            with TRACER.trace("spill_replay_write",
                              trace_id=trace_id) as t:
                t.discard = True
                ok = self._insert_one(app_id, channel_id, event)
            TRACER.register_event(event.event_id, trace_id)
            return ok

        def attempt():
            if self.breaker is not None:
                self.breaker.allow()
            try:
                existing = self.events.get(event.event_id, app_id,
                                           channel_id)
                if existing is None:
                    self.events.insert(event, app_id, channel_id)
            except self.TRANSIENT_ERRORS:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            except Exception:
                # the store ANSWERED (with a rejection): reachable —
                # breaker success, so repeated rejections are visible
                # to the quarantine guard instead of opening the breaker
                if self.breaker is not None:
                    self.breaker.record_success()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            return existing is None

        return self.policy.call(attempt)

    def _note_head_failure(self, offset: int, app_id, channel_id,
                           event: Event, error: Exception,
                           trace_id: Optional[str] = None) -> bool:
        """Track repeated failures of the record at the drain head.
        Returns True when the record was quarantined (drain may step
        past it). Only DETERMINISTIC rejections count — transient
        (outage-class) errors, including policy-wrapped retries and
        breaker fast-fails, are never quarantine grounds; neither is
        anything that happens while the breaker is not closed."""
        from predictionio_tpu_torch.resilience.policy import CLOSED
        if isinstance(error, self.TRANSIENT_ERRORS):
            # RetryBudgetExceeded and CircuitOpenError are IOErrors,
            # so wrapped transient retries land here too
            return False
        if self.breaker is not None and self.breaker.state != CLOSED:
            return False
        if self._head_fail_offset != offset:
            self._head_fail_offset = offset
            self._head_fail_count = 0
        self._head_fail_count += 1
        if self._head_fail_count < self.quarantine_after:
            return False
        qpath = self.wal.path + ".quarantine"
        rec = {"appId": app_id, "channelId": channel_id,
               "event": event.to_dict(), "error": str(error)}
        if trace_id:
            # the original ingest trace rides into quarantine: `spill
            # peek --quarantine` keeps the pivot into the outage
            rec["traceId"] = trace_id
        with open(qpath, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self.quarantined += 1
        self._c_quarantined.inc()
        self._head_fail_offset = None
        self._head_fail_count = 0
        logger.error(
            "spill replay: healthy store rejected event %s %d times "
            "(%s) — quarantined to %s; later records resume draining",
            event.event_id, self.quarantine_after, error, qpath)
        try:
            from predictionio_tpu_torch.obs.flight import FLIGHT
            FLIGHT.record("spill_quarantine", eventId=event.event_id,
                          error=str(error))
        except Exception:
            pass
        return True

    #: consecutive same-namespace records per bulk replay flush
    REPLAY_BATCH = 256

    def _insert_batch(self, app_id, channel_id, events,
                      trace_ids=()) -> int:
        """A same-namespace run into the primary via ONE
        ``insert_batch`` (recovery drains at bulk speed, exactly when
        throughput matters), id-deduped by
        get-probes first. Returns the inserted count. Transient
        failures raise after breaker gating + retry; a partial commit
        re-replays as dedups (ids were pre-assigned at spill time).

        ``trace_ids`` parallels ``events``: the original ingest trace
        ids are re-registered on success (the fold tick's link
        source), and when the whole run shares ONE id (a spilled
        batch/columnar write) the insert runs under it as live
        context, so a remote-store hop propagates the header."""
        tids = {t for t in trace_ids if t}
        if len(tids) == 1:
            with TRACER.trace("spill_replay_write",
                              trace_id=next(iter(tids))) as t:
                t.discard = True
                n = self._insert_batch_inner(app_id, channel_id,
                                             events)
        else:
            n = self._insert_batch_inner(app_id, channel_id, events)
        self._register_replayed(events, trace_ids)
        return n

    @staticmethod
    def _register_replayed(events, trace_ids):
        for e, tid in zip(events, trace_ids):
            if tid:
                TRACER.register_event(e.event_id, tid)

    def _insert_batch_inner(self, app_id, channel_id, events) -> int:
        def attempt():
            if self.breaker is not None:
                self.breaker.allow()
            try:
                fresh = [e for e in events
                         if self.events.get(e.event_id, app_id,
                                            channel_id) is None]
                if fresh:
                    self.events.insert_batch(fresh, app_id, channel_id)
            except self.TRANSIENT_ERRORS:
                if self.breaker is not None:
                    self.breaker.record_failure()
                raise
            except Exception:
                # reachable store, deterministic rejection: breaker
                # success; the caller's per-record fallback pinpoints it
                if self.breaker is not None:
                    self.breaker.record_success()
                raise
            if self.breaker is not None:
                self.breaker.record_success()
            return len(fresh)

        return self.policy.call(attempt)

    def drain(self, max_records: Optional[int] = None) -> int:
        """Replay pending records in order until the WAL is empty, the
        cap is hit, or an insert fails. Consecutive records for the
        same (app, channel) land as ONE ``insert_batch`` per
        REPLAY_BATCH run (one group commit / multi-row INSERT instead
        of a per-frame insert, the slowest path during recovery); a run
        the store rejects
        deterministically re-replays per record so the poisoned frame
        is pinpointed (and eventually quarantined) exactly as before.
        A transient failure stops the drain AT the failing run
        (nothing is skipped). Returns records replayed+deduped."""
        done = 0
        buf: list = []   # [(offset, event, trace_id)] — one namespace run
        key: Optional[tuple] = None

        def flush_per_record() -> bool:
            """One buffered run record by record: pinpoint (and maybe
            quarantine) the poisoned record. True = keep draining."""
            nonlocal done
            ok_since = 0
            last = None
            keep = True
            app_id, channel_id = key
            try:
                for offset, event, tid in buf:
                    try:
                        inserted = self._insert_one(app_id, channel_id,
                                                    event,
                                                    trace_id=tid)
                    except Exception as e:
                        self.last_error = str(e)
                        if self._note_head_failure(offset, app_id,
                                                   channel_id, event, e,
                                                   trace_id=tid):
                            # quarantined: step past, keep draining
                            self.wal.checkpoint(offset,
                                                records=ok_since + 1)
                            ok_since = 0
                            last = None
                            continue
                        logger.warning(
                            "spill replay stopped at event %s: %s",
                            event.event_id, e)
                        keep = False
                        break
                    if inserted:
                        self.replayed += 1
                        self._c_replayed.inc()
                    else:
                        self.deduped += 1
                        self._c_deduped.inc()
                    done += 1
                    ok_since += 1
                    last = offset
            finally:
                if last is not None:
                    self.wal.checkpoint(last, records=ok_since)
                buf.clear()
            return keep

        def flush() -> bool:
            """Land one buffered run; True = keep draining."""
            nonlocal done
            if not buf:
                return True
            try:
                inserted = self._insert_batch(
                    key[0], key[1], [e for _, e, _t in buf],
                    trace_ids=[t for _, _e, t in buf])
            except self.TRANSIENT_ERRORS as e:
                # outage-class: stop AT the run head; nothing skipped
                self.last_error = str(e)
                logger.warning("spill replay stopped at event %s: %s",
                               buf[0][1].event_id, e)
                buf.clear()
                return False
            except Exception:
                return flush_per_record()
            self.replayed += inserted
            self._c_replayed.inc(inserted)
            self.deduped += len(buf) - inserted
            self._c_deduped.inc(len(buf) - inserted)
            done += len(buf)
            self.wal.checkpoint(buf[-1][0], records=len(buf))
            buf.clear()
            return True

        exhausted = True
        for offset, app_id, channel_id, event, tid \
                in self.wal.pending():
            k = (app_id, channel_id)
            if key != k or len(buf) >= self.REPLAY_BATCH:
                if buf and not flush():
                    exhausted = False
                    break
                key = k
            buf.append((offset, event, tid))
            if max_records is not None \
                    and done + len(buf) >= max_records:
                exhausted = False
                break
        clean = flush() if buf else True
        if exhausted and clean:
            self.last_error = None
            self._head_fail_offset = None
            self._head_fail_count = 0
        return done

    # -- background loop ----------------------------------------------------
    def start(self) -> "SpillReplayer":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    if self.wal.pending_bytes():
                        from predictionio_tpu_torch.obs import TRACER
                        with TRACER.trace("spill_replay") as tr:
                            n = self.drain()
                            tr.root.attrs["events"] = n
                            tr.discard = n == 0
                            # inside the trace: the record's traceId
                            # is the operator's pivot into the
                            # spill_replay trace just committed
                            if n:
                                from predictionio_tpu_torch.obs.flight \
                                    import FLIGHT
                                FLIGHT.record(
                                    "spill_replay", events=n,
                                    pending=self.wal.pending_count())
                except Exception:
                    logger.exception("spill replay tick failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pio-spill-replayer")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def stats(self) -> dict:
        return {"pending": self.wal.pending_count(),
                "pendingBytes": self.wal.pending_bytes(),
                "replayed": self.replayed,
                "deduped": self.deduped,
                "lastError": self.last_error}
