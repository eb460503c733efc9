"""The event server: REST event collection into the event store.

The port's copy of `predictionio_tpu/data/api/event_server.py` (the
reference's Spray event server, EventServer.scala:112-460):

  GET  /                          -> {"status": "alive"}
  POST /events.json               -> 201 {"eventId": id, "traceId": t}
  GET  /events.json               -> the events the query params select
  GET  /events/<id>.json          -> the event | 404
  DELETE /events/<id>.json        -> {"message": "Found"} | 404
  POST /batch/events.json         -> a status per event (at most
                                     `max_batch`, else 413 with maxBatch)
  GET  /events/columnar.json      -> the selected events as flat columns
  POST /events/columnar.json      -> a columnar bulk write (an `entityId`
                                     column), else the entity-filtered
                                     columnar read
  GET  /stats.json                -> the window counters (`--stats`)
  GET  /metrics                   -> the Prometheus text exposition
                                     (`--stats`; unauthenticated, so the
                                     window counters across all apps)
  GET  /traces.json               -> recent span trees (`--stats`)
  GET  /flight.json               -> lifecycle records (`--stats`)
  GET  /health.json               -> the ingest SLOs' verdicts
  GET|POST /profile.json          -> profiler report, device trace
                                     (`--stats`)
  GET  /incidents.json            -> incident bundles (`--stats`)
  GET  /incidents/<id>.json       -> one bundle (`--stats`)
  GET  /fleet/status.json         -> the fleet's members with liveness
  GET  /fleet/health.json         -> the live members' SLOs, worst-of
  GET  /fleet/metrics             -> every live member's scrape, with
                                     {role,pid} labels (`--stats`)
  GET  /fleet/traces.json         -> one trace stitched across the
                                     members (`--stats`)
  POST /webhooks/<name>.json      -> a JSON webhook connector
  GET  /webhooks/<name>.json      -> whether the connector exists
  POST /webhooks/<name>           -> a form webhook connector
  GET  /plugins.json              -> the registered input plugins

Auth (EventServer.scala:81-107): the `accessKey` query param or the HTTP
Basic user name, through a cache of `PIO_ACCESSKEY_CACHE_S` seconds (3 by
default; 0 turns it off; misses are cached too); an access key with a
non-empty `events` list may write only those event names; the `channel`
param scopes a request to a named channel of the key's app. Input
blocker plugins (`PIO_EVENT_SERVER_PLUGINS`, `data/api/plugins.py`) may
veto an event and input sniffers observe it.

Single events go through the admission batcher (`_IngestBatcher`): a
request alone in the server inserts inline, concurrent requests land as
one `insert_batch` a group, and each is answered after its group's
commit.

Writes are resilient (`spill=True`, the default): ids are assigned
before the first attempt, and every store write runs behind the
`event_store` circuit breaker. A transient failure (`TRANSIENT_ERRORS`)
or an open breaker appends the events to the spill WAL
(`resilience/spill.py`, `<spill_dir>/events.wal`, by default
`base_dir()/ingest_spill`) and still answers 201 with `"spilled": true`;
a `SpillReplayer` drains the WAL into the store once it recovers,
in order and deduplicated by id. A deterministic rejection answers its
error. `start` adopts a WAL an earlier process left undrained.
`/health.json` carries the breaker's state, and the families
`pio_ingest_spilled_total` and `pio_ingest_spill_pending_bytes` count
the spill. Once bound, the server registers as the fleet member
`event_server` (`obs/fleet.py`) and deregisters in `stop`.

The server's `MetricsRegistry` (chained to the process-wide one) carries
the reference's ingest families: `pio_event_write_seconds` (a write's
latency, per accepted event, columnar write per request),
`pio_ingest_admission_group_size` (events per batcher dispatch, 1 =
inline) and the window counters `pio_event_window_start_seconds`,
`pio_event_window_events{event}` and `pio_event_window_statuses{status}`
(read from `Stats`, one snapshot a scrape).

Tracing: a single POST runs under an `event_ingest` trace, a batch under
`event_batch` and a columnar write under `event_ingest_columnar` (each
adopts a valid inbound `X-PIO-Trace-Id`, as the engine server's feedback
POST sends), with a `storage_write` span; each written event id is
registered with its trace id (`TRACER.register_event`), so a fold tick
that folds the event links its ingest trace, and the 201 bodies carry
`traceId`.

The columnar write cap is the constant `MAX_COLUMNAR_ROWS`, not a
config field: nothing in either package sets another value.
"""

from __future__ import annotations

import base64
import logging
import os
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.data.api.plugins import (
    INPUT_BLOCKER, EventServerPluginContext)
from predictionio_tpu_torch.data.api.stats import Stats
from predictionio_tpu_torch.data.columnar import (normalize_columnar,
                                                  validate_rows)
from predictionio_tpu_torch.data.event import (Event, EventValidation,
                                               new_event_id, new_event_ids,
                                               parse_event_time)
from predictionio_tpu_torch.data.storage.base import ABSENT
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import (FLIGHT, SLOEngine, TRACER,
                                        default_event_specs, fleet,
                                        flight_response, get_incidents,
                                        health_response,
                                        ingress_trace_kwargs,
                                        traces_response)
from predictionio_tpu_torch.resilience import (TRANSIENT_ERRORS,
                                               CircuitBreaker,
                                               CircuitOpenError)
from predictionio_tpu_torch.utils.http import (HttpServer, Request, Response,
                                               Router)

logger = logging.getLogger(__name__)

#: the default /batch/events.json cap: the reference's limit
MAX_BATCH_SIZE = 50
#: the /events/columnar.json write cap: the reference's default, a
#: constant here (the reference's `EventServerConfig.max_columnar_rows`
#: has no flag that sets it)
MAX_COLUMNAR_ROWS = 1_000_000


@dataclass
class EventServerConfig:
    ip: str = "0.0.0.0"
    port: int = 7070          # 0 = any free port; `bind` records it
    stats: bool = False
    # /batch/events.json cap (`eventserver --max-batch`); the columnar
    # write route has its own, much larger bound, MAX_COLUMNAR_ROWS
    max_batch: int = MAX_BATCH_SIZE
    # the durable ingest spill: a failed store write (or an open
    # breaker) appends to a local WAL and answers 201 {"spilled": true};
    # a replayer drains the WAL into the store when it recovers
    spill: bool = True
    spill_dir: Optional[str] = None   # default <base_dir()>/ingest_spill
    # the event-store breaker: consecutive write failures before writes
    # go straight to the WAL, and the open -> half-open probe delay
    breaker_failures: int = 5
    breaker_reset_s: float = 5.0


class _IngestBatcher:
    """Admission micro-batcher for single-event ingest. A request thread
    enqueues its validated event and blocks at most once: a leader (the
    arrival that completes the group, or the earliest follower whose
    formation wait expires) lands everything queued in one
    `insert_batch` per (app, channel) on its own request thread and
    wakes the others. A request alone in the server inserts inline.
    Every waiter gets its slot's result or its group's error, so a
    failed insert hangs no follower."""

    class _Slot:
        __slots__ = ("done", "result", "error")

        def __init__(self):
            self.done = threading.Event()
            self.result = None
            self.error: Optional[BaseException] = None

    def __init__(self, server: "EventServer"):
        self.server = server
        self._cv = threading.Condition(threading.Lock())
        self._queue: list = []
        # ingest requests being handled (enter() at route entry, exit()
        # at the response): the solo-or-batched decision keys on this
        self._ingress = 0
        self._h_group = server.metrics.histogram(
            "pio_ingest_admission_group_size",
            "Events per admission-batcher dispatch (1 = inline path)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128))
        # how long a follower waits for a leader before leading itself
        try:
            ms = float(os.environ.get("PIO_INGEST_ADMISSION_WAIT_MS", "1"))
        except (TypeError, ValueError):
            ms = 1.0
        self._wait_s = min(max(ms / 1000.0, 0.0), 0.020)

    def enter(self):
        with self._cv:
            self._ingress += 1

    def exit(self):
        with self._cv:
            self._ingress -= 1

    def submit(self, event, app_id, channel_id):
        """Land one event; returns `(event_id, spilled)` or raises the
        insert's error (a deterministic rejection keeps its 4xx)."""
        batch = None
        with self._cv:
            solo = self._ingress <= 1 and not self._queue
            if not solo:
                slot = self._Slot()
                self._queue.append((event, app_id, channel_id, slot))
                if len(self._queue) >= self._ingress:
                    # this arrival completes the group: lead it
                    batch, self._queue = self._queue, []
        if solo:
            self._h_group.observe(1)
            return self.server._resilient_insert(event, app_id, channel_id)
        if batch is None and not slot.done.wait(self._wait_s):
            # no leader landed us in time: claim whatever is queued (our
            # own slot too, unless a leader took it meanwhile)
            with self._cv:
                if not slot.done.is_set() and self._queue:
                    batch, self._queue = self._queue, []
        if batch is not None:
            self._dispatch(batch)
        slot.done.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _dispatch(self, batch):
        """Leader: one resilient `insert_batch` per (app, channel), then
        wake."""
        groups: dict = {}
        for ev, app, chan, slot in batch:
            groups.setdefault((app, chan), []).append((ev, slot))
        for (app, chan), items in groups.items():
            self._h_group.observe(len(items))
            try:
                res = self.server._resilient_insert_batch(
                    [ev for ev, _ in items], app, chan)
                for (_, slot), r in zip(items, res):
                    slot.result = r
            except BaseException as e:   # waiters must never hang
                for _, slot in items:
                    slot.error = e
            for _, slot in items:
                slot.done.set()


class AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class EventServer:
    def __init__(self, config: Optional[EventServerConfig] = None,
                 access_keys=None, channels=None, events=None,
                 webhook_connectors=None, plugin_context=None):
        self.config = config if config is not None else EventServerConfig()
        self._access_keys = access_keys
        self._channels = channels
        self._events = events
        self.stats = Stats()
        if webhook_connectors is None:
            from predictionio_tpu_torch.data.webhooks import \
                default_connectors
            webhook_connectors = default_connectors()
        self.webhook_connectors = webhook_connectors
        self.plugin_context = (plugin_context if plugin_context is not None
                               else EventServerPluginContext.load_from_env())
        # short-TTL access-key cache: without it every request reads the
        # metadata store; creation and revocation show within the TTL
        try:
            self.auth_cache_ttl_s = float(
                os.environ.get("PIO_ACCESSKEY_CACHE_S", "3.0"))
        except ValueError:
            logger.warning("PIO_ACCESSKEY_CACHE_S=%r is not a number; using "
                           "the 3.0s default",
                           os.environ.get("PIO_ACCESSKEY_CACHE_S"))
            self.auth_cache_ttl_s = 3.0
        self._auth_cache: dict = {}
        from predictionio_tpu_torch.obs import (MetricsRegistry,
                                                get_registry, torchmon)
        torchmon.install()
        self.metrics = MetricsRegistry(parent=get_registry())
        self._h_write = self.metrics.histogram(
            "pio_event_write_seconds",
            "Event-store write latency per accepted event")
        # the Stats snapshot one /metrics render reads (so the three
        # window collectors never straddle an hourly rotation)
        self._window_pin = None
        # the breaker over the store's write path, and the spill WAL,
        # made on the first spill or adopted at start()
        self.breaker = CircuitBreaker(
            "event_store", failure_threshold=self.config.breaker_failures,
            reset_timeout_s=self.config.breaker_reset_s)
        self._wal = None
        self._replayer = None
        self._wal_lock = threading.Lock()
        self._stop_lock = threading.Lock()
        self.spilled_count = 0
        self.metrics.counter_func(
            "pio_ingest_spilled_total",
            "Accepted events diverted to the spill WAL",
            lambda: self.spilled_count)
        self.metrics.gauge_func(
            "pio_ingest_spill_pending_bytes",
            "Un-replayed bytes in the spill WAL",
            lambda: (self._wal.pending_bytes() if self._wal else 0))
        # the flight recorder's metric context reads this server's
        # families; the ingest SLOs answer /health.json; the WAL and
        # breaker state ride every incident bundle
        FLIGHT.add_source(self.metrics)
        self.slo = SLOEngine(default_event_specs(),
                             registries=[self.metrics])
        get_incidents().register_provider("ingest_wal",
                                          self._incident_state)
        self._batcher = _IngestBatcher(self)
        # the fleet member id, set once the socket is bound
        self._fleet_id: Optional[str] = None
        self._register_metrics()
        self.router = self._build_router()
        self.server: Optional[HttpServer] = None

    def _register_metrics(self) -> None:
        m = self.metrics

        def window(field):
            return self._window_snapshot()["currentWindow"][field]

        m.gauge_func(
            "pio_event_window_start_seconds",
            "Start of the current counter window (unix time)",
            lambda: self._window_snapshot()["startTime"])
        m.gauge_func(
            "pio_event_window_events",
            "Events accepted in the current window, by event name",
            lambda: [({"event": k}, v) for k, v in
                     sorted(window("byEvent").items())] or [(None, 0)])
        m.gauge_func(
            "pio_event_window_statuses",
            "Responses in the current window, by HTTP status",
            lambda: [({"status": k}, v) for k, v in
                     sorted(window("byStatus").items())] or [(None, 0)])

    def _window_snapshot(self) -> dict:
        pinned = self._window_pin
        return pinned if pinned is not None else self.stats.to_dict(None)

    def _write(self, event, app_id, channel_id):
        """One event through the admission batcher under a
        `storage_write` span, its latency in `pio_event_write_seconds`;
        the id is registered with the active trace for the fold's
        links. Returns `(event_id, spilled)`."""
        with TRACER.span("storage_write") as sp:
            t0 = time.perf_counter()
            event_id, spilled = self._batcher.submit(event, app_id,
                                                     channel_id)
            self._h_write.observe(time.perf_counter() - t0)
            if sp is not None:
                sp.attrs["eventId"] = event_id
                if spilled:
                    sp.attrs["spilled"] = True
        TRACER.register_event(event_id, TRACER.current_trace_id())
        return event_id, spilled

    # -- the resilient write path -------------------------------------------
    def _get_wal(self):
        """The spill WAL and its replayer, made on first need (an idle
        server touches no disk)."""
        with self._wal_lock:
            if self._wal is None:
                from predictionio_tpu_torch.resilience import (SpillReplayer,
                                                               SpillWAL)
                path = self._spill_path()
                os.makedirs(os.path.dirname(path), exist_ok=True)
                self._wal = SpillWAL(path)
                self._replayer = SpillReplayer(
                    self._wal, self.events, app_breaker=self.breaker,
                    registry=self.metrics)
                self._replayer.start()
            return self._wal

    def _spill_path(self) -> str:
        if self.config.spill_dir:
            d = self.config.spill_dir
        else:
            from predictionio_tpu_torch.data.storage.registry import base_dir
            d = os.path.join(base_dir(), "ingest_spill")
        return os.path.join(d, "events.wal")

    def _resilient_insert(self, event, app_id, channel_id):
        """The store write behind the `event_store` breaker; a transient
        failure or an open circuit spills the event to the WAL and it is
        still acknowledged. A deterministic rejection raises (the store
        answered, so that is a breaker success). Returns
        `(event_id, spilled)`."""
        if not self.config.spill:
            return self.events.insert(event, app_id, channel_id), False
        # the id is assigned first: a write that committed before its
        # failure spills under the same id, and the replay dedups it
        if not event.event_id:
            event = event.with_id(new_event_id(), minted=True)
        try:
            self.breaker.allow()
        except CircuitOpenError:
            return self._spill(event, app_id, channel_id), True
        try:
            eid = self.events.insert(event, app_id, channel_id)
        except TRANSIENT_ERRORS as e:
            self.breaker.record_failure()
            logger.warning("event-store write failed (%s); spilling", e)
            return self._spill(event, app_id, channel_id), True
        except Exception:
            self.breaker.record_success()
            raise
        self.breaker.record_success()
        return eid, False

    def _resilient_insert_batch(self, events, app_id, channel_id):
        """`_resilient_insert` for a group: one breaker decision and one
        `insert_batch`; a transient failure or an open circuit spills
        the whole group under one fsync. Returns `[(event_id, spilled),
        ...]` in input order."""
        if not self.config.spill:
            ids = self.events.insert_batch(events, app_id, channel_id)
            return [(eid, False) for eid in ids]
        events = [e if e.event_id
                  else e.with_id(new_event_id(), minted=True)
                  for e in events]
        try:
            self.breaker.allow()
        except CircuitOpenError:
            return [(eid, True) for eid in
                    self._spill_many(events, app_id, channel_id)]
        try:
            ids = self.events.insert_batch(events, app_id, channel_id)
        except TRANSIENT_ERRORS as e:
            self.breaker.record_failure()
            logger.warning("event-store batch write failed (%s); "
                           "spilling %d events", e, len(events))
            return [(eid, True) for eid in
                    self._spill_many(events, app_id, channel_id)]
        except Exception:
            self.breaker.record_success()
            raise
        self.breaker.record_success()
        return [(eid, False) for eid in ids]

    def _resilient_insert_columnar(self, batch, app_id, channel_id):
        """The columnar write's `_resilient_insert`: ids assigned first,
        and a transient failure or an open breaker spills the whole
        batch under one fsync. Returns `(ids, spilled)`."""
        if not self.config.spill:
            return self.events.insert_columnar(batch, app_id,
                                               channel_id), False
        if batch.event_id is None:
            batch.event_id = new_event_ids(batch.n)
            batch.minted = True     # fresh hex: nativelog's fast path
        try:
            self.breaker.allow()
        except CircuitOpenError:
            return self._spill_many(batch.to_events(), app_id,
                                    channel_id), True
        try:
            ids = self.events.insert_columnar(batch, app_id, channel_id)
        except TRANSIENT_ERRORS as e:
            self.breaker.record_failure()
            logger.warning("columnar event-store write failed (%s); "
                           "spilling %d events", e, batch.n)
            return self._spill_many(batch.to_events(), app_id,
                                    channel_id), True
        except Exception:
            self.breaker.record_success()
            raise
        self.breaker.record_success()
        return ids, False

    def _spill_many(self, events, app_id, channel_id) -> list:
        with TRACER.span("spill_append"):
            eids = self._get_wal().append_many(events, app_id, channel_id)
        self.spilled_count += len(eids)
        FLIGHT.record("spill", coalesce_s=1.0, rows=len(eids),
                      pending=self._wal.pending_count()
                      if self._wal else None)
        return eids

    def _spill(self, event, app_id, channel_id) -> str:
        with TRACER.span("spill_append"):
            eid = self._get_wal().append(event, app_id, channel_id)
        self.spilled_count += 1
        # coalesced: an outage at thousands of events a second is one
        # record a second, not a flood that evicts the breaker's records
        FLIGHT.record("spill", coalesce_s=1.0, eventId=eid,
                      pending=self._wal.pending_count()
                      if self._wal else None)
        return eid

    def _incident_state(self) -> dict:
        """The ingest durability state frozen into incident bundles."""
        out = {"breaker": self.breaker.state,
               "spilledCount": self.spilled_count}
        wal = self._wal
        if wal is not None:
            try:
                out["pendingRecords"] = wal.pending_count()
                out["pendingBytes"] = wal.pending_bytes()
                # the sidecar's line count: no frame walk of the WAL on
                # the disk the incident may be about
                from predictionio_tpu_torch.resilience.spill import \
                    count_quarantined
                out["quarantined"] = count_quarantined(wal.path)
            except Exception as e:
                out["walError"] = str(e)
        return out

    # DAOs resolved lazily, so environment and registry changes hold
    @property
    def access_keys(self):
        return self._access_keys or Storage.get_meta_data_access_keys()

    @property
    def channels(self):
        return self._channels or Storage.get_meta_data_channels()

    @property
    def events(self):
        return self._events or Storage.get_events()

    # -- auth (EventServer.scala:81-107) -----------------------------------
    def _authenticate(self, req: Request):
        key = req.params.get("accessKey")
        if not key:
            auth = req.headers.get("Authorization", "")
            if auth.startswith("Basic "):
                try:
                    key = base64.b64decode(auth[6:]).decode(
                        "utf-8").split(":", 1)[0]
                except Exception:
                    key = None
        if not key:
            raise AuthError(401, "Missing accessKey.")
        access_key = self._cached_access_key(key)
        if access_key is None:
            raise AuthError(401, "Invalid accessKey.")
        channel_id = None
        channel_name = req.params.get("channel")
        if channel_name:
            match = [c for c in self.channels.get_by_app_id(access_key.appid)
                     if c.name == channel_name]
            if not match:
                raise AuthError(400, "Invalid channel.")
            channel_id = match[0].id
        return access_key, channel_id

    def _cached_access_key(self, key: str):
        """The DAO lookup behind the TTL cache (misses are cached too, so
        invalid keys cannot hammer the store)."""
        ttl = self.auth_cache_ttl_s
        if ttl <= 0:
            return self.access_keys.get(key)
        now = time.monotonic()
        hit = self._auth_cache.get(key)
        if hit is not None and now - hit[1] < ttl:
            return hit[0]
        access_key = self.access_keys.get(key)
        if len(self._auth_cache) >= 1024:
            # bound the growth from junk keys: evict the oldest one
            try:
                self._auth_cache.pop(next(iter(self._auth_cache)))
            except (StopIteration, KeyError):   # concurrent shrink
                pass
        self._auth_cache[key] = (access_key, now)
        return access_key

    # -- handlers ----------------------------------------------------------
    def _status(self, req: Request) -> Response:
        return Response(200, {"status": "alive"})

    @staticmethod
    def _check_event_allowed(access_key, event_name: str):
        if access_key.events and event_name not in access_key.events:
            raise AuthError(403, f"{event_name} events are not allowed")

    def _create_event(self, req: Request) -> Response:
        # the in-flight count drives the batcher's solo-or-batched choice
        self._batcher.enter()
        try:
            with TRACER.trace("event_ingest",
                              **ingress_trace_kwargs(req.headers)) as tr:
                access_key, channel_id = self._authenticate(req)
                d = req.json()
                if not isinstance(d, dict):
                    raise ValueError("request body must be a JSON object")
                event = Event.from_dict(d)
                tr.root.attrs["event"] = event.event
                self._check_event_allowed(access_key, event.event)
                EventValidation.validate(event)
                # input blockers may veto (EventServer.scala:239)
                self.plugin_context.check_input(
                    {"appId": access_key.appid, "channelId": channel_id,
                     "event": d})
                event_id, spilled = self._write(event, access_key.appid,
                                                channel_id)
                if self.config.stats:
                    self.stats.update(access_key.appid, event.event,
                                      event.entity_type, 201)
                body = {"eventId": event_id, "traceId": tr.trace_id}
                if spilled:
                    body["spilled"] = True
                return Response(201, body)
        finally:
            self._batcher.exit()

    def _batch_create(self, req: Request) -> Response:
        access_key, channel_id = self._authenticate(req)
        items = req.json()
        if not isinstance(items, list):
            raise ValueError("request body must be a JSON array")
        if len(items) > self.config.max_batch:
            return Response(413, {
                "message": f"Batch request must have less than or equal "
                           f"to {self.config.max_batch} events",
                "maxBatch": self.config.max_batch,
                "received": len(items),
                "hint": "POST /events/columnar.json accepts "
                        f"{MAX_COLUMNAR_ROWS} rows per "
                        "request as parallel arrays"})
        results = []
        with TRACER.trace("event_batch", events=len(items),
                          **ingress_trace_kwargs(req.headers)):
            for d in items:
                try:
                    event = Event.from_dict(d)
                    self._check_event_allowed(access_key, event.event)
                    EventValidation.validate(event)
                    event_id, spilled = self._write(event, access_key.appid,
                                                    channel_id)
                    item = {"status": 201, "eventId": event_id}
                    if spilled:
                        item["spilled"] = True
                    results.append(item)
                    if self.config.stats:
                        self.stats.update(access_key.appid, event.event,
                                          event.entity_type, 201)
                except AuthError as e:
                    results.append({"status": e.status,
                                    "message": e.message})
                except Exception as e:
                    results.append({"status": 400, "message": str(e)})
        return Response(200, results)

    def _get_event(self, req: Request) -> Response:
        access_key, channel_id = self._authenticate(req)
        event = self.events.get(req.path_args[0], access_key.appid,
                                channel_id)
        if event is None:
            return Response(404, {"message": "Not Found"})
        return Response(200, event.to_dict())

    def _delete_event(self, req: Request) -> Response:
        access_key, channel_id = self._authenticate(req)
        if self.events.delete(req.path_args[0], access_key.appid,
                              channel_id):
            return Response(200, {"message": "Found"})
        return Response(404, {"message": "Not Found"})

    @staticmethod
    def _parse_find_filters(p) -> dict:
        """The query-param filters shared by /events.json and
        /events/columnar.json."""
        def time_of(key):
            return parse_event_time(p[key]) if key in p else None

        def tgt(key):
            if key not in p:
                return None
            return ABSENT if p[key] == "" else p[key]

        return dict(
            start_time=time_of("startTime"),
            until_time=time_of("untilTime"),
            entity_type=p.get("entityType"), entity_id=p.get("entityId"),
            event_names=(p["event"].split(",") if "event" in p else None),
            target_entity_type=tgt("targetEntityType"),
            target_entity_id=tgt("targetEntityId"))

    def _find_events(self, req: Request) -> Response:
        access_key, channel_id = self._authenticate(req)
        p = req.params
        limit = int(p.get("limit", 20))
        reversed_order = p.get("reversed") == "true"
        if reversed_order and not (p.get("entityType")
                                   and p.get("entityId")):
            return Response(400, {
                "message": "the parameter reversed can only be used with "
                           "both entityType and entityId specified."})
        events = list(self.events.find(
            app_id=access_key.appid, channel_id=channel_id, limit=limit,
            reversed_order=reversed_order, **self._parse_find_filters(p)))
        if not events:
            return Response(404, {"message": "Not Found"})
        return Response(200, [e.to_dict() for e in events])

    @staticmethod
    def _columns_body(cols: dict) -> dict:
        out = {
            "entity_id": cols["entity_id"].tolist(),
            "target_entity_id": cols["target_entity_id"].tolist(),
            "event": cols["event"].tolist(),
            "t": cols["t"].tolist(),
        }
        if "prop" in cols:
            out["prop"] = [None if x != x else x
                           for x in cols["prop"].astype(float).tolist()]
        return out

    def _find_columnar(self, req: Request) -> Response:
        """GET /events/columnar.json: the selected events as flat column
        arrays (`propertyField` picks the numeric property column, NaN ->
        null); the filters are those of /events.json."""
        access_key, channel_id = self._authenticate(req)
        p = req.params
        cols = self.events.find_columnar(
            app_id=access_key.appid, channel_id=channel_id,
            property_field=p.get("propertyField"),
            limit=int(p.get("limit", -1)), **self._parse_find_filters(p))
        return Response(200, self._columns_body(cols))

    def _columnar_post(self, req: Request) -> Response:
        """POST /events/columnar.json: a body with an `entityId` column is
        a bulk write, anything else the entity-filtered read."""
        access_key, channel_id = self._authenticate(req)
        d = req.json()
        if not isinstance(d, dict):
            raise ValueError("request body must be a JSON object")
        if "entityId" in d:
            with TRACER.trace("event_ingest_columnar",
                              **ingress_trace_kwargs(req.headers)) as tr:
                return self._columnar_create(access_key, channel_id, d, tr)
        return self._columnar_by_entities(access_key, channel_id, d)

    def _columnar_create(self, access_key, channel_id, d, tr) -> Response:
        """The columnar bulk write, under the trace `tr`: one normalize
        pass, one validation pass, one `insert_columnar`. A bad row is a
        per-record 4xx in `failures` while the good rows land; a
        malformed table rejects the request. `returnIds: true` echoes
        the ids."""
        try:
            batch = normalize_columnar(d)
        except ValueError as e:
            return Response(400, {"message": str(e)})
        tr.root.attrs["rows"] = batch.n
        if batch.n > MAX_COLUMNAR_ROWS:
            return Response(413, {
                "message": "columnar request must have less than or "
                           f"equal to {MAX_COLUMNAR_ROWS} rows",
                "maxRows": MAX_COLUMNAR_ROWS,
                "received": batch.n})
        try:
            keep, failures = validate_rows(
                batch, allowed_events=access_key.events or None)
        except PermissionError as e:
            return Response(403, {"message": str(e)})
        except ValueError as e:
            return Response(400, {"message": str(e)})
        # input blockers see each row only when some are registered
        if self.plugin_context.plugins[INPUT_BLOCKER]:
            kept = keep if keep is not None else range(batch.n)
            vetoed = set()
            for i in kept:
                try:
                    self.plugin_context.check_input(
                        {"appId": access_key.appid,
                         "channelId": channel_id,
                         "event": batch.row_event(i).to_dict()})
                except Exception as e:
                    failures.append((i, 400, str(e)))
                    vetoed.add(i)
            if vetoed:
                keep = [i for i in kept if i not in vetoed]
        ins = batch if keep is None else batch.select(keep)
        ids: list = []
        spilled = False
        if ins.n:
            with TRACER.span("storage_write") as sp:
                t0 = time.perf_counter()
                ids, spilled = self._resilient_insert_columnar(
                    ins, access_key.appid, channel_id)
                self._h_write.observe(time.perf_counter() - t0)
                if sp is not None:
                    sp.attrs["rows"] = ins.n
        if self.config.stats:
            self._stats_columnar(access_key.appid, ins, len(failures))
        body: dict = {"eventsCreated": len(ids), "traceId": tr.trace_id}
        if spilled:
            body["spilled"] = True
        if d.get("returnIds"):
            body["eventIds"] = ids
        if failures:
            body["failures"] = [
                {"index": i, "status": s, "message": m}
                for i, s, m in sorted(failures)]
            return Response(200, body)
        return Response(201, body)

    def _stats_columnar(self, app_id, ins, n_failed: int):
        """The window counters of a columnar batch: broadcast name and
        type in one update; per-row columns grouped first."""
        if ins.n:
            if isinstance(ins.event, str) and isinstance(ins.entity_type,
                                                         str):
                self.stats.update(app_id, ins.event, ins.entity_type, 201,
                                  n=ins.n)
            else:
                groups = Counter(
                    (ins.cell("event", i), ins.cell("entity_type", i))
                    for i in range(ins.n))
                for (ev_name, etype), k in groups.items():
                    self.stats.update(app_id, ev_name, etype, 201, n=k)
        if n_failed:
            self.stats.update(app_id, "(invalid)", "(invalid)", 400,
                              n=n_failed)

    def _columnar_by_entities(self, access_key, channel_id,
                              d) -> Response:
        """The entity-filtered columnar read (the fold's O(touched) read
        over the network): the id lists ride in the body."""

        def time_of(key):
            return parse_event_time(d[key]) if d.get(key) else None

        target_type = d.get("targetEntityType")
        if target_type == "":
            target_type = ABSENT
        limit = d.get("limit")
        cols = self.events.find_columnar_by_entities(
            app_id=access_key.appid, channel_id=channel_id,
            entity_ids=[str(x) for x in d.get("entityIds") or ()],
            target_entity_ids=[str(x)
                               for x in d.get("targetEntityIds") or ()],
            property_field=d.get("propertyField"),
            start_time=time_of("startTime"),
            until_time=time_of("untilTime"),
            entity_type=d.get("entityType"),
            target_entity_type=target_type,
            event_names=d.get("events"),
            limit=int(limit) if limit is not None else None)
        return Response(200, self._columns_body(cols))

    def _get_stats(self, req: Request) -> Response:
        access_key, _ = self._authenticate(req)
        if not self.config.stats:
            return Response(404, {
                "message": "To see stats, launch Event Server with "
                           "--stats argument."})
        return Response(200, self.stats.to_dict(access_key.appid))

    def _metrics(self, req: Request) -> Response:
        """Prometheus text exposition of this server's registry (and the
        process-wide one through its parent). Unauthenticated, as
        scrapers carry no access key, and so aggregate over every app;
        404 unless `--stats`, as `/stats.json`."""
        if not self.config.stats:
            return Response(404, {
                "message": "To expose metrics, launch Event Server with "
                           "--stats argument."})
        from predictionio_tpu_torch.utils.prometheus import (
            CONTENT_TYPE, OPENMETRICS_CONTENT_TYPE, wants_exemplars)
        om = wants_exemplars(req)
        self._window_pin = self.stats.to_dict(None)
        try:
            body = self.metrics.render(exemplars=om)
        finally:
            self._window_pin = None
        return Response(200, body,
                        content_type=(OPENMETRICS_CONTENT_TYPE if om
                                      else CONTENT_TYPE))

    def _gated(self, what: str, handler):
        """A diagnostics route that answers only under `--stats`, as
        `/metrics` does (its records carry event ids and internals)."""
        def route(req: Request) -> Response:
            if not self.config.stats:
                return Response(404, {
                    "message": f"To expose {what}, launch Event Server "
                               "with --stats argument."})
            return handler(req)
        return route

    def _fleet_metrics(self, req: Request) -> Response:
        if not self.config.stats:
            return Response(404, {
                "message": "To federate metrics, launch Event Server "
                           "with --stats argument."})
        from predictionio_tpu_torch.utils.prometheus import CONTENT_TYPE
        return Response(200, fleet.fleet_metrics_response(req.params),
                        content_type=CONTENT_TYPE)

    def _profile(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import profiler
        status, body = profiler.profile_response_from_request(req)
        return Response(status, body)

    @staticmethod
    def _incident_show(req: Request) -> Response:
        from predictionio_tpu_torch.obs.incidents import incident_response
        status, body = incident_response(req.path_args[0])
        return Response(status, body)

    def _webhook_insert(self, event: Event, access_key,
                        channel_id) -> Response:
        EventValidation.validate(event)
        event_id, spilled = self._resilient_insert(event, access_key.appid,
                                                   channel_id)
        body = {"eventId": event_id}
        if spilled:
            body["spilled"] = True
        return Response(201, body)

    def _webhook_json(self, req: Request) -> Response:
        access_key, channel_id = self._authenticate(req)
        name = req.path_args[0]
        connector = self.webhook_connectors.get_json(name)
        if connector is None:
            return Response(404, {"message": f"webhook {name} not supported"})
        return self._webhook_insert(connector.to_event(req.json() or {}),
                                    access_key, channel_id)

    def _webhook_form(self, req: Request) -> Response:
        access_key, channel_id = self._authenticate(req)
        name = req.path_args[0]
        connector = self.webhook_connectors.get_form(name)
        if connector is None:
            return Response(404, {"message": f"webhook {name} not supported"})
        return self._webhook_insert(connector.to_event(req.form()),
                                    access_key, channel_id)

    def _webhook_get(self, req: Request) -> Response:
        self._authenticate(req)
        name = req.path_args[0]
        if (self.webhook_connectors.get_json(name)
                or self.webhook_connectors.get_form(name)):
            return Response(200, {"message": "Ok"})
        return Response(404, {"message": f"webhook {name} not supported"})

    def _build_router(self) -> Router:
        r = Router()

        def guarded(handler):
            def wrapped(req: Request) -> Response:
                try:
                    return handler(req)
                except AuthError as e:
                    return Response(e.status, {"message": e.message})
            return wrapped

        r.add("GET", "/", self._status)
        r.add("GET", "/plugins.json",
              lambda req: Response(200, self.plugin_context.to_dict()))
        r.add("POST", "/events.json", guarded(self._create_event))
        r.add("GET", "/events.json", guarded(self._find_events))
        r.add("POST", "/batch/events.json", guarded(self._batch_create))
        # columnar before the <id> route ("columnar" is not an id)
        r.add("GET", "/events/columnar.json", guarded(self._find_columnar))
        r.add("POST", "/events/columnar.json", guarded(self._columnar_post))
        r.add("GET", "/events/<id>.json", guarded(self._get_event))
        r.add("DELETE", "/events/<id>.json", guarded(self._delete_event))
        r.add("GET", "/stats.json", guarded(self._get_stats))
        r.add("GET", "/metrics", self._metrics)
        r.add("GET", "/traces.json", self._gated(
            "traces", lambda req: Response(200,
                                           traces_response(req.params))))
        r.add("GET", "/flight.json", self._gated(
            "flight records", lambda req: Response(
                200, flight_response(req.params))))
        r.add("GET", "/health.json", lambda req: Response(
            200, health_response(self.slo,
                                 extra={"breaker": self.breaker.state})))
        # the fleet views: status and health ungated, as /health.json;
        # the metrics and traces gated, as /metrics and /traces.json
        r.add("GET", "/fleet/status.json", lambda req: Response(
            200, fleet.fleet_status_response(req.params)))
        r.add("GET", "/fleet/health.json", lambda req: Response(
            200, fleet.fleet_health_response(req.params)))
        r.add("GET", "/fleet/metrics", self._fleet_metrics)
        r.add("GET", "/fleet/traces.json", self._gated(
            "traces", lambda req: Response(
                200, fleet.fleet_traces_response(req.params))))
        from predictionio_tpu_torch.obs.incidents import incidents_response
        r.add("GET", "/incidents.json", self._gated(
            "incidents", lambda req: Response(
                200, incidents_response(req.params))))
        r.add("GET", "/incidents/<id>.json",
              self._gated("incidents", self._incident_show))
        for method in ("GET", "POST"):
            r.add(method, "/profile.json",
                  self._gated("profiling", self._profile))
        r.add("POST", "/webhooks/<name>.json", guarded(self._webhook_json))
        r.add("GET", "/webhooks/<name>.json", guarded(self._webhook_get))
        r.add("POST", "/webhooks/<name>", guarded(self._webhook_form))
        return r

    # -- lifecycle ---------------------------------------------------------
    def bind(self) -> "EventServer":
        """Bind the socket and record the bound port in the config (port
        0 = any free port)."""
        self.server = HttpServer(self.router, self.config.ip,
                                 self.config.port).bind()
        self.server.on_bound = self._bound
        self.config.port = self.server.port
        logger.info("Event Server started on %s:%d", self.config.ip,
                    self.config.port)
        return self

    def _bound(self, server: HttpServer) -> None:
        """Bound and about to serve: register the fleet member."""
        self._fleet_id = fleet.register_member(
            "event_server", port=server.port, host=self.config.ip,
            stats=self.config.stats)

    def start(self, background: bool = True) -> "EventServer":
        """Serve, binding first unless `bind` has; `background=False`
        serves on the calling thread until `stop()`. Adopts a spill WAL
        an earlier process left undrained, and starts the sampling
        profiler (`PIO_PROFILER=off` keeps it off)."""
        path = self._spill_path()
        if (self.config.spill and os.path.exists(path)
                and os.path.getsize(path) > 0):
            self._get_wal()
        from predictionio_tpu_torch.obs import profiler
        profiler.ensure_started()
        if self.server is None:
            self.bind()
        self.server.start(background=background)
        return self

    def stop(self) -> None:
        """Deregister, stop listening, stop the replayer; the WAL file
        stays (a final drain runs only with the breaker closed, and a
        restart replays what is left). Stops run one at a time."""
        with self._stop_lock:
            fleet.deregister_member(self._fleet_id)
            self._fleet_id = None
            server, self.server = self.server, None
            if server is not None:
                server.stop()
            with self._wal_lock:
                replayer, self._replayer = self._replayer, None
                wal, self._wal = self._wal, None
            if replayer is not None:
                replayer.stop()
            if wal is not None:
                try:
                    if wal.pending_bytes() \
                            and self.breaker.state == "closed":
                        replayer.drain(max_records=1000)
                except Exception:
                    logger.debug("final spill drain failed", exc_info=True)
                wal.close()
