"""Remote event-store backend: the Events DAO over a running event
server's REST API.

The port's copy of `predictionio_tpu/data/storage/eventserver_client.py`.
The reference deploys one central event store that every app, trainer
and serving process points at (HBase behind the event server;
EventServer.scala's route table). The embedded backends (sqlite,
nativelog) need filesystem access to that store; this client serves a
process that has only NETWORK access: a trainer on another host reads
and writes events through the event server itself (`/events.json` CRUD,
`/batch/events.json`, `/events/columnar.json`), behind the same
`Events` interface. It speaks `http.client` with one keep-alive
connection per thread, sends the caller's trace context
(`obs.trace.trace_context_headers`), writes in bulk through
`data/columnar.events_to_wire`, and reads columns through
`GET /events/columnar.json` (`find_columnar`, `find_columnar_chunked`)
and the entity-filtered `POST /events/columnar.json`.

Configure:
    PIO_STORAGE_SOURCES_<S>_TYPE=eventserver
    PIO_STORAGE_SOURCES_<S>_URL=http://host:7070
    PIO_STORAGE_SOURCES_<S>_ACCESS_KEY=<key>      (scopes the app)
    PIO_STORAGE_SOURCES_<S>_CHANNELS=5=mych,7=other   (optional: the
        REST API addresses channels by NAME; this maps the numeric
        channel ids the Events interface speaks to those names)
    PIO_STORAGE_SOURCES_<S>_TIMEOUT=60      (connection timeout, seconds)
    PIO_STORAGE_SOURCES_<S>_RETRIES=3       (attempts per request;
        transport errors and 503s retry through `resilience.RetryPolicy`
        with jittered exponential backoff, honoring a server-sent
        Retry-After, which the event server's shed and breaker paths
        send. Safe for writes: events carry client-assigned ids, so a
        retried POST overwrites by key instead of duplicating.)

Scope notes (enforced, not silent): an access key is bound to ONE app,
so calls for a different app_id raise; `init` is a no-op (namespaces are
managed by the server's admin surface); `remove` deletes events one by
one through the API (there is no bulk-drop route, as in the reference's
event API).
"""

from __future__ import annotations

import datetime as dt
import gzip
import http.client
import json
import threading
import urllib.parse
from typing import Dict, List, Optional, Sequence

from predictionio_tpu_torch.data.event import Event, from_millis, to_millis
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import ABSENT
from predictionio_tpu_torch.obs.trace import trace_context_headers

MAX_BATCH = 50  # the server's batch cap (EventServer MAX_BATCH_SIZE)


class RemoteError(IOError):
    def __init__(self, status: int, message: str):
        super().__init__(f"event server returned {status}: {message}")
        self.status = status


class StorageClient:
    def __init__(self, config):
        self.config = config
        url = config.get("URL") or config.get("HOSTS") \
            or "http://127.0.0.1:7070"
        self.access_key = config.get("ACCESS_KEY") or ""
        channels = config.get("CHANNELS") or ""
        channel_map: Dict[int, str] = {}
        for pair in channels.split(","):
            if "=" in pair:
                cid, name = pair.split("=", 1)
                channel_map[int(cid.strip())] = name.strip()
        self._events = RemoteEvents(
            url, self.access_key, channel_map,
            timeout_s=float(config.get("TIMEOUT") or 60.0),
            retries=int(config.get("RETRIES") or 3))

    def get_data_object(self, kind: str, namespace: str):
        if kind != "events":
            raise ValueError(
                f"eventserver backend only stores events, not {kind}")
        return self._events

    def close(self):
        self._events.close()


class RemoteEvents(base.Events):
    """Events DAO speaking the event-server REST protocol. One keep-alive
    connection per thread (the server is a threaded HTTP server; keep-
    alive removes per-call TCP setup from the bulk paths)."""

    #: cap on honoring a server-sent Retry-After (a misconfigured server
    #: must not park a trainer for an hour)
    MAX_RETRY_AFTER_S = 30.0

    def __init__(self, url: str, access_key: str,
                 channel_map: Optional[Dict[int, str]] = None,
                 timeout_s: float = 60.0, retries: int = 3):
        if "://" not in url:
            # conventional HOSTS form: bare "host" or "host:port"
            url = "http://" + url
        p = urllib.parse.urlparse(url)
        if p.scheme != "http":
            raise ValueError(f"unsupported event server scheme {p.scheme!r}")
        self.host = p.hostname or "127.0.0.1"
        self.port = p.port or 7070
        self.access_key = access_key
        self.channel_map = channel_map or {}
        self.timeout_s = timeout_s
        self.retries = max(1, int(retries))
        # jittered-backoff schedule for transport errors and 503s (the
        # shed/breaker paths): full jitter de-synchronizes a fleet of
        # clients re-hitting a recovering server
        from predictionio_tpu_torch.resilience import RetryPolicy
        self._retry = RetryPolicy(max_attempts=self.retries,
                                  base_delay_s=0.1, max_delay_s=5.0)
        self._app_id: Optional[int] = None   # learned lazily, then pinned
        self._local = threading.local()
        # flipped (once) by a 404 from the columnar write route: a
        # server without it; bulk writes fall back to chunked /batch
        self._no_columnar_write = False

    # -- transport ----------------------------------------------------------
    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout_s)
            self._local.conn = c
        return c

    def _request(self, method: str, path: str,
                 params: Optional[dict] = None, body=None):
        qs = dict(params or {})
        qs["accessKey"] = self.access_key
        full = path + "?" + urllib.parse.urlencode(qs)
        payload = (json.dumps(body).encode("utf-8")
                   if body is not None else None)
        headers = {"Content-Type": "application/json"} if payload else {}
        # bulk responses (columnar training reads) gzip ~10x; the server
        # only compresses when asked and past a size floor
        headers["Accept-Encoding"] = "gzip"
        # cross-process trace propagation: every hop through
        # this client — single insert, batch, columnar write, the
        # scheduler's tail/entity-filtered reads, the spill replayer's
        # re-inserts — carries the caller's active trace context, so
        # the server adopts the id instead of minting a fresh one (one
        # contextvar read when no trace is active)
        headers.update(trace_context_headers())
        # Retries are safe for writes too: every insert carries a
        # client-assigned event id (see _with_id), so a re-send
        # overwrites by key instead of duplicating.
        for attempt in range(1, self.retries + 1):
            c = self._conn()
            try:
                c.request(method, full, body=payload, headers=headers)
                resp = c.getresponse()
                data = resp.read()
            except (http.client.HTTPException, ConnectionError, OSError):
                self._local.conn = None
                c.close()
                if attempt >= self.retries:
                    raise
                self._retry.sleep(self._retry.delay_for(attempt))
                continue
            if resp.status == 503 and attempt < self.retries:
                # overloaded/breaker-open server: honor its Retry-After
                # (the shed path emits an honest wait bound), bounded;
                # fall back to the jittered schedule without one
                ra = resp.headers.get("Retry-After")
                try:
                    # clamp to [0, cap]: a buggy proxy's negative value
                    # must not blow up time.sleep
                    delay = max(0.0, min(float(ra),
                                         self.MAX_RETRY_AFTER_S)) \
                        if ra else self._retry.delay_for(attempt)
                except ValueError:
                    delay = self._retry.delay_for(attempt)
                self._retry.sleep(delay)
                continue
            break
        # decode OUTSIDE the retry loop: a corrupt gzip body is a
        # response-decoding problem, not a transport failure — retrying
        # would silently re-send writes (BadGzipFile is an OSError)
        if resp.headers.get("Content-Encoding") == "gzip":
            data = gzip.decompress(data)
        try:
            decoded = json.loads(data.decode("utf-8")) if data else None
        except ValueError:
            decoded = None
        return resp.status, decoded

    def close(self):
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None

    # -- scope checks -------------------------------------------------------
    def _params(self, app_id: int, channel_id: Optional[int]) -> dict:
        """Every operation funnels through here: the first app_id seen is
        pinned, later mismatches raise. (The server scopes everything by
        the access key and ignores the client-side app_id entirely, so
        without the pin a wrong app_id would silently return another
        app's events under the wrong label.)"""
        if self._app_id is None:
            self._app_id = app_id
        elif app_id != self._app_id:
            raise ValueError(
                f"this eventserver client's access key is bound to app "
                f"{self._app_id}; got app_id={app_id}. Configure one "
                f"source per app.")
        if channel_id is None:
            return {}
        name = self.channel_map.get(channel_id)
        if name is None:
            raise ValueError(
                f"channel_id {channel_id} has no name mapping; set "
                f"PIO_STORAGE_SOURCES_<S>_CHANNELS={channel_id}=<name>")
        return {"channel": name}

    # -- Events interface ---------------------------------------------------
    def init(self, app_id, channel_id=None) -> bool:
        # namespaces are provisioned by the server's admin surface
        # (pio app new / channel new); nothing to do from here
        self._params(app_id, channel_id)
        return True

    def remove(self, app_id, channel_id=None) -> bool:
        # no bulk-drop route in the event API: delete what find returns.
        # An already-empty namespace is a successful remove, as in every
        # embedded backend. Stream the paginated generator — the time
        # cursor only moves forward, so deleting already-yielded (earlier)
        # events cannot disturb later pages, and the store never
        # materializes in memory.
        for e in self.find(app_id, channel_id, limit=-1):
            self.delete(e.event_id, app_id, channel_id)
        return True

    @staticmethod
    def _with_id(event: Event) -> Event:
        """Assign the eventId CLIENT-side before sending: the transparent
        reconnect below may re-send a request the server already
        processed, and a re-send carrying the same id overwrites by key
        instead of inserting a duplicate (the same idempotency the pgsql
        backend gets from INSERT ... ON CONFLICT)."""
        from predictionio_tpu_torch.data.event import new_event_id
        if event.event_id:
            return event
        return event.with_id(new_event_id())

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        params = self._params(app_id, channel_id)
        event = self._with_id(event)
        status, body = self._request("POST", "/events.json", params,
                                     event.to_dict())
        if status != 201:
            raise RemoteError(status, (body or {}).get("message", ""))
        return body["eventId"]

    #: rows per columnar bulk-write POST (~4 MB of typical JSON; the
    #: server's default bound is 1M rows)
    COLUMNAR_WRITE_PAGE = 100_000

    def bulk_create(self, events: Sequence[Event], app_id,
                    channel_id=None) -> List[str]:
        """Bulk ingest as ONE ``POST /events/columnar.json`` write per
        page — one parse and one bulk insert server-side instead of
        ceil(n/50) object-array batches. Ids are assigned
        client-side first (re-send idempotency, as insert). A 404 from
        a pre-columnar server falls back to chunked /batch posts, once
        per client. Any per-record failure raises RemoteError with the
        first failure's status, matching insert_batch."""
        params = self._params(app_id, channel_id)
        evs = [self._with_id(e) for e in events]
        if not evs:
            return []
        # the columnar wire has no tags/prId columns — events carrying
        # either must take the object /batch path or the server would
        # 201 them with the fields silently dropped. (creationTime is
        # server-assigned metadata on the columnar route, matching the
        # reference's server-side stamping.)
        if (self._no_columnar_write
                or any(e.tags or e.pr_id for e in evs)):
            return self._insert_batch_objects(evs, params)
        from predictionio_tpu_torch.data.columnar import events_to_wire
        ids: List[str] = []
        for lo in range(0, len(evs), self.COLUMNAR_WRITE_PAGE):
            page = evs[lo:lo + self.COLUMNAR_WRITE_PAGE]
            status, body = self._request(
                "POST", "/events/columnar.json", params,
                events_to_wire(page))
            if status == 404:
                # a server without the columnar write route
                self._no_columnar_write = True
                return ids + self._insert_batch_objects(evs[lo:], params)
            if status not in (200, 201):
                raise RemoteError(status, (body or {}).get("message", ""))
            fails = (body or {}).get("failures")
            if fails:
                f = fails[0]
                raise RemoteError(f.get("status", 400),
                                  f.get("message", ""))
            ids.extend(e.event_id for e in page)
        return ids

    def insert_batch(self, events: Sequence[Event], app_id,
                     channel_id=None) -> List[str]:
        return self.bulk_create(events, app_id, channel_id)

    def insert_columnar(self, batch, app_id, channel_id=None):
        """Forward the parallel arrays as ONE wire body per page — no
        Event materialization on either side when the server has the
        columnar write route."""
        params = self._params(app_id, channel_id)
        if batch.n == 0:
            return []
        if self._no_columnar_write:
            return super().insert_columnar(batch, app_id, channel_id)
        ids: List[str] = []
        for lo in range(0, batch.n, self.COLUMNAR_WRITE_PAGE):
            page = batch.slice_rows(lo, min(lo + self.COLUMNAR_WRITE_PAGE,
                                            batch.n))
            body = page.to_wire()
            if page.event_id is None:
                body["returnIds"] = True
            status, resp = self._request("POST", "/events/columnar.json",
                                         params, body)
            if status == 404:
                self._no_columnar_write = True
                return ids + super().insert_columnar(
                    batch.slice_rows(lo, batch.n), app_id, channel_id)
            if status not in (200, 201):
                raise RemoteError(status, (resp or {}).get("message", ""))
            fails = (resp or {}).get("failures")
            if fails:
                f = fails[0]
                raise RemoteError(f.get("status", 400),
                                  f.get("message", ""))
            ids.extend(page.event_id if page.event_id is not None
                       else resp.get("eventIds", []))
        return ids

    def _insert_batch_objects(self, evs: Sequence[Event],
                              params: dict) -> List[str]:
        """The pre-columnar wire shape: chunked /batch/events.json."""
        ids: List[str] = []
        for lo in range(0, len(evs), MAX_BATCH):
            status, body = self._request(
                "POST", "/batch/events.json", params,
                [e.to_dict() for e in evs[lo:lo + MAX_BATCH]])
            if status != 200:
                raise RemoteError(status, (body or {}).get("message", ""))
            for item in body:
                if item.get("status") != 201:
                    raise RemoteError(item.get("status", 400),
                                      item.get("message", ""))
                ids.append(item["eventId"])
        return ids

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        params = self._params(app_id, channel_id)
        status, body = self._request(
            "GET", f"/events/{urllib.parse.quote(event_id)}.json", params)
        if status == 404:
            return None
        if status != 200:
            raise RemoteError(status, (body or {}).get("message", ""))
        return Event.from_dict(body)

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        params = self._params(app_id, channel_id)
        status, body = self._request(
            "DELETE", f"/events/{urllib.parse.quote(event_id)}.json",
            params)
        if status == 404:        # server answers 404 for an unknown id
            return False
        if status != 200:
            raise RemoteError(status, (body or {}).get("message", ""))
        return True

    @staticmethod
    def _iso(t: dt.datetime) -> str:
        return t.astimezone(dt.timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z"

    PAGE_SIZE = 10_000  # unbounded reads paginate (one giant JSON body
    #                     for a 20M-event store would OOM both sides)
    COLUMNAR_PAGE = 500_000  # rows per columnar window (~25 MB JSON):
    #                     far fewer round trips than the object path's
    #                     pages, same bounded-response guarantee

    def _find_params(self, app_id, channel_id, start_time, until_time,
                     entity_type, entity_id, event_names,
                     target_entity_type, target_entity_id):
        params = self._params(app_id, channel_id)
        if start_time is not None:
            params["startTime"] = self._iso(start_time)
        if until_time is not None:
            params["untilTime"] = self._iso(until_time)
        if entity_type is not None:
            params["entityType"] = entity_type
        if entity_id is not None:
            params["entityId"] = entity_id
        if event_names:
            params["event"] = ",".join(event_names)
        if target_entity_type is not None:
            params["targetEntityType"] = (
                "" if target_entity_type is ABSENT else target_entity_type)
        if target_entity_id is not None:
            params["targetEntityId"] = (
                "" if target_entity_id is ABSENT else target_entity_id)
        return params

    def _fetch(self, params):
        status, body = self._request("GET", "/events.json", params)
        if status == 404:
            return []
        if status != 200:
            raise RemoteError(status, (body or {}).get("message", ""))
        return [Event.from_dict(d) for d in body]

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None, limit=None,
             reversed_order=False):
        base = self._find_params(app_id, channel_id, start_time, until_time,
                                 entity_type, entity_id, event_names,
                                 target_entity_type, target_entity_id)
        unbounded = limit is None or limit < 0
        if reversed_order or (not unbounded and limit <= self.PAGE_SIZE):
            # reversed reads are entity-scoped (small) per the API
            # contract; small bounded reads go out as one request
            params = dict(base, limit=(-1 if unbounded else limit))
            if reversed_order:
                params["reversed"] = "true"
            return iter(self._fetch(params))
        gen = self._find_paginated(base)
        if unbounded:
            return gen
        import itertools
        return itertools.islice(gen, limit)   # big bounded reads page too

    def find_columnar(self, app_id, channel_id=None, property_field=None,
                      start_time=None, until_time=None, entity_type=None,
                      entity_id=None, event_names=None,
                      target_entity_type=None, target_entity_id=None,
                      limit=None, reversed_order=False):
        """Training-ingest read over the wire as flat column arrays
        (GET /events/columnar.json): one response of JSON columns is
        ~4x leaner than paging per-event objects and parses without
        per-event dicts. Servers predating the route (404 body without
        column keys) fall back to the streamed-find default."""
        import numpy as np
        if reversed_order:
            # entity-scoped small reads: the object path is fine
            return super().find_columnar(
                app_id, channel_id=channel_id,
                property_field=property_field, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                entity_id=entity_id, event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id, limit=limit,
                reversed_order=True)
        base = self._find_params(app_id, channel_id, start_time,
                                 until_time, entity_type, entity_id,
                                 event_names, target_entity_type,
                                 target_entity_id)
        if property_field is not None:
            base["propertyField"] = property_field

        def fetch(extra):
            status, body = self._request(
                "GET", "/events/columnar.json", dict(base, **extra))
            if status == 404 and not (isinstance(body, dict)
                                      and "entity_id" in body):
                return None                 # server predates the route
            if status != 200:
                raise RemoteError(status, (body or {}).get("message", ""))
            return body

        keys = ["entity_id", "target_entity_id", "event", "t"] + (
            ["prop"] if property_field is not None else [])
        unbounded = limit is None or limit < 0
        # Big reads page by TIME WINDOWS so neither side ever holds the
        # whole store as one JSON body (the same OOM rationale as the
        # object path's pagination): each page keeps only its COMPLETE
        # milliseconds — the boundary millisecond is refetched whole on
        # the next request — so correctness never depends on a stable
        # intra-millisecond order across requests.
        chunks = []
        remaining = None if unbounded else limit
        page = self.COLUMNAR_PAGE
        cursor_ms = None
        while True:
            extra = {"limit": page}
            if not unbounded and remaining <= page:
                extra["limit"] = remaining
            if cursor_ms is not None:
                extra["startTime"] = self._iso(from_millis(cursor_ms))
            body = fetch(extra)
            if body is None:
                # old server: stream the object path instead
                return super().find_columnar(
                    app_id, channel_id=channel_id,
                    property_field=property_field, start_time=start_time,
                    until_time=until_time, entity_type=entity_type,
                    entity_id=entity_id, event_names=event_names,
                    target_entity_type=target_entity_type,
                    target_entity_id=target_entity_id, limit=limit)
            n = len(body["t"])
            got_full_page = n >= extra["limit"] >= 0
            if not got_full_page or (not unbounded and remaining <= page):
                chunks.append(body)
                if remaining is not None:
                    remaining -= n
                break
            last = body["t"][-1]
            keep = next((i for i in range(n - 1, -1, -1)
                         if body["t"][i] < last), -1) + 1
            if keep:
                chunks.append({k: body[k][:keep] for k in keys})
                if remaining is not None:
                    remaining -= keep
                    if remaining <= 0:
                        break
                cursor_ms = last
            else:
                # the page is entirely one millisecond: fetch that
                # millisecond whole (bounded by events-per-ms), move on
                full = fetch({"limit": -1,
                              "startTime": self._iso(from_millis(last)),
                              "untilTime": self._iso(
                                  from_millis(last + 1))})
                chunks.append(full)
                if remaining is not None:
                    remaining -= len(full["t"])
                    if remaining <= 0:
                        break
                cursor_ms = last + 1

        def col(k, dtype):
            return np.concatenate(
                [np.asarray(c[k], dtype=dtype) for c in chunks]) \
                if chunks else np.array([], dtype=dtype)

        out = {
            "entity_id": col("entity_id", str),
            "target_entity_id": col("target_entity_id", str),
            "event": col("event", str),
            "t": col("t", np.int64),
        }
        if property_field is not None:
            out["prop"] = np.concatenate(
                [np.array([np.nan if v is None else v
                           for v in c.get("prop", [])], dtype=np.float32)
                 for c in chunks]) if chunks else np.array(
                     [], dtype=np.float32)
        if not unbounded:
            out = {k: v[:limit] for k, v in out.items()}
        return out

    def find_columnar_chunked(self, app_id, channel_id=None,
                              property_field=None, chunk_rows=None,
                              start_time=None, until_time=None,
                              entity_type=None, entity_id=None,
                              event_names=None, target_entity_type=None,
                              target_entity_id=None):
        """Streaming columnar read chunked AT THE WIRE: each chunk is
        one ``GET /events/columnar.json`` page trimmed to complete
        milliseconds (the boundary millisecond is refetched whole by
        the next page), so the dataplane reader decodes page N while
        page N+1 is in flight and neither side ever holds more than
        ``chunk_rows`` rows of JSON. Servers predating the columnar
        route fall back to the generic keyset default (which itself
        degrades to the paged object read)."""
        import numpy as np

        chunk_rows = int(chunk_rows or base.DEFAULT_CHUNK_ROWS)
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        params = self._find_params(app_id, channel_id, start_time,
                                   until_time, entity_type, entity_id,
                                   event_names, target_entity_type,
                                   target_entity_id)
        if property_field is not None:
            params["propertyField"] = property_field

        def fetch(extra):
            status, body = self._request(
                "GET", "/events/columnar.json", dict(params, **extra))
            if status == 404 and not (isinstance(body, dict)
                                      and "entity_id" in body):
                return None                 # server predates the route
            if status != 200:
                raise RemoteError(status, (body or {}).get("message", ""))
            return body

        def as_cols(body):
            out = {
                "entity_id": np.asarray(body["entity_id"], dtype=str),
                "target_entity_id": np.asarray(
                    body["target_entity_id"], dtype=str),
                "event": np.asarray(body["event"], dtype=str),
                "t": np.asarray(body["t"], dtype=np.int64),
            }
            if property_field is not None:
                out["prop"] = np.array(
                    [np.nan if v is None else v
                     for v in body.get("prop", [])], dtype=np.float32)
            return out

        cursor_ms = None
        while True:
            extra = {"limit": chunk_rows + 1}
            if cursor_ms is not None:
                extra["startTime"] = self._iso(from_millis(cursor_ms))
            body = fetch(extra)
            if body is None:
                # old server: ride the generic keyset default (whose
                # find_columnar calls page the object path themselves)
                yield from super().find_columnar_chunked(
                    app_id, channel_id=channel_id,
                    property_field=property_field, chunk_rows=chunk_rows,
                    start_time=(from_millis(cursor_ms)
                                if cursor_ms is not None else start_time),
                    until_time=until_time, entity_type=entity_type,
                    entity_id=entity_id, event_names=event_names,
                    target_entity_type=target_entity_type,
                    target_entity_id=target_entity_id)
                return
            n = len(body["t"])
            if n <= chunk_rows:
                if n:
                    yield as_cols(body)
                return
            last = body["t"][-1]
            keep = next((i for i in range(n - 1, -1, -1)
                         if body["t"][i] < last), -1) + 1
            if keep:
                yield as_cols({k: v[:keep] for k, v in body.items()
                               if isinstance(v, list)})
                cursor_ms = last
            else:
                # the page is entirely one millisecond: fetch that
                # millisecond whole (bounded by events-per-ms)
                full = fetch({"limit": -1,
                              "startTime": self._iso(from_millis(last)),
                              "untilTime": self._iso(
                                  from_millis(last + 1))})
                if full is not None and len(full["t"]):
                    yield as_cols(full)
                cursor_ms = last + 1

    def find_columnar_by_entities(self, app_id, channel_id=None,
                                  entity_ids=None, target_entity_ids=None,
                                  property_field=None, start_time=None,
                                  until_time=None, entity_type=None,
                                  target_entity_type=None, event_names=None,
                                  limit=None):
        """Entity-filtered columnar read as ONE batched POST
        (``POST /events/columnar.json``): the touched id lists travel in
        the JSON body — far past any query-string cap — and the server
        runs its backend's pushdown, so the wire carries only the
        touched histories. Servers predating the route (404 body
        without column keys) fall back to the streamed default."""
        import numpy as np

        params = self._params(app_id, channel_id)
        body: dict = {
            "entityIds": [str(x) for x in (entity_ids or ())],
            "targetEntityIds": [str(x) for x in (target_entity_ids or ())],
        }
        if property_field is not None:
            body["propertyField"] = property_field
        if start_time is not None:
            body["startTime"] = self._iso(start_time)
        if until_time is not None:
            body["untilTime"] = self._iso(until_time)
        if entity_type is not None:
            body["entityType"] = entity_type
        if target_entity_type is not None:
            body["targetEntityType"] = (
                "" if target_entity_type is ABSENT else target_entity_type)
        if event_names is not None:
            body["events"] = list(event_names)
        if limit is not None:
            body["limit"] = int(limit)
        status, resp = self._request("POST", "/events/columnar.json",
                                     params, body)
        if status == 404 and not (isinstance(resp, dict)
                                  and "entity_id" in resp):
            # old server: the base default streams find() over the wire
            return super().find_columnar_by_entities(
                app_id, channel_id=channel_id, entity_ids=entity_ids,
                target_entity_ids=target_entity_ids,
                property_field=property_field, start_time=start_time,
                until_time=until_time, entity_type=entity_type,
                target_entity_type=target_entity_type,
                event_names=event_names, limit=limit)
        if status != 200:
            raise RemoteError(status, (resp or {}).get("message", ""))
        out = {
            "entity_id": np.asarray(resp["entity_id"], dtype=str),
            "target_entity_id": np.asarray(resp["target_entity_id"],
                                           dtype=str),
            "event": np.asarray(resp["event"], dtype=str),
            "t": np.asarray(resp["t"], dtype=np.int64),
        }
        if property_field is not None:
            out["prop"] = np.array(
                [np.nan if v is None else v for v in resp.get("prop", [])],
                dtype=np.float32)
        return out

    def _find_paginated(self, base_params):
        """Stream an unbounded time-ascending find in PAGE_SIZE chunks.
        The cursor is the last page's final eventTime; since multiple
        events can share a millisecond, the next page re-requests from
        that (inclusive) time and the ids already yielded at the
        boundary millisecond are skipped. A page made entirely of one
        millisecond cannot advance the cursor, so the page size doubles
        until it does."""
        page = self.PAGE_SIZE
        cursor: Optional[str] = None
        cursor_ms: Optional[int] = None
        boundary_ids: set = set()
        while True:
            params = dict(base_params, limit=page)
            if cursor is not None:
                params["startTime"] = cursor
            events = self._fetch(params)
            fresh = [e for e in events if e.event_id not in boundary_ids]
            yield from fresh
            if len(events) < page:
                return                      # final page
            last_ms = to_millis(events[-1].event_time)
            same_ms_ids = {e.event_id for e in events
                           if to_millis(e.event_time) == last_ms}
            if len(same_ms_ids) == len(events) and not fresh:
                # the whole page shares one millisecond and nothing new
                # was yielded: the cursor cannot advance — widen the page
                page *= 2
                continue
            if cursor_ms == last_ms:
                # several pages ending inside one millisecond: keep every
                # id already yielded at it, or re-requests re-yield them
                boundary_ids |= same_ms_ids
            else:
                boundary_ids = same_ms_ids
                page = self.PAGE_SIZE   # past the dense ms: re-bound
            cursor = self._iso(events[-1].event_time)
            cursor_ms = last_ms
