"""Slow-query forensics: stage waterfalls for tail requests.

The port's copy of `predictionio_tpu/obs/slowlog.py` (`SlowQueryLog`,
`SLOWLOG`, `get_slowlog`, `slow_threshold_s`, `build_waterfall`,
`capture_slow_query`, `slow_response`). Every query whose end-to-end
wall exceeds the SLO-derived threshold (`PIO_SLOW_QUERY_MS`, else
`PIO_SLO_SERVE_P99_MS`, default 250 ms) captures a stage waterfall:

    queue_wait -> batch_formation -> supplement -> dispatch
    [-> device_sync] -> completion_wait -> d2h_wait -> unpack
    -> post_process -> serialize

built from the spans the serve path records: the query trace's
`batch_wait`, and the linked `batch_predict` trace's `supplement`,
`predict`, `readback` and `post_process` spans with the window's
`formationMs` and `completionWaitMs`. `device_sync` appears when the
window's dispatch was a sampled one whose CUDA-event stamps had been read
(`obs/costmon.device_timed` sets the `predict` span's `deviceMs` then;
no synchronize is added for it); `d2h_wait` is the `readback` span's
wait on the packed copy. Captures land in a bounded ring served at
`GET /slow.json`, as a coalesced `slow_query` flight record, and in
every incident bundle (the `slow_queries` provider).

Only queries that already blew the bound pay for a waterfall; the fast
path pays one float comparison.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

#: span-name -> waterfall-stage mapping; order is the waterfall order.
#: completion_wait/readback appear on the pipelined executor's windows:
#: the sit in the completion queue and the deferred device->host fetch
#: that the overlap moved out of the dispatch.
_STAGE_SPANS = (
    ("supplement", "supplement"),
    ("predict", "dispatch"),
    ("readback", "readback"),
    ("post_process", "post_process"),
)


def _env_ms(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def slow_threshold_s() -> float:
    """The SLO-derived slow-query bound: an explicit
    ``PIO_SLOW_QUERY_MS`` wins, else the serve-p99 SLO latency
    threshold (obs/slo.py default_engine_specs) — a query slower than
    the bound the SLO promises 99% of traffic beats IS the tail."""
    explicit = os.environ.get("PIO_SLOW_QUERY_MS")
    if explicit is not None:
        try:
            return float(explicit) / 1000.0
        except (TypeError, ValueError):
            pass
    return _env_ms("PIO_SLO_SERVE_P99_MS", 250.0) / 1000.0


def _find_span(trace, name: str):
    if trace is None:
        return None
    for s in trace.spans:
        if s.name == name:
            return s
    return None


def build_waterfall(query_trace, batch_trace=None,
                    serialize_s: Optional[float] = None) -> List[dict]:
    """The stage list for one slow request. ``query_trace`` is the
    (possibly still-open) ingress trace on the request thread;
    ``batch_trace`` the committed ``batch_predict`` trace that answered
    it, when the micro-batcher coalesced it (None = unbatched, the
    stages live in the query trace itself)."""
    stages: List[dict] = []

    def add(stage: str, seconds: Optional[float]):
        if seconds is None:
            return
        stages.append({"stage": stage,
                       "ms": round(max(float(seconds), 0.0) * 1000.0,
                                   3)})

    qw = _find_span(query_trace, "batch_wait")
    # always present (0 for the unbatched path): the waterfall's shape
    # stays stable across serving modes
    add("queue_wait", qw.duration_s if qw is not None else 0.0)
    src = batch_trace if batch_trace is not None else query_trace
    if batch_trace is not None:
        fm = batch_trace.root.attrs.get("formationMs")
        if fm is not None:
            add("batch_formation", float(fm) / 1000.0)
    for span_name, stage in _STAGE_SPANS:
        if stage == "readback" and batch_trace is not None:
            # pipelined executor: the window's time in the
            # completion queue precedes its readback
            cw = batch_trace.root.attrs.get("completionWaitMs")
            if cw is not None:
                add("completion_wait", float(cw) / 1000.0)
        s = _find_span(src, span_name)
        if s is None or s.duration_s is None:
            continue
        if stage == "dispatch":
            device_ms = s.attrs.get("deviceMs")
            if device_ms is not None:
                # the window's sampled device time had been read:
                # split the predict span into enqueue vs device wall
                add("dispatch",
                    max(s.duration_s - float(device_ms) / 1000.0, 0.0))
                add("device_sync", float(device_ms) / 1000.0)
                continue
        if stage == "readback":
            d2h_ms = s.attrs.get("d2hWaitMs")
            if d2h_ms is not None:
                # readback plane: the copy went in flight at
                # dispatch, so the span decomposes into the blocked
                # wait on that copy vs host-side unpack + fan-out
                add("d2h_wait", float(d2h_ms) / 1000.0)
                add("unpack",
                    max(s.duration_s - float(d2h_ms) / 1000.0, 0.0))
                continue
        add(stage, s.duration_s)
    add("serialize", serialize_s)
    return stages


class SlowQueryLog:
    """Bounded newest-last ring of slow-query waterfall entries."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=capacity)
        self.recorded = 0
        self._registered = False
        self._register_metrics()

    def _register_metrics(self):
        if self._registered:
            return
        self._registered = True
        from predictionio_tpu_torch.obs.metrics import get_registry
        get_registry().counter_func(
            "pio_slow_queries_total",
            "Requests whose end-to-end wall exceeded the SLO-derived "
            "slow-query threshold and captured a stage waterfall",
            lambda: self.recorded)

    def record(self, entry: dict):
        with self._lock:
            self._ring.append(entry)
            self.recorded += 1

    def snapshot(self, limit: int = 20) -> List[dict]:
        """Newest first."""
        with self._lock:
            recs = list(self._ring)
        recs.reverse()
        return recs[:max(0, int(limit))]

    def top(self, limit: int = 5) -> List[dict]:
        """Slowest first — the incident-bundle view."""
        with self._lock:
            recs = list(self._ring)
        recs.sort(key=lambda r: r.get("totalMs", 0.0), reverse=True)
        return recs[:max(0, int(limit))]

    def provider_state(self) -> dict:
        """Incident provider: the top waterfalls + counters, so every
        postmortem bundle names the requests that blew the tail."""
        return {"thresholdMs": round(slow_threshold_s() * 1000.0, 3),
                "recorded": self.recorded,
                "top": self.top(5)}

    def clear(self):
        with self._lock:
            self._ring.clear()


# The process-wide slow-query log.
SLOWLOG = SlowQueryLog()


def get_slowlog() -> SlowQueryLog:
    return SLOWLOG


def slow_response(params: dict) -> dict:
    """Shared ``GET /slow.json`` handler body: ``?n=``/``?limit=``
    (default 20, newest first)."""
    limit = int(params.get("n", params.get("limit", 20)))
    return {"slow": SLOWLOG.snapshot(limit=limit),
            "thresholdMs": round(slow_threshold_s() * 1000.0, 3),
            "recorded": SLOWLOG.recorded}


def capture_slow_query(query_trace, total_s: float,
                       query: Optional[dict] = None,
                       model_version: Optional[str] = None,
                       serialize_s: Optional[float] = None,
                       batch_trace_id: Optional[str] = None,
                       tenant: Optional[str] = None) -> dict:
    """Build + record one slow-query entry (request thread, slow path
    only). Resolves the answering batch trace from the query trace's
    links, emits the ``slow_query`` flight record (which stamps the
    current trace id), and returns the entry. ``tenant`` (or, absent
    that, the active tenant scope) rides the waterfall row — the field
    that makes host-routed slow queries attributable."""
    from predictionio_tpu_torch.obs.flight import FLIGHT
    from predictionio_tpu_torch.obs.tenantctx import current_tenant
    from predictionio_tpu_torch.obs.trace import TRACER
    if tenant is None:
        tenant = current_tenant()
    batch_trace = None
    if batch_trace_id:
        batch_trace = TRACER.get(batch_trace_id)
    stages = build_waterfall(query_trace, batch_trace,
                             serialize_s=serialize_s)
    entry = {
        "traceId": query_trace.trace_id,
        "t": time.time(),
        "totalMs": round(total_s * 1000.0, 3),
        "thresholdMs": round(slow_threshold_s() * 1000.0, 3),
        "stages": stages,
    }
    if batch_trace is not None:
        entry["batchTraceId"] = batch_trace.trace_id
        entry["batchSize"] = batch_trace.root.attrs.get("batch")
    if tenant is not None:
        entry["tenant"] = tenant
    if model_version is not None:
        entry["modelVersion"] = model_version
    if query is not None:
        entry["query"] = query
    SLOWLOG.record(entry)
    # coalesced like shed: during a tail
    # blowout EVERY query is slow, and one flight record per request
    # would evict the ring narrative the record exists to preserve —
    # the slowlog ring itself keeps every waterfall
    FLIGHT.record("slow_query", model_version=model_version,
                  coalesce_s=1.0,
                  totalMs=entry["totalMs"],
                  thresholdMs=entry["thresholdMs"],
                  stages=len(stages))
    return entry


def _register_providers():
    """The slow-query log and the sampling profiler ride EVERY
    incident bundle (the serve-p99 breach capture is the headline
    consumer, but a rollback or breaker-open postmortem wants the same
    evidence). Module-import registration — the singletons are
    process-lifetime, and name-keyed registration is idempotent."""
    try:
        from predictionio_tpu_torch.obs.incidents import get_incidents
        from predictionio_tpu_torch.obs.profiler import PROFILER
        inc = get_incidents()
        inc.register_provider("slow_queries", SLOWLOG.provider_state)
        inc.register_provider("profiler", PROFILER.report_state)
    except Exception:   # pragma: no cover — import-order safety net
        pass


_register_providers()
