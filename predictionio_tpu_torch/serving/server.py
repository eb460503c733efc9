"""The engine server: `POST /queries.json`, `GET /`, `GET /stats.json`,
`GET /plugins.json`, `/reload` and `/stop`.

The port's counterpart of the query and deploy paths of
`predictionio_tpu/serving/server.py`. Deploy (`EngineServer.load`, what
`pio deploy` calls): the engine instance the config names, or the latest
COMPLETED one of its engine id/version/variant -> its engine factory ->
the model blob -> the engine params from the instance's JSON -> the
engine's `prepare_deploy`, which puts each model on its algorithm's
device -> the warm-up -> the swap. The warm-up (`_warm_aot`,
`compile/aot.warm_models`) captures, as CUDA graphs, the serve
executables each algorithm's `aot_warm_specs` names for the new models:
every pow2 batch bucket a window can pad to (up to `micro_batch`), so a
window replays a graph from its first query. It is timed (`/stats.json`
`aotWarm`), and a failed capture fails `load()` (the reference's warm is
fail-soft); an algorithm without specs is not warmed, as in the
reference. `/reload` restores the latest instance again and swaps it in
(a hot swap: a query answers from the old or the new models, never a
mix); `/stop` shuts the server down. A server may also be handed a
trained engine (`TrainResult`) directly.

Queries go through the micro-batcher (`serving/batcher.py`) by default
(`micro_batch` = 16, as the reference's default deploy): each body is
decoded once, on its request thread, and a window of concurrent queries
snapshots the model set once, under the lock, supplements its queries
and starts every algorithm's
`batch_predict_begin` (a synchronous `batch_predict` for one without
it); its `finish()` waits for the results (`ops/readback.py`), serves and
serializes them. With `serve_inflight` > 1 the windows are pipelined.
`micro_batch` <= 1 answers each request on its own thread through
`predict`. `X-PIO-Deadline-Ms` gives a query's deadline: a query the
queue cannot answer in time is shed with 503 and `Retry-After`; a
malformed value answers 400. A malformed body (bad JSON, not an object,
a missing or mistyped field) answers 400, as the reference does, and
fails no other query of its window.

The online fold-in publishes through `swap_models` (in process: the
scheduler of `online/scheduler.attach_scheduler`) or through `/reload`
(`python -m predictionio_tpu_torch update` in another process); both warm
the new models before the swap. `/stats.json` counts the swaps and the
fold-ins (`modelSwaps`, `foldIns`, `foldInEvents`, `modelVersion`) and
says when a failed publish left the server on a stale model
(`publishDegraded`, `publishFailures`, `modelStalenessSec`).

The result cache (`serving/result_cache.py`, on by default as in the
reference; `ServerConfig.result_cache=False` or `PIO_SERVE_CACHE=off`
turns it off) answers a repeated `/queries.json` body with the response
bytes its first answer stored: looked up by the request's bytes before
the JSON parse, then by the canonical query after it, so a hit enters
neither the micro-batcher nor the device and is never re-encoded. A miss
reads the cache's generation before it computes, serializes once and
stores those bytes, and the store is refused if an invalidation landed
meanwhile. A fold's `swap_models(touched_entities=...)` drops exactly the
touched users' and items' entries; a swap without them, a `load()` or
`/reload`, and a canary promote clear the cache.

A guarded deploy (`canary_fraction` > 0, `guard/canary.py`): a swap
stages the new models as a candidate instead, which answers that share
of the traffic, chosen once a micro-batch window (once a query without
the batcher), so a window never mixes the two; its responses carry
`X-PIO-Canary` and are never cached, and the cache is bypassed while the
canary runs. The watchdog promotes the candidate (a swap that clears the
cache) or rolls back to the incumbent, and hands its verdict to
`on_canary_decision` (the attached scheduler's `note_canary_decision`),
or, with no scheduler attached, pins or demotes the version in the
registry. `load()` and `/reload` abandon an undecided canary.

The feedback loop (`ServerConfig.feedback`, the reference's
CreateServer.scala:526-596): each answer gets a `prId` (the query's, else
the engine instance id) and is posted to the event server at
`event_server_ip:event_server_port` with `accesskey` as a `predict`
event of entity type `pio_pr` (entity id the prId, properties the query
and the prediction), on a daemon thread of its own; a failed post is
logged. Output plugins (`PIO_ENGINE_SERVER_PLUGINS`,
`serving/plugins.py`) then see the prediction: sniffers observe it and
blockers transform the response. Both run on both query paths, and
either one turns the result cache off, since every answer must post its
event and pass the plugins.

`GET /metrics` renders the server's `MetricsRegistry` (chained to the
process-wide one) in the Prometheus text format: the reference's serve,
batcher, readback, result-cache, canary and guard families, and the
process's compile plane, device time, transfer bytes and fold families.
`/stats.json` carries the registry's `aot` snapshot, the device time by
executable and the occupancy (`deviceTime`), the build directory's
status (`buildCache`; the reference's `xlaCache`) and
`swapToFirstQueryMs`, the wall from the latest model change to its first
served query.

The diagnostics plane (`obs/`): each `/queries.json` that misses the
result cache runs under a `query` trace (minted, or adopted from a valid
inbound `X-PIO-Trace-Id`) with the `supplement`, `predict`, `readback`
and `post_process` spans (on the batched path, in the window's
`batch_predict` trace, which the query's trace links); a `/reload` that
carries a trace id runs under a `reload` trace; the feedback POST sends
the answering trace's context (the query's, or its window's). `GET /traces.json`, `/flight.json` (the
`model_load`, `hot_swap`, `aot_warm`, `first_query_after_swap` and
`canary_staged` records among others), `/health.json` (the burn-rate
SLOs; a latency SLO that turns `breached` captures an incident),
`/slow.json` (the stage waterfall of every query slower than
`obs/slowlog.slow_threshold_s()`), `/profile.json` (the sampling
profiler's report and the torch.profiler device trace) and
`/incidents.json`, `/incidents/<id>.json` serve it. Once bound, the
server registers as the fleet member `engine_server` (`obs/fleet.py`)
and deregisters in `stop`; `/fleet/status.json`, `/fleet/health.json`,
`/fleet/metrics` and `/fleet/traces.json` serve the fleet's views.

The routes are served by `utils/http` (`Router`, `HttpServer`), as the
event server's are: an unknown path answers 404 and a known path asked
with another method 405.

A sharded deploy across P processes (`parallel/mesh.init_distributed`;
`python -m predictionio_tpu_torch deploy` under `PIO_COORDINATOR`): every
process builds its server, which makes a `serving/mesh_serving.
MeshQueryCoordinator`. Process 0 serves HTTP and broadcasts each query's
JSON body (or its window's list of them) before the device work
(`_spmd_guard`, held until the window's readback); the others run
`serve_mesh_worker`, answering the same payloads on their shards. Under
more than one process the result cache is off (a hit on the primary
would skip the collective the workers wait in, and keep answering after
a worker died), windows are not pipelined (`serve_inflight` 1), a canary
is not staged and `/reload` answers 400: each would run different
programs on different processes. `/stats.json` carries
`meshCoordinator`, `meshCollectives` (this process's collective calls
and bytes by kind, `parallel/collective_stats`) and `modelSharding`,
`/metrics`
`pio_engine_mesh_processes` and `pio_engine_mesh_poisoned`; a poisoned
coordinator answers every query 503.

A serving host's tenant slot (`tenancy/host.py`) is a server made with
`tenant=` and the host's `shared_result_cache`: its query, batch, load
and swap paths (and the micro-batcher's threads) run under the tenant's
attribution scope (`obs/tenantctx.tenant_scope`), so its uploads are
tagged for the HBM budget and its device time is booked to it; its
result cache is the tenant's namespace of the shared one
(`TenantResultCache`); its SLOs read the tenant's thresholds and
series; its incident state registers as `engine_server.<tenant>`; and
`/stats.json` carries `tenant`.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.core.engine import (Engine, EngineParams,
                                                TrainResult)
from predictionio_tpu_torch.data.event import format_event_time, utcnow
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.data.store.event_store import EventStore
from predictionio_tpu_torch.guard.canary import (CANDIDATE, INCUMBENT,
                                                 CanaryConfig,
                                                 CanaryController,
                                                 count_nonfinite)
from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.obs import (FLIGHT, MetricsRegistry, SLOEngine,
                                        TRACER, costmon,
                                        default_engine_specs, fleet,
                                        flight_response, get_incidents,
                                        get_registry, health_response,
                                        ingress_trace_kwargs, register_tenant,
                                        slow_response, tenant_scope,
                                        torchmon, trace_context_headers,
                                        traces_response)
from predictionio_tpu_torch.obs.slowlog import (capture_slow_query,
                                                slow_threshold_s)
from predictionio_tpu_torch.ops import readback
from predictionio_tpu_torch.serving import result_cache as RC
from predictionio_tpu_torch.serving.batcher import MicroBatcher
from predictionio_tpu_torch.serving.plugins import EngineServerPluginContext
from predictionio_tpu_torch.utils.http import (HttpServer, Request, Response,
                                               Router)

logger = logging.getLogger(__name__)

#: the key a candidate's answer carries out of the predict path; the
#: HTTP layer turns it into the `X-PIO-Canary` header
CANARY_TAG = "_pioCanary"


@dataclass
class ServerConfig:
    """(CreateServer.scala:80-98)"""
    ip: str = "127.0.0.1"
    port: int = 8000          # 0 = any free port; `start` records it
    engine_instance_id: Optional[str] = None
    engine_id: Optional[str] = None
    engine_version: Optional[str] = None
    engine_variant: str = "engine.json"
    # the feedback loop: post each answer as a `predict` event to the
    # event server at event_server_ip:event_server_port with accesskey
    accesskey: str = ""
    event_server_ip: str = "0.0.0.0"
    event_server_port: int = 7070
    feedback: bool = False
    # > 1 coalesces concurrent queries into one batched device call, on
    # by default as in the reference; <= 1 answers each on its own
    micro_batch: int = 16
    micro_batch_wait_ms: float = 5.0
    # cap on how long the oldest query may sit in the coalescing stage
    micro_batch_latency_budget_ms: Optional[float] = None
    # windows in flight; None reads PIO_SERVE_INFLIGHT (default 2), 1 is
    # the synchronous loop
    serve_inflight: Optional[int] = None
    adaptive_batching: bool = True
    # the result cache (serving/result_cache.py); PIO_SERVE_CACHE=off
    # also turns it off
    result_cache: bool = True
    result_cache_max_entries: int = 8192
    result_cache_max_bytes: int = 64 << 20
    # guarded deploys (guard/canary.py): > 0 stages each swapped-in
    # version as a candidate answering this share of the traffic until
    # the watchdog promotes it or rolls it back; 0 swaps at once
    canary_fraction: float = 0.0
    canary_window_s: float = 30.0
    canary_min_requests: int = 20
    canary_max_error_ratio: float = 2.0
    canary_max_latency_ratio: float = 3.0
    canary_nan_tolerance: int = 0
    # a sharded deploy across processes: the query broadcast's buffer
    # (every broadcast ships all of it; raise it for large windows of
    # filter-heavy queries) and the seconds after which a broadcast that
    # has not completed poisons the coordinator (503 from then on)
    mesh_broadcast_bytes: int = 1 << 16
    mesh_broadcast_timeout_s: float = 30.0


def _request_deadline_s(headers) -> Optional[float]:
    """`X-PIO-Deadline-Ms`: how long the client still cares about the
    answer, in seconds; None when absent."""
    raw = headers.get("X-PIO-Deadline-Ms")
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError(f"bad deadline {raw!r}: want milliseconds")
    if ms <= 0:
        raise ValueError("deadline must be positive milliseconds")
    return ms / 1000.0


class EngineServer:
    """Serves an engine over HTTP: a `TrainResult` handed in, or the
    engine instance `load()` restores from storage."""

    def __init__(self, config: ServerConfig, engine: Optional[Engine] = None,
                 engine_params: Optional[EngineParams] = None,
                 trained: Optional[TrainResult] = None,
                 plugin_context: Optional[EngineServerPluginContext] = None,
                 tenant: Optional[str] = None,
                 shared_result_cache: Optional[RC.ResultCache] = None,
                 mesh_coordinator=None):
        self.config = config
        # a sharded deploy across processes (module docstring)
        if mesh_coordinator is None:
            from predictionio_tpu_torch.serving.mesh_serving import \
                MeshQueryCoordinator
            mesh_coordinator = MeshQueryCoordinator.create_if_distributed(
                max_bytes=config.mesh_broadcast_bytes,
                broadcast_timeout_s=config.mesh_broadcast_timeout_s)
        self.coordinator = mesh_coordinator
        single_process = self._single_process()
        # a serving host's tenant slot: its query, batch, load and swap
        # paths run under the tenant's attribution scope, and its result
        # cache is the tenant's namespace of the host's shared one
        self.tenant = str(tenant) if tenant is not None else None
        if self.tenant is not None:
            register_tenant(self.tenant)
        self.plugin_context = (
            plugin_context if plugin_context is not None
            else EngineServerPluginContext.load_from_env())
        self.engine = engine
        self.engine_params = engine_params
        self.engine_instance = None
        self.algorithms: List = []
        self.models: List = []
        self.serving = None
        if trained is not None:
            self.algorithms = trained.algorithms
            self.models = trained.models
            self.serving = engine.make_serving(engine_params)
        self.request_count = 0
        self.serving_seconds = 0.0
        self.last_serving_sec = 0.0
        # the dispatch and readback share of the serving time
        self.predict_seconds = 0.0
        # recent serving times, for the p50/p95/p99 of /stats.json
        self._lat_ring = collections.deque(maxlen=4096)
        self.last_aot_warm: Optional[dict] = None
        # armed by every model change: (version, t0, candidate only, the
        # model list it installed); the first query that served it
        # closes it into last_swap_to_first_query_ms
        self._swap_marker = None
        self.last_swap_to_first_query_ms: Optional[float] = None
        # online updates: swaps after the first load, fold-ins that
        # landed, the version that answers, and a failed publish's mark
        self.swap_count = 0
        self.fold_in_count = 0
        self.fold_in_events = 0
        self.model_version: Optional[str] = None
        self.publish_degraded = False
        self.publish_failures = 0
        self._last_swap_wall = time.time()
        # the version a load or a promote made the rollback anchor
        self.last_good_version: Optional[str] = None
        # the canary watchdog's verdict goes here (attach_scheduler sets
        # the scheduler's note_canary_decision); None: to the registry
        self.on_canary_decision = None
        # this server's metrics registry, chained to the process-wide one
        # (the compile plane, device time, transfers, the fold)
        torchmon.install()
        costmon.install()
        self.metrics = MetricsRegistry(parent=get_registry())
        self._h_query = self.metrics.histogram(
            "pio_engine_query_seconds",
            "Per-query serving latency (batched queries observe the "
            "window's wall time each)")
        # the diagnostics plane: the flight recorder's metric context
        # reads this server's families, the burn-rate SLOs answer
        # /health.json, and incident bundles freeze _incident_state
        FLIGHT.add_source(self.metrics)
        self.slo = SLOEngine(default_engine_specs(self.tenant),
                             registries=[self.metrics], tenant=self.tenant)
        # the last status of each SLO: an ok -> breached transition of
        # a latency SLO captures an incident
        self._slo_status: dict = {}
        get_incidents().register_provider(
            "engine_server" if self.tenant is None
            else f"engine_server.{self.tenant}", self._incident_state)
        self.canary = CanaryController(CanaryConfig(
            fraction=config.canary_fraction,
            window_s=config.canary_window_s,
            min_requests=config.canary_min_requests,
            max_error_ratio=config.canary_max_error_ratio,
            max_latency_ratio=config.canary_max_latency_ratio,
            nan_tolerance=config.canary_nan_tolerance),
            registry=self.metrics)
        self.result_cache: Optional[RC.ResultCache] = None
        if config.result_cache and RC.cache_enabled() and single_process:
            if shared_result_cache is not None and self.tenant is not None:
                self.result_cache = RC.TenantResultCache(
                    shared_result_cache, self.tenant)
            else:
                self.result_cache = RC.ResultCache(
                    max_entries=config.result_cache_max_entries,
                    max_bytes=config.result_cache_max_bytes,
                    metrics=self.metrics)
        self._lock = threading.Lock()
        self._stop_lock = threading.Lock()
        self._httpd: Optional[HttpServer] = None
        # the fleet member id, set once the socket is bound
        self._fleet_id: Optional[str] = None
        self.batcher: Optional[MicroBatcher] = None
        if config.micro_batch > 1:
            self.batcher = MicroBatcher(
                self.handle_query_batch, max_batch=config.micro_batch,
                max_wait_ms=config.micro_batch_wait_ms,
                latency_budget_ms=config.micro_batch_latency_budget_ms,
                process_batch_begin=self.handle_query_batch_begin,
                inflight=config.serve_inflight if single_process else 1,
                adaptive=config.adaptive_batching, metrics=self.metrics,
                tenant=self.tenant)
        self._register_metrics()

    def _single_process(self) -> bool:
        return self.coordinator is None or not self.coordinator.multi_process

    def _register_metrics(self) -> None:
        """Mount the serving counters on the registry: func collectors
        read the live attributes at scrape time."""
        m = self.metrics
        if self.coordinator is not None:
            m.gauge_func("pio_engine_mesh_processes",
                         "Processes in the serving mesh",
                         lambda: self.coordinator.health()["processes"])
            m.gauge_func("pio_engine_mesh_poisoned",
                         "1 when a mesh broadcast failed and every query "
                         "answers 503 until the mesh is redeployed",
                         lambda: int(
                             self.coordinator.health()["poisoned"]))
        m.counter_func("pio_engine_requests_total", "Queries served",
                       lambda: self.request_count)
        m.counter_func("pio_engine_serving_seconds_total",
                       "Cumulative serve wall time",
                       lambda: self.serving_seconds)
        m.counter_func("pio_engine_predict_seconds_total",
                       "Cumulative device/predict time",
                       lambda: self.predict_seconds)
        m.counter_func("pio_engine_model_swaps_total",
                       "Hot model swaps since start (reloads + fold-ins)",
                       lambda: self.swap_count)
        m.counter_func("pio_engine_fold_ins_total",
                       "Online fold-in swaps since start",
                       lambda: self.fold_in_count)
        m.counter_func("pio_engine_fold_in_events_total",
                       "Events absorbed by online fold-ins",
                       lambda: self.fold_in_events)
        m.summary_func("pio_engine_serving_seconds",
                       "Recent serving-time quantiles (rolling ring)",
                       self._quantile_samples)
        m.gauge_func("pio_engine_model_stale",
                     "1 while serving a stale model because a fold-in "
                     "publish/hot-swap failed",
                     lambda: int(self.publish_degraded))
        m.gauge_func("pio_engine_model_staleness_seconds",
                     "Age of the serving model (since last load/swap)",
                     lambda: self.model_staleness_s())
        m.counter_func("pio_engine_publish_failures_total",
                       "Fold-in publish/hot-swap failures reported by the "
                       "scheduler", lambda: self.publish_failures)
        m.gauge_func("pio_guard_canary_state",
                     "1 while a canary candidate version serves a fraction "
                     "of this server's traffic",
                     lambda: int(self.canary.active))
        m.gauge_func("pio_engine_swap_to_first_query_ms",
                     "Wall ms from the latest model change (load, hot-swap, "
                     "canary stage/promote) to its first served query",
                     lambda: self.last_swap_to_first_query_ms or 0.0)

    def _incident_state(self) -> dict:
        """Serving and model-lineage state frozen into incident bundles;
        lock-free attribute reads, so a capture never contends with the
        query path."""
        inst = self.engine_instance
        return {
            "modelVersion": self.model_version,
            "lastGoodVersion": self.last_good_version,
            "engineInstance": getattr(inst, "id", None),
            "lineage": getattr(inst, "batch", None),
            "requestCount": self.request_count,
            "modelSwaps": self.swap_count,
            "foldIns": self.fold_in_count,
            "publishDegraded": self.publish_degraded,
            "publishFailures": self.publish_failures,
            "modelStalenessSec": self.model_staleness_s(),
            "canary": self.canary.stats(),
        }

    def _device(self) -> Optional[str]:
        """The device the first algorithm's params name (None: the
        card), which a device trace records for."""
        for algo in self.algorithms:
            dev = getattr(getattr(algo, "params", None), "device", None)
            if dev is not None:
                return str(dev)
        return None

    def _ring_percentiles(self):
        """(p50, p95, p99) of recent serving seconds, or None before any
        traffic. The caller holds the lock."""
        if not self._lat_ring:
            return None
        return np.percentile(list(self._lat_ring), (50, 95, 99))

    def _quantile_samples(self):
        with self._lock:
            pct = self._ring_percentiles()
        if pct is None:
            return None
        return [({"quantile": q}, float(v))
                for q, v in zip(("0.5", "0.95", "0.99"), pct)]

    # -- model loading (createServerActorWithEngine, :206-265) -------------
    def load_engine_instance(self):
        instances = Storage.get_meta_data_engine_instances()
        cfg = self.config
        if cfg.engine_instance_id:
            instance = instances.get(cfg.engine_instance_id)
            if instance is None:
                raise ValueError(
                    f"Invalid engine instance id {cfg.engine_instance_id}")
            return instance
        instance = instances.get_latest_completed(
            cfg.engine_id or "default", cfg.engine_version or "0",
            cfg.engine_variant)
        if instance is None:
            raise ValueError(
                f"No valid engine instance found for engine {cfg.engine_id} "
                f"{cfg.engine_version} {cfg.engine_variant}. Try running "
                "`pio train` first.")
        return instance

    def load(self) -> "EngineServer":
        """Restore the engine instance, warm it and swap it in (the
        deploy path). The models are restored, placed on their devices
        and warmed before the swap, so a query in flight keeps answering
        from the old ones."""
        instance = self.load_engine_instance()
        engine = self.engine
        if engine is None:
            engine = get_engine_factory(instance.engine_factory).apply()
        model = Storage.get_model_data_models().get(instance.id)
        if model is None:
            raise ValueError(
                f"No model found for engine instance {instance.id}")
        persisted = engine.deserialize_models(model.models, instance.id)
        engine_params = self.engine_params
        if engine_params is None:
            engine_params = engine.json_to_engine_params({
                "datasource": json.loads(instance.data_source_params
                                         or "{}"),
                "preparator": json.loads(instance.preparator_params or "{}"),
                "algorithms": json.loads(instance.algorithms_params or "[]"),
                "serving": json.loads(instance.serving_params or "{}"),
            })
        with self._tenant_cm():
            result = engine.prepare_deploy(engine_params, persisted,
                                           instance.id)
        serving = engine.make_serving(engine_params)
        warm = self._warm_aot(result.algorithms, result.models, instance.id)
        with self._lock:
            was_loaded = bool(self.algorithms)
            if was_loaded:
                self.swap_count += 1   # a /reload, not the first load
            self.engine = engine
            self.engine_params = engine_params
            self.engine_instance = instance
            self.algorithms = result.algorithms
            self.models = result.models
            self.serving = serving
            self.last_aot_warm = warm
            self.model_version = instance.id
            # an operator's (re)load is a trusted deploy: the rollback
            # anchor; it supersedes an undecided canary staged on the
            # models it replaces
            self.last_good_version = instance.id
            self.canary.abandon("full (re)load of instance " + instance.id)
            self._last_swap_wall = time.time()
            self.publish_degraded = False
        # a load rebuilds the models wholesale: no touched-row lineage
        if self.result_cache is not None:
            self.result_cache.invalidate_all("reload")
        self._arm_swap_marker(instance.id, models_token=result.models)
        FLIGHT.record("hot_swap" if was_loaded else "model_load",
                      model_version=instance.id, source="load")
        logger.info("Engine instance %s loaded (%d algorithm(s)), warmed "
                    "in %.3f s", instance.id, len(result.algorithms),
                    warm["wallS"])
        return self

    def _tenant_cm(self):
        """The tenant's attribution scope (a no-op scope without one)."""
        return tenant_scope(self.tenant)

    # -- the compile plane --------------------------------------------------
    def _warm_aot(self, algorithms, models, version: Optional[str]) -> dict:
        """Capture the serving executables of `models` before they take a
        request (`compile/aot.warm_models` over the micro-batcher's
        ladder): the caller (a load, a swap, a canary stage) pays the
        captures, never a query. Raises what a capture raises."""
        from predictionio_tpu_torch.compile.aot import warm_models
        with self._tenant_cm():
            summary = warm_models(algorithms, models,
                                  batch_hint=max(self.config.micro_batch, 1),
                                  version=version)
        if summary.get("compiled"):
            FLIGHT.record("aot_warm", model_version=version,
                          **{k: summary[k] for k in
                             ("compiled", "skipped", "wallS")
                             if k in summary})
        return dict(summary, version=version)

    def _arm_swap_marker(self, version: Optional[str],
                         candidate_only: bool = False,
                         models_token=None) -> None:
        """Start the swap-to-first-query clock. `models_token` is the
        model list the change installed: only a query that served it
        closes the marker (one in flight on the old models would bank a
        false ~0 ms); a canary stage passes none and waits for the first
        candidate-served query."""
        with self._lock:
            self._swap_marker = (version, time.perf_counter(),
                                 candidate_only, models_token)

    def _close_swap_marker(self, arm: str, models_used=None) -> None:
        marker = self._swap_marker
        if marker is None:
            return
        version, t0, candidate_only, token = marker
        if candidate_only and arm != CANDIDATE:
            return
        if token is not None and models_used is not token:
            return
        with self._lock:
            if self._swap_marker is not marker:
                return
            self._swap_marker = None
            ms = (time.perf_counter() - t0) * 1000.0
            self.last_swap_to_first_query_ms = ms
        FLIGHT.record("first_query_after_swap", model_version=version,
                      swapToFirstQueryMs=round(ms, 3),
                      canary=candidate_only)

    def reload(self) -> None:
        """Hot-swap to the latest COMPLETED instance of the loaded one's
        engine (:337-358); an instance id named in the config stays."""
        cfg = self.config
        if cfg.engine_instance_id is None and self.engine_instance:
            cfg.engine_id = self.engine_instance.engine_id
            cfg.engine_version = self.engine_instance.engine_version
            cfg.engine_variant = self.engine_instance.engine_variant
        self.engine_params = None  # re-derive from the new instance
        self.load()

    def swap_models(self, models, version: Optional[str] = None,
                    fold_in_events: int = 0,
                    touched_entities: Optional[dict] = None) -> None:
        """The in-process hot swap of a fold-in publish: capture the new
        models' serve executables (`_warm_aot`), then replace the whole
        model list under the serving lock, so a window answers from the
        old set or the new, never a mix (a fold makes new model objects
        and mutates none). With a canary on, the warmed models are staged
        as its candidate instead.

        `touched_entities` ({"user": ids, "item": ids}): the rows the
        fold re-solved; the result cache drops only their entries. None
        (a change without lineage) clears the cache."""
        models = list(models)
        with self._lock:
            algorithms = self.algorithms
        if len(models) != len(algorithms):
            raise ValueError(f"swap_models got {len(models)} models for "
                             f"{len(algorithms)} algorithms")
        warm = self._warm_aot(algorithms, models, version)
        if self._single_process() and self.canary.stage(
                models, version, int(fold_in_events)):
            with self._lock:
                self.last_aot_warm = warm
            self._arm_swap_marker(version, candidate_only=True)
            FLIGHT.record("canary_staged", model_version=version,
                          fraction=self.canary.config.fraction,
                          foldInEvents=int(fold_in_events))
            return
        with self._lock:
            self.models = models
            self.swap_count += 1
            self.fold_in_count += 1
            self.fold_in_events += int(fold_in_events)
            if version is not None:
                self.model_version = version
            self.last_aot_warm = warm
            self._last_swap_wall = time.time()
            self.publish_degraded = False
        self._arm_swap_marker(version, models_token=models)
        FLIGHT.record("hot_swap", model_version=version,
                      source="fold_publish",
                      foldInEvents=int(fold_in_events))
        if self.result_cache is not None:
            if touched_entities is not None:
                self.result_cache.invalidate_entities(
                    RC.entity_tags(touched_entities), reason="fold_swap")
            else:
                self.result_cache.invalidate_all("swap")
        logger.info("Hot-swapped models (swap #%d, version %s)",
                    self.swap_count, version or "<in-process>")

    def note_publish_failure(self) -> None:
        """A fold's publish or swap failed: the server keeps answering
        from its models and says it is stale until a swap lands."""
        with self._lock:
            self.publish_degraded = True
            self.publish_failures += 1

    def model_staleness_s(self) -> float:
        return max(time.time() - self._last_swap_wall, 0.0)

    # -- the canary --------------------------------------------------------
    def _canary_route(self):
        """(candidate models, version, arm) of this window or query:
        (None, None, INCUMBENT) when no canary runs."""
        if not self.canary.enabled:
            return None, None, INCUMBENT
        routed = self.canary.route()
        if routed is None:
            return None, None, INCUMBENT
        models, version = routed
        return models, version, CANDIDATE

    def _canary_observe(self, arm: str, pred_dicts=None, error: bool = False,
                        latency_s: Optional[float] = None,
                        n: int = 1) -> None:
        """Record an arm's outcome and run the watchdog."""
        if not self.canary.enabled:
            return
        nonfinite = (sum(count_nonfinite(d) for d in pred_dicts)
                     if pred_dicts else 0)
        self.canary.record(arm, error=error, nonfinite=nonfinite,
                           latency_s=latency_s, n=n)
        self._apply_canary_decision()

    def _apply_canary_decision(self) -> None:
        """Apply the watchdog's verdict, if it has one: a promote swaps
        the candidate in and clears the cache (a rollback keeps the
        incumbent, whose entries stay valid); then the verdict goes to
        `on_canary_decision`, or is made durable in the registry."""
        decision = self.canary.take_decision()
        if decision is None:
            return
        version = decision["candidateVersion"]
        if decision["decision"] == "promote":
            with self._lock:
                self.models = decision["models"]
                self.swap_count += 1
                self.fold_in_count += 1
                self.fold_in_events += decision["foldInEvents"]
                if version:
                    self.model_version = version
                self.last_good_version = self.model_version
                self._last_swap_wall = time.time()
                self.publish_degraded = False
            self._arm_swap_marker(version, models_token=decision["models"])
            FLIGHT.record("hot_swap", model_version=version,
                          source="canary_promote")
            if self.result_cache is not None:
                # the staged candidate's lineage is gone by now
                self.result_cache.invalidate_all("canary_promote")
            logger.info("Hot-swapped models after a clean canary (swap "
                        "#%d, version %s)", self.swap_count,
                        version or "<in-process>")
        verdict = {k: v for k, v in decision.items() if k != "models"}
        hook = self.on_canary_decision
        if hook is not None:
            try:
                hook(verdict)
            except Exception:
                logger.exception("on_canary_decision hook failed")
            return
        inst = self.engine_instance
        if not version or not getattr(inst, "engine_id", None):
            return
        # no scheduler to hand the verdict to: pin a promote last-good,
        # demote a rollback so no /reload or restart deploys it
        from predictionio_tpu_torch.online.registry import \
            ModelVersionRegistry
        try:
            if decision["decision"] == "promote":
                ModelVersionRegistry().pin_last_good(
                    inst.engine_id, inst.engine_version,
                    inst.engine_variant, version)
            else:
                ModelVersionRegistry().demote_version(version)
        except Exception:
            logger.exception("durable canary verdict failed")

    # -- queries -----------------------------------------------------------
    def _snapshot(self):
        with self._lock:
            algorithms, models, serving = (self.algorithms, self.models,
                                           self.serving)
        if not algorithms:
            raise RuntimeError("no engine is loaded")
        return algorithms, models, serving

    def decode(self, query_dict, algorithms=None):
        """The query object of a JSON body, by the first algorithm's query
        class. Raises ValueError, KeyError or TypeError for a malformed
        body (the HTTP layer answers 400)."""
        if not isinstance(query_dict, dict):
            raise ValueError("query must be a JSON object")
        if algorithms is None:
            algorithms = self._snapshot()[0]
        qc = algorithms[0].query_class
        return qc.from_dict(query_dict) if qc is not None else query_dict

    @staticmethod
    def _to_dict(prediction) -> dict:
        out = (prediction.to_dict() if hasattr(prediction, "to_dict")
               else prediction)
        return out if isinstance(out, dict) else {"result": out}

    def handle_query(self, query_dict: dict) -> dict:
        """One query on the calling thread (`micro_batch` <= 1); a
        candidate's answer carries `CANARY_TAG`."""
        t0 = time.perf_counter()
        algorithms, models, serving = self._snapshot()
        canary_models, canary_version, arm = self._canary_route()
        if canary_models is not None:
            models = canary_models
        query = self.decode(query_dict, algorithms)
        try:
            with self._tenant_cm(), self._spmd_guard(query_dict):
                with TRACER.span("supplement"):
                    supplemented = serving.supplement(query)
                tp = time.perf_counter()
                with TRACER.span("predict", algorithms=len(algorithms)):
                    predictions = [algo.predict(model, supplemented)
                                   for algo, model in zip(algorithms,
                                                          models)]
                predict_dt = time.perf_counter() - tp
                with TRACER.span("post_process"):
                    out = self._to_dict(serving.serve(query, predictions))
                    out = self._post_process(query_dict, out)
        except Exception:
            self._canary_observe(arm, error=True,
                                 latency_s=time.perf_counter() - t0)
            raise
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += 1
            self.serving_seconds += dt
            self.last_serving_sec = dt
            self.predict_seconds += predict_dt
            self._lat_ring.append(dt)
        self._h_query.observe(dt)
        self._close_swap_marker(arm, models_used=models)
        self._canary_observe(arm, pred_dicts=(out,), latency_s=dt)
        if canary_models is not None:
            out = dict(out, **{CANARY_TAG: canary_version or CANDIDATE})
        return out

    def handle_query_batch(self, items: list) -> List[dict]:
        return self.handle_query_batch_begin(items)()

    def handle_query_batch_begin(self, items: list):
        """A window's first stage, over the (query, JSON body) pairs
        `answer` has decoded: snapshot the model set (once, under the
        lock: the window answers from one version whatever swaps in
        meanwhile) and, with a canary running, the window's arm (the
        whole window answers from it), supplement the queries and start
        every algorithm's batch predict. Returns `finish() -> List[dict]`,
        the second stage: wait for the results, serve, post the feedback
        events and run the output plugins (`_post_process`); a candidate
        window's answers carry `CANARY_TAG`. Under a multi-process mesh
        the window's bodies are broadcast first, and the slot is held
        until `finish` has read the results back."""
        t0 = time.perf_counter()
        queries = [q for q, _ in items]
        algorithms, models, serving = self._snapshot()
        canary_models, canary_version, arm = self._canary_route()
        if canary_models is not None:
            models = canary_models
        n = len(queries)
        guard = contextlib.ExitStack()
        try:
            guard.enter_context(self._spmd_guard([d for _, d in items]))
            with self._tenant_cm():
                with TRACER.span("supplement"):
                    indexed = [(i, serving.supplement(q))
                               for i, q in enumerate(queries)]
                tp = time.perf_counter()
                # the dispatch: a replayed graph's (or the eager
                # program's) launch, not its device time
                with TRACER.span("predict", batch=n,
                                 algorithms=len(algorithms)):
                    fetchers = []
                    for algo, model in zip(algorithms, models):
                        begin = getattr(algo, "batch_predict_begin", None)
                        if begin is not None:
                            fetchers.append(begin(model, indexed))
                        else:
                            res = algo.batch_predict(model, indexed)
                            fetchers.append(lambda res=res: res)
                dispatch_dt = time.perf_counter() - tp
        except Exception:
            guard.close()
            self._canary_observe(arm, error=True,
                                 latency_s=time.perf_counter() - t0, n=n)
            raise

        def finish() -> List[dict]:
            try:
                tr = time.perf_counter()
                w0 = readback.thread_wait_s()
                b0 = readback.thread_d2h_bytes()
                # a mesh's slot is held until the results are back
                with guard, TRACER.span("readback") as rb_span:
                    # the wait on the window's copy (in flight since the
                    # dispatch) and the host unpack
                    per_algo = [dict(f()) for f in fetchers]
                    if rb_span is not None:
                        rb_span.attrs["d2hWaitMs"] = round(
                            (readback.thread_wait_s() - w0) * 1000.0, 3)
                        rb_span.attrs["d2hBytes"] = \
                            readback.thread_d2h_bytes() - b0
                readback_dt = time.perf_counter() - tr
                # the copy has landed, so the window's sampled device
                # stamps have passed: book them without a wait
                costmon.harvest()
                with TRACER.span("post_process"):
                    out = [self._post_process(d, self._to_dict(
                        serving.serve(q, [pa[i] for pa in per_algo])))
                        for i, (q, d) in enumerate(items)]
            except Exception:
                self._canary_observe(arm, error=True,
                                     latency_s=time.perf_counter() - t0,
                                     n=n)
                raise
            dt = time.perf_counter() - t0
            with self._lock:
                self.request_count += n
                self.serving_seconds += dt * n
                self.last_serving_sec = dt
                self.predict_seconds += dispatch_dt + readback_dt
                self._lat_ring.extend([dt] * n)
            for _ in range(n):
                self._h_query.observe(dt)
            self._close_swap_marker(arm, models_used=models)
            self._canary_observe(arm, pred_dicts=out, latency_s=dt, n=n)
            if canary_models is not None:
                tag = {CANARY_TAG: canary_version or CANDIDATE}
                return [dict(d, **tag) for d in out]
            return out
        return finish

    def _spmd_guard(self, payload):
        """Broadcast `payload` to the mesh's workers and hold the slot
        for its device work; a no-op in a single process and on a
        worker (whose order is its loop's)."""
        if self.coordinator is None:
            return contextlib.nullcontext()
        return self.coordinator.serialized(payload)

    def serve_mesh_worker(self) -> None:
        """Run this process as a mesh worker: answer every payload the
        primary broadcasts with the same predict, on this process's
        shards, until the primary shuts the loop down. Feedback and
        output plugins stay the primary's (a worker posting them too
        would post every answer P times)."""
        if self.coordinator is None or self.coordinator.is_primary:
            raise RuntimeError("serve_mesh_worker needs a multi-process "
                               "mesh and a process rank above 0")
        if self.config.feedback:
            import dataclasses
            self.config = dataclasses.replace(self.config, feedback=False)
        self.plugin_context = EngineServerPluginContext()

        def handler(obj):
            if isinstance(obj, list):
                self.handle_query_batch([(self.decode(d), d) for d in obj])
            else:
                self.handle_query(obj)

        logger.info("mesh serve worker ready (%d processes)",
                    self.coordinator.n_processes)
        self.coordinator.worker_loop(handler)

    def _model_sharding(self) -> list:
        """Each algorithm's factor-table layout for `/stats.json`: a
        sharded item table's shard count, rows, one shard's bytes and
        whether it is resident; else 'replicated'."""
        from predictionio_tpu_torch.parallel.sharded_table import is_sharded
        out = []
        for m in list(self.models):
            als = getattr(m, "als", None) or m
            t = getattr(als, "item_factors", None)
            if is_sharded(t):
                out.append({"layout": "model", "shards": t.n_shards,
                            "rows": t.n_rows,
                            "perShardBytes": t.per_shard_nbytes,
                            "resident": t._dev is not None})
            else:
                out.append({"layout": "replicated"})
        return out

    def status(self) -> dict:
        with self._lock:
            n, secs = self.request_count, self.serving_seconds
            inst = self.engine_instance
            algorithms = self.algorithms
        return {"status": "alive",
                "engineInstanceId": inst.id if inst else None,
                "engineFactory": inst.engine_factory if inst else None,
                "algorithms": [type(a).__name__ for a in algorithms],
                "requests": n,
                "avgServingSec": secs / n if n else 0.0}

    def stats(self) -> dict:
        """`/stats.json`: the status, the micro-batcher's counters (at the
        top level, as the reference's), the serving-time percentiles and
        histograms, the last warm-up (`aotWarm`) and
        `swapToFirstQueryMs`, the swap and fold-in counters, the canary
        (`canary`, `lastGoodVersion`), the result cache (`resultCache`,
        when on), the readback plane's counters, the process's timed-out
        event point reads (`pio_event_point_read_timeout_total`, the live
        business rules' reads), the executable registry (`aot`), the
        device time (`deviceTime`) and the build directory
        (`buildCache`). A poll also runs the canary's watchdog, so an
        idle server still lands its verdict."""
        from predictionio_tpu_torch.compile.aot import get_aot
        from predictionio_tpu_torch.compile.cache import cache_status
        if self.canary.enabled:
            self._apply_canary_decision()
        out = self.status()
        if self.tenant is not None:
            out["tenant"] = self.tenant
        out["microBatch"] = self.config.micro_batch
        with self._lock:
            n = self.request_count
            out["lastServingSec"] = self.last_serving_sec
            out["avgPredictSec"] = self.predict_seconds / n if n else 0.0
            pct = self._ring_percentiles()
            if pct is not None:
                out.update(p50ServingSec=float(pct[0]),
                           p95ServingSec=float(pct[1]),
                           p99ServingSec=float(pct[2]))
            out["aotWarm"] = self.last_aot_warm
            out["swapToFirstQueryMs"] = self.last_swap_to_first_query_ms
            out.update(modelSwaps=self.swap_count,
                       foldIns=self.fold_in_count,
                       foldInEvents=self.fold_in_events,
                       modelVersion=self.model_version,
                       publishDegraded=self.publish_degraded,
                       publishFailures=self.publish_failures,
                       lastGoodVersion=self.last_good_version)
        out["modelStalenessSec"] = self.model_staleness_s()
        out["canary"] = self.canary.stats()
        if self.result_cache is not None:
            out["resultCache"] = self.result_cache.stats()
        out["queryLatency"] = self._h_query.snapshot()
        if self.batcher is not None:
            out["batchWait"] = self.batcher.wait_hist.snapshot()
            out.update(self.batcher.stats())
        out["readback"] = readback.stats_snapshot()
        out.update(EventStore.point_read_stats())
        out["aot"] = get_aot().snapshot()
        out["buildCache"] = cache_status()
        out["deviceTime"] = costmon.device_snapshot()
        out["modelSharding"] = self._model_sharding()
        if self.coordinator is not None:
            from predictionio_tpu_torch.parallel.collective_stats import \
                collective_stats
            out["meshCoordinator"] = self.coordinator.health()
            out["meshCollectives"] = collective_stats()
        return out

    def answer(self, query_dict, deadline_s: Optional[float] = None) -> dict:
        """A `/queries.json` body's answer: `handle_query` when there is
        no micro-batcher; else decoded here, once (a malformed body raises
        on its own thread), and the query object goes through the
        micro-batcher."""
        if self.batcher is None:
            return self.handle_query(query_dict)
        return self.batcher.submit((self.decode(query_dict), query_dict),
                                   deadline_s=deadline_s)

    # -- the feedback loop and the output plugins (:526-596) ---------------
    def _post_process(self, query_dict: dict, pred_dict: dict) -> dict:
        """An answer's last steps on either query path: with feedback on,
        the prId goes into the prediction and the `predict` event is
        posted; then the output plugins run and their result is the
        response."""
        if self.config.feedback:
            pr_id = query_dict.get("prId") or self.engine_instance.id
            pred_dict = dict(pred_dict, prId=pr_id)
            self._send_feedback(query_dict, pred_dict, pr_id)
        return self.plugin_context.apply_output(self.engine_instance,
                                                query_dict, pred_dict)

    def _send_feedback(self, query: dict, prediction: dict,
                       pr_id: str) -> None:
        """POST the answer as a `predict` event on a daemon thread of its
        own; a failure is logged."""
        event = {
            "event": "predict", "entityType": "pio_pr", "entityId": pr_id,
            "properties": {"query": query, "prediction": prediction},
            "eventTime": format_event_time(utcnow()),
        }
        url = (f"http://{self.config.event_server_ip}:"
               f"{self.config.event_server_port}/events.json"
               f"?accessKey={self.config.accesskey}")
        # the answering trace's context (the query's; on the batched path
        # its window's, which links the query), read now: the POST runs
        # on a thread of its own, and the event server adopts the id
        headers = {"Content-Type": "application/json",
                   **trace_context_headers()}

        def _post():
            try:
                req = urllib.request.Request(
                    url, data=json.dumps(event).encode(),
                    headers=headers, method="POST")
                urllib.request.urlopen(req, timeout=5).read()
            except Exception as e:
                logger.error("feedback event POST failed: %s", e)

        threading.Thread(target=_post, daemon=True).start()

    def _cache_usable(self) -> bool:
        """The cache answers and stores only while a response is a
        function of the query and the deployed models: not while a
        canary splits the traffic between two model sets, nor under the
        feedback loop (each answer must post its event) or an output
        plugin (each answer must pass it)."""
        if self.result_cache is None or self.canary.active:
            return False
        if self.config.feedback:
            return False
        p = self.plugin_context.plugins
        return not any(p.get(k) for k in p)

    @staticmethod
    def _result_item_ids(out: dict) -> tuple:
        """Every item id a response ranks (the strict mode's join)."""
        try:
            return tuple(str(s["item"]) for s in out.get("itemScores", ()))
        except (TypeError, KeyError, AttributeError):
            return ()

    def _cache_hit(self, body: bytes, t0: float) -> bytes:
        """Count a hit as a served request, with its latency."""
        dt = time.perf_counter() - t0
        with self._lock:
            self.request_count += 1
            self.serving_seconds += dt
        return body

    def queries(self, raw: bytes, headers=None
                ) -> Tuple[bytes, Optional[dict]]:
        """A `POST /queries.json`: (the response bytes, extra headers).
        The cache is asked by the request's bytes before the parse and by
        the canonical query after it; a miss reads the cache's generation,
        is answered by `answer`, serialized once, and those bytes are
        stored (refused if an invalidation landed meanwhile) and sent.
        A candidate's answer goes out with `X-PIO-Canary` and is not
        stored. Raises what `answer` raises, and ValueError for a
        malformed body or deadline header."""
        t0 = time.perf_counter()
        cache = self.result_cache
        key = generation = None
        cacheable = self._cache_usable()
        if cacheable:
            body = cache.get_raw(raw)
            if body is not None:
                return self._cache_hit(body, t0), None
        query_dict = json.loads(raw or b"null")
        if not isinstance(query_dict, dict):
            raise ValueError("query must be a JSON object")
        if cacheable:
            key = RC.query_key(query_dict)
            body = cache.get(key)
            if body is not None:
                return self._cache_hit(body, t0), None
            generation = cache.generation
        deadline_s = _request_deadline_s(headers or {})
        # a miss runs under the query's trace (a hit mints none); with
        # the micro-batcher the device work runs under the window's
        # batch_predict trace, which this one links
        with TRACER.trace("query", **ingress_trace_kwargs(headers or {})
                          ) as qt:
            out = self.answer(query_dict, deadline_s)
            total_s = time.perf_counter() - t0
            extra = None
            if isinstance(out, dict) and CANARY_TAG in out:
                out = dict(out)
                extra = {"X-PIO-Canary": str(out.pop(CANARY_TAG))}
                cacheable = False
            ts = time.perf_counter()
            body = json.dumps(out).encode("utf-8")
            serialize_s = time.perf_counter() - ts
            if cacheable and key is not None and isinstance(out, dict):
                cache.put(key, body, RC.query_entities(query_dict),
                          result_items=self._result_item_ids(out),
                          generation=generation, raw=raw)
            if total_s >= slow_threshold_s():
                self._capture_slow(qt, query_dict, total_s, serialize_s)
        return body, extra

    def _capture_slow(self, qt, query_dict: dict, total_s: float,
                      serialize_s: float) -> None:
        """Record a slow query's stage waterfall (`obs/slowlog.py`);
        never raises into the response path."""
        try:
            capture_slow_query(qt, total_s, query=query_dict,
                               model_version=self.model_version,
                               serialize_s=serialize_s,
                               batch_trace_id=next(iter(qt.links), None),
                               tenant=self.tenant)
        except Exception:
            logger.debug("slow-query capture failed", exc_info=True)

    # -- the HTTP routes (:1433-1441), served by `utils/http` ---------------
    def _queries_route(self, req: Request) -> Response:
        try:
            out, extra = self.queries(req.body, req.headers)
        except TypeError as e:   # a query field of the wrong type
            return Response(400, {"message": str(e)})
        return Response(200, out, extra)

    def _reload_route(self, req: Request) -> Response:
        """A `/reload` that carries a trace id (a scheduler's publish
        hop) runs under it, so the hot_swap record joins the fold
        tick's trace."""
        kw = ingress_trace_kwargs(req.headers)
        if kw:
            with TRACER.trace("reload", **kw):
                return self._reload_inner()
        return self._reload_inner()

    def _reload_inner(self) -> Response:
        if not self._single_process():
            # a reload on the primary alone would rank against other
            # shards than the workers'
            return Response(400, {
                "message": "reload is not supported under a "
                           "multi-process mesh; redeploy all processes"})
        try:
            self.reload()
        except Exception as e:   # keep serving the old models
            logger.exception("reload failed")
            return Response(500, {"message": str(e)})
        return Response(200, {"message": "Reloaded"})

    def _stop_route(self, req: Request) -> Response:
        threading.Thread(target=self.stop, daemon=True).start()
        return Response(200, {"message": "Shutting down."})

    def _metrics_route(self, req: Request) -> Response:
        """Prometheus text exposition of this server's registry and the
        process-wide one through its parent; `?exemplars=1` asks for the
        OpenMetrics form."""
        from predictionio_tpu_torch.utils.prometheus import (
            CONTENT_TYPE, OPENMETRICS_CONTENT_TYPE, wants_exemplars)
        om = wants_exemplars(req)
        return Response(200, self.metrics.render(exemplars=om),
                        content_type=(OPENMETRICS_CONTENT_TYPE if om
                                      else CONTENT_TYPE))

    def _health_route(self, req: Request) -> Response:
        """`GET /health.json`: the SLO verdicts with their burn rates. A
        latency SLO that turns `breached` captures an incident, whose
        bundle carries the slow-query waterfalls and the profiler's
        stacks."""
        out = health_response(self.slo, extra={
            "modelVersion": self.model_version,
            "publishDegraded": self.publish_degraded})
        try:
            self._note_slo_breaches(out)
        except Exception:
            logger.debug("slo breach capture failed", exc_info=True)
        return Response(200, out)

    def _note_slo_breaches(self, health: dict) -> None:
        """One incident capture per ok -> breached transition of a
        latency SLO (the manager's per-kind cooldown bounds a flapping
        one)."""
        for s in health.get("slo", ()):
            name, status = s.get("name"), s.get("status")
            if name is None:
                continue
            prev = self._slo_status.get(name)
            self._slo_status[name] = status
            if status == "breached" and prev != "breached" \
                    and s.get("kind") == "latency":
                # a tenant slot's record and bundle name the tenant
                with self._tenant_cm():
                    FLIGHT.record("slo_breach", slo=name,
                                  burnFast=s.get("burnFast"),
                                  burnSlow=s.get("burnSlow"))
                    get_incidents().capture(
                        "slo_breach",
                        f"latency SLO {name} breached (burn fast/slow = "
                        f"{s.get('burnFast')}/{s.get('burnSlow')})",
                        context={"slo": s}, tenant=self.tenant)

    def _profile_route(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs import profiler
        status, body = profiler.profile_response_from_request(
            req, device=self._device())
        return Response(status, body)

    def _incident_route(self, req: Request) -> Response:
        from predictionio_tpu_torch.obs.incidents import incident_response
        status, body = incident_response(req.path_args[0])
        return Response(status, body)

    def _router(self) -> Router:
        from predictionio_tpu_torch.obs.incidents import incidents_response
        r = Router()
        r.add("GET", "/", lambda req: Response(200, self.status()))
        r.add("POST", "/queries.json", self._queries_route)
        r.add("GET", "/stats.json", lambda req: Response(200, self.stats()))
        r.add("GET", "/metrics", self._metrics_route)
        r.add("GET", "/plugins.json",
              lambda req: Response(200, self.plugin_context.to_dict()))
        for method in ("GET", "POST"):
            r.add(method, "/reload", self._reload_route)
            r.add(method, "/stop", self._stop_route)
            r.add(method, "/profile.json", self._profile_route)
        r.add("GET", "/traces.json",
              lambda req: Response(200, traces_response(req.params)))
        r.add("GET", "/flight.json",
              lambda req: Response(200, flight_response(req.params)))
        r.add("GET", "/health.json", self._health_route)
        r.add("GET", "/slow.json",
              lambda req: Response(200, slow_response(req.params)))
        r.add("GET", "/incidents.json",
              lambda req: Response(200, incidents_response(req.params)))
        r.add("GET", "/incidents/<id>.json", self._incident_route)
        r.add("GET", "/fleet/status.json", lambda req: Response(
            200, fleet.fleet_status_response(req.params)))
        r.add("GET", "/fleet/health.json", lambda req: Response(
            200, fleet.fleet_health_response(req.params)))
        r.add("GET", "/fleet/metrics", self._fleet_metrics_route)
        r.add("GET", "/fleet/traces.json", lambda req: Response(
            200, fleet.fleet_traces_response(req.params)))
        return r

    @staticmethod
    def _fleet_metrics_route(req: Request) -> Response:
        from predictionio_tpu_torch.utils.prometheus import CONTENT_TYPE
        return Response(200, fleet.fleet_metrics_response(req.params),
                        content_type=CONTENT_TYPE)

    def bind(self, bind_retries: int = 3,
             retry_delay_s: float = 1.0) -> "EngineServer":
        """Bind the listening socket (retrying, as the reference's
        MasterActor, :363-373) and record the bound port in the config
        (port 0 = any free port)."""
        self._httpd = HttpServer(self._router(), self.config.ip,
                                 self.config.port, name="engine-server"
                                 ).bind(bind_retries, retry_delay_s)
        self._httpd.on_bound = self._bound
        self.config.port = self._httpd.port
        logger.info("Engine server started on %s:%d", self.config.ip,
                    self.config.port)
        return self

    def _bound(self, httpd: HttpServer) -> None:
        """Bound and about to serve: register the fleet member (the id
        swapped under the serving lock, the file written outside it)."""
        fid = fleet.register_member("engine_server", port=httpd.port,
                                    host=self.config.ip)
        with self._lock:
            self._fleet_id = fid

    def start(self, background: bool = True) -> "EngineServer":
        """Serve, binding first unless `bind` has; `background=False`
        serves on the calling thread until `stop()`. Starts the sampling
        profiler (`PIO_PROFILER=off` keeps it off)."""
        from predictionio_tpu_torch.obs import profiler
        profiler.ensure_started()
        if self._httpd is None:
            self.bind()
        self._httpd.start(background)
        return self

    def stop(self) -> None:
        """Deregister from the fleet, stop listening, then stop the
        micro-batcher (windows already dispatched complete; queued
        queries fail with 503), then release a mesh's workers. Stops run
        one at a time, so a second `stop` returns only once the first has
        finished."""
        with self._stop_lock:
            with self._lock:
                fleet_id, self._fleet_id = self._fleet_id, None
            fleet.deregister_member(fleet_id)
            httpd, self._httpd = self._httpd, None
            if httpd is not None:
                httpd.stop()
            if self.batcher is not None:
                self.batcher.stop()
            if self.coordinator is not None:
                self.coordinator.shutdown()
