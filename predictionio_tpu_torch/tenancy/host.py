"""ServingHost: one process on one card serving many engines.

The port's counterpart of `predictionio_tpu/tenancy/host.py`
(`TenantSpec`, `TenantSlot`, `HostConfig`, `ServingHost`). Each tenant is
a full `EngineServer` slot (its micro-batcher, canary, rollback anchors,
attached scheduler and namespace of the host's result cache), loaded
from its own engine instance and addressed as `/engines/<tenant>/...`.
The slots share the card, whose memory `HBMBudgetManager` arbitrates,
the bucket ladder of the compile plane, and one `FoldTickGate` for their
schedulers.

Unlike the reference, tenants of one shape do not share executables: a
CUDA graph bakes in the addresses of the tables it read, so each
tenant's graphs are its own (`compile/aot.py` keys them on their owner
models) and hold its tables. An eviction therefore drops, once the
slot's windows have drained, the tenant's graphs as well as its upload
cache entries and residency slots (the models' device tables are views
of those); only then are the bytes released. No serve path captures a
next row bucket ahead of growth (graphs are keyed on models whose
buckets never change). The next query uploads from the host
mirrors again, runs eagerly and captures in the background. A slot
whose windows do not drain within `evict_quiesce_timeout_s` is not
evicted (the drop is skipped and a warning says so).

Isolation: a tenant's query never answers from another's cached result
(tenant-prefixed keys), a neighbour's eviction never touches a tenant's
models, caches, canary or pins, and an evicted tenant's next answers
are the same bytes (the mirrors are the truth).

The control plane: `POST /tenants/<key>/admit` and `/remove` are fenced
by a placement generation (an older one answers 409, and a query whose
`X-PIO-Placement-Gen` is older than the tenant's answers 409); the
roster (each tenant's engine coordinates, priority, pin, generation and
scheduler config) is published on the host's fleet record at every
change, so a killed host's record tells the placement controller what
to re-place. `PIO_AUTH=on` arms the access-key gate (`tenancy/auth.py`).
Routes: `GET /`, `/stats.json` (`tenants`, `budget`, `resultCache`,
`aot`), `/tenants.json`, `/tenants/signals.json`, `/placement.json`,
`/metrics` (the host's families and each slot's under its `tenant`
label), `/health.json` (worst of the slots'), `POST /tenants/<key>/
{evict,admit,remove,pin,unpin}`, and each slot's `/engines/<key>/
{queries.json,stats.json,metrics,health.json,plugins.json,slow.json,
flight.json,traces.json,reload}`.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from predictionio_tpu_torch.obs import (FLIGHT, MetricsRegistry, costmon,
                                        fleet, get_registry,
                                        register_tenant, tenant_scope)
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.tenancy import props as tenant_props
from predictionio_tpu_torch.tenancy.auth import AccessKeyGate, auth_enabled
from predictionio_tpu_torch.tenancy.budget import (HBMBudgetManager,
                                                   TableBudgetExceeded,
                                                   _iter_tables, is_sharded)
from predictionio_tpu_torch.utils import device_cache
from predictionio_tpu_torch.utils.http import (HttpServer, Request, Response,
                                               Router, _response_of)

logger = logging.getLogger(__name__)

#: a tenant key is a URL segment and a result-cache namespace
_FORBIDDEN = set("/\x1f\n\r")


def _check_key(key: str) -> str:
    key = str(key)
    if not key or _FORBIDDEN.intersection(key):
        raise ValueError(f"invalid tenant key {key!r}")
    return key


@dataclass
class TenantSpec:
    """One tenant: the engine instance it serves and its packing policy.
    A higher `priority` is evicted later; `pinned` is never evicted for
    room (an operator's evict still works)."""
    key: str
    engine_id: Optional[str] = None
    engine_version: str = "0"
    engine_variant: str = "engine.json"
    engine_instance_id: Optional[str] = None
    priority: int = 0
    pinned: bool = False
    #: the slot's whole ServerConfig; None derives one from the
    #: coordinates above at the serving defaults
    server_config: Optional[ServerConfig] = None


class TenantSlot:
    """One admitted tenant: its engine server, its router and the
    in-flight gate the evictor quiesces."""

    def __init__(self, spec: TenantSpec, server: EngineServer):
        self.key = spec.key
        self.spec = spec
        self.server = server
        self.router = server._router()
        self.scheduler = None
        self.scheduler_config = None
        self.requests = 0
        self.errors = 0
        self.admitted_at = time.time()
        #: True while the tables may not be resident (a fresh admission
        #: or an eviction): the next query makes room first
        self.cold = True
        self._cond = threading.Condition()
        self._inflight = 0
        self._evicting = False

    @contextlib.contextmanager
    def serving(self):
        """Count one request in flight; waits out an eviction under way."""
        with self._cond:
            while self._evicting:
                self._cond.wait(timeout=1.0)
            self._inflight += 1
        try:
            yield
        finally:
            with self._cond:
                self._inflight -= 1
                if self._inflight <= 0:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def quiesced(self, timeout_s: float):
        """Hold new requests off and wait for the ones in flight; yields
        True once drained, False on timeout (nothing may be dropped)."""
        with self._cond:
            self._evicting = True
            deadline = time.monotonic() + timeout_s
            while self._inflight > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(timeout=left)
            drained = self._inflight == 0
        try:
            yield drained
        finally:
            with self._cond:
                self._evicting = False
                self._cond.notify_all()

    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    def status(self) -> dict:
        srv = self.server
        return {
            "tenant": self.key,
            "engineId": self.spec.engine_id,
            "engineVersion": self.spec.engine_version,
            "engineVariant": self.spec.engine_variant,
            "modelVersion": srv.model_version,
            "lastGoodVersion": srv.last_good_version,
            "requests": self.requests,
            "errors": self.errors,
            "inflight": self.inflight(),
            "cold": self.cold,
            "scheduler": self.scheduler is not None,
            "canary": srv.canary.stats(),
            "modelSharding": srv._model_sharding(),
            "admittedAt": self.admitted_at,
        }


@dataclass
class HostConfig:
    ip: str = "0.0.0.0"
    port: int = 8100
    #: the host's HBM budget for tenant tables; None reads
    #: PIO_TABLE_BUDGET_BYTES (None there too: accounting only)
    budget_bytes: Optional[int] = None
    #: one result cache for every tenant (tenant-namespaced keys)
    result_cache: bool = True
    result_cache_max_entries: int = 8192
    result_cache_max_bytes: int = 64 << 20
    #: how long an eviction waits for a slot's windows before it skips
    #: the drop (never forced)
    evict_quiesce_timeout_s: float = 10.0


class ServingHost:
    def __init__(self, config: Optional[HostConfig] = None):
        self.config = config or HostConfig()
        self._lock = threading.RLock()
        self.slots: Dict[str, TenantSlot] = {}
        self.start_time = time.time()
        self.metrics = MetricsRegistry(parent=get_registry())
        self.budget = HBMBudgetManager(self.config.budget_bytes,
                                       registry=self.metrics)
        self._c_requests = self.metrics.counter(
            "pio_tenant_requests_total",
            "Queries routed to each serving tenant",
            labelnames=("tenant",))
        self.metrics.gauge_func(
            "pio_host_tenants",
            "Tenant slots admitted on this serving host",
            lambda: len(self.slots))
        from predictionio_tpu_torch.serving import result_cache as RC
        self.result_cache = None
        if self.config.result_cache and RC.cache_enabled():
            self.result_cache = RC.ResultCache(
                max_entries=self.config.result_cache_max_entries,
                max_bytes=self.config.result_cache_max_bytes,
                metrics=self.metrics)
        self._httpd: Optional[HttpServer] = None
        self._fleet_id: Optional[str] = None
        # tenant -> [t, requests, ewma] of the traffic EWMA
        self._traffic: Dict[str, list] = {}
        # tenant -> the newest placement generation an admit or remove
        # named; kept after a removal, so a late re-admit is refused
        self._placement_gen: Dict[str, int] = {}
        self._auth = AccessKeyGate() if auth_enabled() else None
        # the schedulers' shared gate, made with the first one attached
        self.tick_gate = None
        self.router = self._build_router()

    # -- tenant lifecycle ---------------------------------------------------
    def _slot_config(self, spec: TenantSpec) -> ServerConfig:
        if spec.server_config is not None:
            return spec.server_config
        return ServerConfig(
            engine_instance_id=spec.engine_instance_id,
            engine_id=spec.engine_id,
            engine_version=spec.engine_version,
            engine_variant=spec.engine_variant)

    def _overlay_props(self, spec: TenantSpec) -> None:
        """The tenant's durable props over the static spec, so a pin
        taken before a restart holds after it."""
        stored = tenant_props.load_props(spec.key)
        if not stored:
            return
        if "priority" in stored:
            spec.priority = int(stored["priority"])
        if "pinned" in stored:
            spec.pinned = bool(stored["pinned"])

    def _admit_slot(self, spec: TenantSpec, server: EngineServer
                    ) -> TenantSlot:
        slot = TenantSlot(spec, server)
        self.budget.admit(
            spec.key, server.models, priority=spec.priority,
            pinned=spec.pinned,
            sizer=lambda s=slot: self._sharded_devs(s),
            evictor=lambda s=slot: self._evict_slot(s))
        with self._lock:
            self.slots[spec.key] = slot
        return slot

    def add_tenant(self, spec: TenantSpec, engine=None,
                   engine_params=None) -> TenantSlot:
        """Load and admit one tenant. The load runs outside the host's
        lock (the other tenants keep serving); a tenant whose padded
        tables can never fit raises `TableBudgetExceeded` and leaves no
        slot behind."""
        key = _check_key(spec.key)
        register_tenant(key)
        self._overlay_props(spec)
        with self._lock:
            if key in self.slots:
                raise ValueError(f"tenant {key!r} already admitted")
        server = EngineServer(self._slot_config(spec), engine=engine,
                              engine_params=engine_params, tenant=key,
                              shared_result_cache=self.result_cache)
        try:
            server.load()
            slot = self._admit_slot(spec, server)
        except Exception:
            server.stop()
            device_cache.evict_tenant(key)
            raise
        FLIGHT.record("tenant_admitted", tenant=key,
                      model_version=server.model_version,
                      expectedPaddedBytes=self.budget.snapshot()
                      ["tenants"][key]["expectedPaddedBytes"])
        logger.info("tenant %s admitted (instance %s)", key,
                    server.model_version)
        self._publish_roster()
        return slot

    def admit_server(self, spec: TenantSpec,
                     server: EngineServer) -> TenantSlot:
        """Admit an already loaded `EngineServer` (made with
        `tenant=spec.key`, else refused: its uploads would be untagged,
        unaccounted and never evicted)."""
        key = _check_key(spec.key)
        if server.tenant != key:
            raise ValueError(
                f"server.tenant {server.tenant!r} != spec.key {key!r}: "
                f"construct the EngineServer with tenant=<key>")
        register_tenant(key)
        self._overlay_props(spec)
        with self._lock:
            if key in self.slots:
                raise ValueError(f"tenant {key!r} already admitted")
        slot = self._admit_slot(spec, server)
        FLIGHT.record("tenant_admitted", tenant=key,
                      model_version=server.model_version,
                      expectedPaddedBytes=self.budget.snapshot()
                      ["tenants"][key]["expectedPaddedBytes"])
        self._publish_roster()
        return slot

    def remove_tenant(self, key: str) -> bool:
        with self._lock:
            slot = self.slots.pop(key, None)
        if slot is None:
            return False
        if slot.scheduler is not None:
            try:
                slot.scheduler.stop()
            except Exception:
                logger.exception("tenant %s scheduler stop failed", key)
        self.budget.evict(key, reason="remove")
        self.budget.forget(key)
        slot.server.stop()
        FLIGHT.record("tenant_removed", tenant=key)
        self._publish_roster()
        return True

    def attach_scheduler(self, key: str, config, **kw):
        """Attach a fold scheduler to one slot: its ticks run under the
        tenant's scope and hot-swap that slot only, and every scheduler
        of the host takes turns through the host's `FoldTickGate`."""
        from predictionio_tpu_torch.online.scheduler import (
            FoldTickGate, attach_scheduler)
        with self._lock:
            if self.tick_gate is None:
                self.tick_gate = FoldTickGate(registry=self.metrics)
            gate = self.tick_gate
        kw.setdefault("tick_gate", gate)
        slot = self._slot(key)
        sched = attach_scheduler(slot.server, config, tenant=key, **kw)
        slot.scheduler = sched
        slot.scheduler_config = config
        self._publish_roster()
        return sched

    # -- eviction -----------------------------------------------------------
    @staticmethod
    def _slot_models(slot: TenantSlot) -> List:
        """The slot's served models and its canary candidate's."""
        models = list(slot.server.models)
        models.extend(slot.server.canary._candidate_models or ())
        return models

    def _sharded_tables(self, slot: TenantSlot) -> List:
        return [t for t in _iter_tables(self._slot_models(slot))
                if is_sharded(t)]

    def _sharded_devs(self, slot: TenantSlot) -> List:
        """The shard tensors the slot's sharded tables hold resident:
        tensors, not bytes, so the budget counts each storage once
        beside the residency payloads that hold the same ones."""
        return [d for t in self._sharded_tables(slot)
                for d in t.device_tensors()]

    def _evict_slot(self, slot: TenantSlot) -> None:
        """The budget's evictor for one slot: quiesce its windows, then
        drop its graphs (each holds the tables it captured; their owners
        are its models and the tenant's cached tables) and its upload
        cache entries and residency slots, which hold every device table
        its models read. On a quiesce timeout nothing is dropped: a
        window in flight keeps what it reads, so a forced drop would free
        nothing and misreport the bytes."""
        from predictionio_tpu_torch.compile.aot import get_aot
        with slot.quiesced(self.config.evict_quiesce_timeout_s) as drained:
            if not drained:
                logger.warning(
                    "tenant %s eviction skipped: %d windows still in "
                    "flight after %.1fs", slot.key, slot.inflight(),
                    self.config.evict_quiesce_timeout_s)
                return
            # a sampled replay waiting for its stamps holds its graph
            costmon.flush()
            owners = [o for m in self._slot_models(slot)
                      for o in (m, getattr(m, "als", None))]
            owners.extend(
                device_cache.tenant_device_arrays().get(slot.key, ()))
            sharded = self._sharded_tables(slot)
            owners.extend(sharded)
            get_aot().drop_owners(owners)
            device_cache.evict_tenant(slot.key)
            for t in sharded:
                t.drop_device()
            slot.cold = True

    def evict_tenant(self, key: str, reason: str = "operator") -> dict:
        self._slot(key)   # KeyError on an unknown tenant
        return self.budget.evict(key, reason=reason)

    # -- routing ------------------------------------------------------------
    def _slot(self, key: str) -> TenantSlot:
        slot = self.slots.get(key)
        if slot is None:
            raise KeyError(key)
        return slot

    @staticmethod
    def _unknown(key: str) -> Response:
        return Response(404, {"message": f"unknown tenant {key!r}"})

    def _tenant_query(self, req: Request) -> Response:
        key = req.path_args[0]
        slot = self.slots.get(key)
        if slot is None:
            return self._unknown(key)
        if self._auth is not None:
            denied = self._auth.check(
                req, slot.server.config.accesskey or None)
            if denied is not None:
                return denied
        # the generation fence: a route older than the tenant's newest
        # placement answers 409 (refresh, do not serve)
        gen_hdr = req.headers.get("x-pio-placement-gen") \
            if req.headers else None
        if gen_hdr is not None:
            try:
                if int(gen_hdr) < self._placement_gen.get(key, 0):
                    return Response(409, {
                        "message": "stale placement route",
                        "tenant": key,
                        "generation": self._placement_gen.get(key, 0)})
            except (TypeError, ValueError):
                pass
        with tenant_scope(key):
            self._c_requests.labels(tenant=key).inc()
            slot.requests += 1
            self.budget.touch(key)
            if slot.cold:
                # make the budget hold before the tables come resident
                self.budget.ensure_room(key)
                slot.cold = False
            req.path = "/queries.json"
            with slot.serving():
                resp = _response_of(slot.router, req)
        if resp.status >= 500:
            slot.errors += 1
        return resp

    def _delegate(self, req: Request) -> Response:
        """`/engines/<key>/<endpoint>` on the slot server's own routes."""
        key = req.path_args[0]
        slot = self.slots.get(key)
        if slot is None:
            return self._unknown(key)
        req.path = req.path[len(f"/engines/{key}"):]
        with tenant_scope(key), slot.serving():
            return _response_of(slot.router, req)

    # -- host surfaces ------------------------------------------------------
    def _tenants_block(self) -> dict:
        budget = self.budget.snapshot()
        with self._lock:
            slots = list(self.slots.values())
        out = {}
        for slot in slots:
            entry = slot.status()
            entry.update(budget["tenants"].get(slot.key, {}))
            out[slot.key] = entry
        return out

    def stats(self) -> dict:
        from predictionio_tpu_torch.compile.aot import get_aot
        budget = self.budget.snapshot()
        with self._lock:
            total = sum(s.requests for s in self.slots.values())
        out = {
            "role": "serving_host",
            "startTime": self.start_time,
            "requestCount": total,
            "tenants": self._tenants_block(),
            "budget": {k: budget[k]
                       for k in ("budgetBytes", "residentBytes")},
        }
        if self.result_cache is not None:
            out["resultCache"] = self.result_cache.stats()
        out["aot"] = get_aot().snapshot()
        return out

    def _tenant_evict(self, req: Request) -> Response:
        key = req.path_args[0]
        try:
            return Response(200, self.evict_tenant(key))
        except KeyError:
            return self._unknown(key)

    def _tenant_pin(self, req: Request) -> Response:
        key = req.path_args[0]
        pinned = not req.path.endswith("/unpin")
        if not self.budget.pin(key, pinned):
            return self._unknown(key)
        # durable, so a restarted host admits with it
        persisted = tenant_props.save_props(key, pinned=pinned)
        slot = self.slots.get(key)
        if slot is not None:
            slot.spec.pinned = pinned
        self._publish_roster()
        return Response(200, {"tenant": key, "pinned": pinned,
                              "persisted": persisted is not None})

    # -- the control plane --------------------------------------------------
    _SCHED_FIELDS = ("app_name", "channel_name", "event_names",
                     "max_deltas", "max_staleness_s", "poll_interval_s",
                     "tail_batch_limit", "filtered_reads")

    def _sched_dict(self, cfg) -> dict:
        out = {}
        for k in self._SCHED_FIELDS:
            v = getattr(cfg, k, None)
            if v is not None:
                out[k] = list(v) if isinstance(v, tuple) else v
        return out

    def _publish_roster(self) -> None:
        """Stamp the tenant roster on this host's fleet record: after a
        SIGKILL the record is the controller's only account of what the
        host served and how to rebuild it."""
        with self._lock:
            fid = self._fleet_id
            slots = list(self.slots.values())
            gens = dict(self._placement_gen)
        if not fid:
            return
        roster = {}
        for slot in slots:
            spec = slot.spec
            entry = {
                "engineId": spec.engine_id,
                "engineVersion": spec.engine_version,
                "engineVariant": spec.engine_variant,
                "engineInstanceId": spec.engine_instance_id,
                "priority": spec.priority,
                "pinned": spec.pinned,
                "generation": gens.get(slot.key, 0),
            }
            if slot.scheduler_config is not None:
                entry["scheduler"] = self._sched_dict(slot.scheduler_config)
            roster[slot.key] = entry
        fleet.update_member(fid, {"tenants": roster})

    def _fence(self, key: str, gen) -> Optional[Response]:
        """409 when `gen` is older than the tenant's newest placement
        generation; else records it."""
        try:
            gen = int(gen or 0)
        except (TypeError, ValueError):
            return Response(400, {"message": "generation must be int"})
        with self._lock:
            cur = self._placement_gen.get(key, 0)
            if gen < cur:
                return Response(409, {"message": "stale placement "
                                      "generation", "tenant": key,
                                      "generation": cur})
            self._placement_gen[key] = gen
        return None

    def _tenant_admit(self, req: Request) -> Response:
        """`POST /tenants/<key>/admit`: the controller's admission. The
        body names the engine coordinates (and priority, pin, scheduler
        config) and the placement `generation`. The tenant loads from
        the registry and is warmed before it is routable; a scheduler
        config attaches and starts a scheduler (its cursor resumes from
        the published lineage); a budget refusal answers 409."""
        key = req.path_args[0]
        try:
            body = req.json() or {}
        except ValueError:
            return Response(400, {"message": "body must be JSON"})
        fence = self._fence(key, body.get("generation"))
        if fence is not None:
            return fence
        with self._lock:
            if key in self.slots:
                return Response(200, {"tenant": key,
                                      "alreadyAdmitted": True})
        spec = TenantSpec(
            key=key, engine_id=body.get("engineId"),
            engine_version=str(body.get("engineVersion") or "0"),
            engine_variant=body.get("engineVariant") or "engine.json",
            engine_instance_id=body.get("engineInstanceId"),
            priority=int(body.get("priority") or 0),
            pinned=bool(body.get("pinned")))
        try:
            self.add_tenant(spec)
        except TableBudgetExceeded as e:
            return Response(409, {"message": f"admission refused: {e}",
                                  "tenant": key})
        except ValueError as e:
            return Response(409, {"message": str(e), "tenant": key})
        except Exception as e:
            logger.exception("tenant %s remote admission failed", key)
            return Response(500, {"message": f"admission failed: {e}",
                                  "tenant": key})
        sched = body.get("scheduler")
        if isinstance(sched, dict) and sched.get("app_name"):
            try:
                from predictionio_tpu_torch.online.registry import \
                    ModelVersionRegistry
                from predictionio_tpu_torch.online.scheduler import \
                    SchedulerConfig
                cfg = SchedulerConfig(**{k: sched[k]
                                         for k in self._SCHED_FIELDS
                                         if k in sched})
                self.attach_scheduler(
                    key, cfg, registry=ModelVersionRegistry()).start()
            except Exception:
                # the tenant serves; a broken fold attachment is an
                # incident, not a failed admission
                logger.exception("tenant %s scheduler attach failed", key)
        slot = self.slots.get(key)
        return Response(200, {
            "tenant": key,
            "generation": self._placement_gen.get(key, 0),
            "modelVersion": slot.server.model_version if slot else None,
            "scheduler": bool(slot and slot.scheduler is not None)})

    def _tenant_remove(self, req: Request) -> Response:
        """`POST /tenants/<key>/remove`, fenced by generation (the last
        step of a planned migration)."""
        key = req.path_args[0]
        try:
            body = req.json() or {}
        except ValueError:
            body = {}
        fence = self._fence(key, body.get("generation"))
        if fence is not None:
            return fence
        if not self.remove_tenant(key):
            return self._unknown(key)
        return Response(200, {"tenant": key, "removed": True,
                              "generation": self._placement_gen.get(key, 0)})

    def placement(self) -> dict:
        """`GET /placement.json`: per tenant the generation, spec and
        budget row the controller plans with."""
        budget = self.budget.snapshot()
        with self._lock:
            slots = list(self.slots.values())
            gens = dict(self._placement_gen)
        tenants = {}
        for slot in slots:
            spec = slot.spec
            tenants[slot.key] = {
                "generation": gens.get(slot.key, 0),
                "engineId": spec.engine_id,
                "engineVersion": spec.engine_version,
                "engineVariant": spec.engine_variant,
                "engineInstanceId": spec.engine_instance_id,
                "priority": spec.priority,
                "pinned": spec.pinned,
                "cold": slot.cold,
                "scheduler": slot.scheduler is not None,
                "expectedPaddedBytes": budget["tenants"].get(
                    slot.key, {}).get("expectedPaddedBytes", 0),
            }
        return {"memberId": self._fleet_id,
                "budgetBytes": budget["budgetBytes"],
                "residentBytes": budget["residentBytes"],
                "generations": gens, "tenants": tenants}

    def _metrics_route(self, req: Request) -> Response:
        """The host's families and each slot registry's own, relabeled
        with `tenant` (one `# TYPE` a family)."""
        from predictionio_tpu_torch.obs.fleet import merge_scrapes
        from predictionio_tpu_torch.utils.prometheus import CONTENT_TYPE
        with self._lock:
            slots = list(self.slots.values())
        parts = [(self.metrics.render(), {})]
        for slot in slots:
            parts.append((slot.server.metrics.render(include_parent=False),
                          {"tenant": slot.key}))
        return Response(200, merge_scrapes(parts), content_type=CONTENT_TYPE)

    def health(self) -> dict:
        """The worst of the slots' SLO verdicts. Each slot's breach
        transitions are noted under its tenant, so a breach captures an
        incident naming that tenant only."""
        from predictionio_tpu_torch.obs import health_response
        rank = {"ok": 0, "burning": 1, "no_data": 0, "breached": 2}
        worst, tenants = "ok", {}
        with self._lock:
            slots = list(self.slots.values())
        for slot in slots:
            with tenant_scope(slot.key):
                h = health_response(slot.server.slo, extra={
                    "modelVersion": slot.server.model_version,
                    "tenant": slot.key})
                try:
                    slot.server._note_slo_breaches(h)
                except Exception:
                    logger.debug("tenant %s breach note failed", slot.key,
                                 exc_info=True)
            tenants[slot.key] = h
            if rank.get(h.get("status"), 0) > rank.get(worst, 0):
                worst = h["status"]
        return {"status": worst, "tenants": tenants}

    # -- per-tenant signals -------------------------------------------------
    def _traffic_ewma(self, key: str, requests: int) -> float:
        """A tenant's request-rate EWMA (alpha 0.3 a reading at least
        0.2 s after the last), advanced on each signals read."""
        now = time.monotonic()
        st = self._traffic.get(key)
        if st is None:
            self._traffic[key] = [now, requests, 0.0]
            return 0.0
        last_t, last_n, ewma = st
        dt = now - last_t
        if dt >= 0.2:
            inst = max(0.0, requests - last_n) / dt
            ewma = inst if ewma == 0.0 else 0.7 * ewma + 0.3 * inst
            self._traffic[key] = [now, requests, ewma]
        return ewma

    def tenant_signals(self) -> dict:
        """`GET /tenants/signals.json`: one row a tenant (traffic,
        latency, burn, memory, device-time and occupancy shares, serve
        readback bytes, staleness), plus the whole attribution maps
        (`""` = untenanted work)."""
        budget = self.budget.snapshot()
        dev_share = costmon.tenant_device_time_share()
        occ_share = costmon.tenant_occupancy_shares()
        d2h_bytes = {}
        fam = get_registry().get("pio_tenant_serve_d2h_bytes_total")
        if fam is not None:
            for labels, value in fam.samples():
                if labels:
                    d2h_bytes[labels.get("tenant", "")] = int(value)
        with self._lock:
            slots = list(self.slots.values())
        tenants = {}
        for slot in slots:
            srv = slot.server
            row = {
                "requests": slot.requests,
                "errors": slot.errors,
                "trafficEwmaRps": round(
                    self._traffic_ewma(slot.key, slot.requests), 3),
                "deviceTimeShare": dev_share.get(slot.key, 0.0),
                "occupancyShare": occ_share.get(slot.key, 0.0),
                "serveD2hBytes": d2h_bytes.get(slot.key, 0),
                "modelStalenessS": srv.model_staleness_s(),
                "modelVersion": srv.model_version,
            }
            b = budget["tenants"].get(slot.key, {})
            row["hbmBytes"] = b.get("hbmBytes", 0)
            row["evictions"] = b.get("evictions", 0)
            fam = srv.metrics.get("pio_engine_query_seconds")
            if fam is not None and fam.count:
                p50, p99 = fam.percentile(50), fam.percentile(99)
                row["serveP50Ms"] = (round(p50 * 1000.0, 3)
                                     if p50 is not None else None)
                row["serveP99Ms"] = (round(p99 * 1000.0, 3)
                                     if p99 is not None else None)
            else:
                row["serveP50Ms"] = row["serveP99Ms"] = None
            try:
                h = srv.slo.evaluate()
                row["sloStatus"] = h["status"]
                serve = next((s for s in h["slo"]
                              if s["name"] == "serve_p99"), {})
                row["burnFast"] = serve.get("burnFast")
                row["burnSlow"] = serve.get("burnSlow")
            except Exception:
                row["sloStatus"] = "no_data"
                row["burnFast"] = row["burnSlow"] = None
            tenants[slot.key] = row
        return {"tenants": tenants, "deviceTimeShare": dev_share,
                "occupancyShare": occ_share,
                "budgetBytes": budget["budgetBytes"],
                "residentBytes": budget["residentBytes"]}

    def _status_page(self, req: Request) -> Response:
        return Response(200, {
            "role": "serving_host", "tenants": sorted(self.slots),
            "budget": self.budget.snapshot()["budgetBytes"]})

    def _build_router(self) -> Router:
        r = Router()
        r.add("GET", "/", self._status_page)
        r.add("POST", "/engines/<key>/queries.json", self._tenant_query)
        for ep in ("stats.json", "metrics", "health.json", "plugins.json",
                   "slow.json", "flight.json", "traces.json"):
            r.add("GET", f"/engines/<key>/{ep}", self._delegate)
        r.add("POST", "/engines/<key>/reload", self._delegate)
        r.add("GET", "/engines/<key>/reload", self._delegate)
        r.add("GET", "/stats.json", lambda req: Response(200, self.stats()))
        r.add("GET", "/tenants.json",
              lambda req: Response(200, {"tenants": self._tenants_block()}))
        r.add("GET", "/tenants/signals.json",
              lambda req: Response(200, self.tenant_signals()))
        r.add("GET", "/placement.json",
              lambda req: Response(200, self.placement()))
        r.add("POST", "/tenants/<key>/evict", self._tenant_evict)
        r.add("POST", "/tenants/<key>/admit", self._tenant_admit)
        r.add("POST", "/tenants/<key>/remove", self._tenant_remove)
        r.add("POST", "/tenants/<key>/pin", self._tenant_pin)
        r.add("POST", "/tenants/<key>/unpin", self._tenant_pin)
        r.add("GET", "/metrics", self._metrics_route)
        r.add("GET", "/health.json", lambda req: Response(200, self.health()))
        return r

    # -- lifecycle ----------------------------------------------------------
    def bind(self) -> "ServingHost":
        """Bind the listening socket and record the bound port (port 0 =
        any free port)."""
        self._httpd = HttpServer(self.router, self.config.ip,
                                 self.config.port, name="serving-host").bind()
        self._httpd.on_bound = self._bound
        self.config.port = self._httpd.port
        return self

    def _bound(self, httpd: HttpServer) -> None:
        """Bound and about to serve: register the fleet member and stamp
        the roster on it at once, so a crash after bind leaves a record
        that names every tenant."""
        fid = fleet.register_member("serving_host", port=httpd.port,
                                    host=self.config.ip)
        with self._lock:
            self._fleet_id = fid
        self._publish_roster()
        logger.info("Serving host started on %s:%d (%d tenants)",
                    self.config.ip, httpd.port, len(self.slots))

    def start(self, background: bool = True) -> "ServingHost":
        """Serve, binding first unless `bind` has; `background=False`
        serves on the calling thread until `stop()`."""
        from predictionio_tpu_torch.obs import profiler
        profiler.ensure_started()
        if self._httpd is None:
            self.bind()
        self._httpd.start(background)
        return self

    def stop(self) -> None:
        with self._lock:
            fleet_id, self._fleet_id = self._fleet_id, None
            keys = list(self.slots)
        fleet.deregister_member(fleet_id)
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            httpd.stop()
        for key in keys:
            try:
                self.remove_tenant(key)
            except Exception:
                logger.exception("tenant %s removal failed on stop", key)
