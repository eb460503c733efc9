"""PlacementController: the control plane of a fleet of serving hosts.

The port's counterpart of `predictionio_tpu/tenancy/controller.py`. The
planner (`tenancy/placement.py`) is pure; this module observes and acts:

- **Observe**: the fleet registry's member records, the dead included,
  and for each live serving host its `/placement.json` and
  `/tenants/signals.json`. A dead host's roster comes off its record,
  which the host republished at every admit, remove and pin.
- **Fail over**: a serving host the registry calls dead (its heartbeat
  stale, or its pid gone) with tenants in its roster has every stranded
  tenant re-placed on the survivors through their generation-fenced
  `/tenants/<key>/admit`; the admitting host loads from the registry and
  warms before the tenant is routable. Each decision is a
  `placement_decision` flight record, and the episode one `host_failover`
  incident naming the dead member and the tenants.
- **Migrate**: evict on the source, admit on the target under a new
  generation, flip the route, remove from the source under that
  generation; the source serves until the flip.
- **Route**: `TenantRouter` keeps a tenant -> URL table (replaced whole,
  read without a lock) and retries under the stock `RetryPolicy`,
  turning a stale placement (404, 409, 429, 503) or a refused
  connection into a refreshed route and a retry, so a client riding a
  host's death sees latency, not a 5xx.

`pio_placement_failovers_total`, `pio_placement_refusals_total` and
`pio_placement_migrations_total` count on the process-wide registry, and
the controller's SLOs (`obs/slo.default_controller_specs`) read them.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.obs import FLIGHT, fleet, get_registry
from predictionio_tpu_torch.resilience import RetryPolicy, TransientHTTPError
from predictionio_tpu_torch.tenancy.placement import (HostView, PlacementPlan,
                                                TenantView, plan_failover,
                                                plan_placement,
                                                plan_rebalance)

logger = logging.getLogger(__name__)


def _post_json(url: str, body: dict,
               timeout: float = 60.0) -> Tuple[int, dict]:
    """POST JSON, returning (status, parsed body). HTTP error statuses
    come back as values (the caller decides what is fatal); transport
    failures raise OSError (retryable under the stock policy)."""
    data = json.dumps(body or {}).encode("utf-8")
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, _parse(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, _parse(e.read())


def _parse(raw: bytes) -> dict:
    try:
        out = json.loads(raw or b"{}")
        return out if isinstance(out, dict) else {"body": out}
    except ValueError:
        return {"body": raw.decode("utf-8", "replace")}


def _fetch(url: str, timeout: float = 5.0) -> Optional[dict]:
    from predictionio_tpu_torch.utils.http import fetch_json
    body = fetch_json(url, timeout=timeout)
    if not isinstance(body, dict) or "error" in body:
        return None
    return body


@dataclass
class ControllerConfig:
    #: control loop cadence; failover detection latency is this plus
    #: the registry's liveness window
    interval_s: float = 2.0
    #: budget for one remote admission (model load + AOT warm)
    admit_timeout_s: float = 120.0
    http_timeout_s: float = 5.0
    allow_preemption: bool = True


class PlacementController:
    """One control loop over the fleet's serving hosts."""

    def __init__(self, config: Optional[ControllerConfig] = None,
                 registry: Optional[fleet.FleetRegistry] = None):
        self.config = config or ControllerConfig()
        self.registry = registry or fleet.get_fleet()
        self._lock = threading.Lock()
        # tenant -> (url, member_id, generation): THE routing table.
        # Replaced wholesale under the lock, read without it — a
        # router's lookup is one dict get on an immutable snapshot.
        self._routes: Dict[str, tuple] = {}
        # highest placement generation seen per tenant (live placements
        # + corpse rosters); next_generation() fences every action
        self._gens: Dict[str, int] = {}
        # deaths already handled, keyed (memberId, startedAt): a corpse
        # record persists for an hour, the failover must run once
        self._handled: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._c_failovers = reg.counter(
            "pio_placement_failovers_total",
            "Host-death failovers the placement controller executed")
        self._c_refusals = reg.counter(
            "pio_placement_refusals_total",
            "Placement decisions refused for lack of a feasible host")
        self._c_migrations = reg.counter(
            "pio_placement_migrations_total",
            "Planned tenant migrations completed (evict -> admit -> "
            "route flip -> remove)")
        from predictionio_tpu_torch.obs.slo import SLOEngine, \
            default_controller_specs
        self.slo = SLOEngine(default_controller_specs(),
                             registries=(reg,))

    # -- observation --------------------------------------------------------
    @staticmethod
    def _tenant_view(key: str, roster_entry: dict,
                     signals_row: Optional[dict] = None,
                     placement_row: Optional[dict] = None) -> TenantView:
        sig = signals_row or {}
        plc = placement_row or {}
        sched = roster_entry.get("scheduler")
        return TenantView(
            key=key,
            hbm_bytes=int(plc.get("expectedPaddedBytes")
                          or sig.get("hbmBytes") or 0),
            priority=int(roster_entry.get("priority") or 0),
            pinned=bool(roster_entry.get("pinned")),
            traffic_ewma=float(sig.get("trafficEwmaRps") or 0.0),
            burn_fast=float(sig.get("burnFast") or 0.0),
            slo_status=str(sig.get("sloStatus") or "no_data"),
            engine_id=roster_entry.get("engineId") or "",
            engine_version=str(roster_entry.get("engineVersion") or "0"),
            engine_variant=roster_entry.get("engineVariant")
            or "engine.json",
            engine_instance_id=roster_entry.get("engineInstanceId")
            or "",
            generation=int(roster_entry.get("generation") or 0),
            scheduler=dict(sched) if isinstance(sched, dict) else None)

    def observe(self) -> List[HostView]:
        """One consistent-enough snapshot of every serving host, dead
        or alive. Live hosts are asked for their placement + signals
        surfaces; a host that stops answering mid-observe degrades to
        its member-record roster (the same source a corpse uses)."""
        out: List[HostView] = []
        for m in self.registry.members(include_dead=True):
            if m.get("role") != "serving_host":
                continue
            url = fleet.member_url(m) or ""
            hv = HostView(member_id=m.get("memberId") or "",
                          url=url, alive=bool(m.get("alive")))
            hv.started_at = m.get("startedAt")   # death dedup key
            roster = m.get("tenants") or {}
            placement = signals = None
            if hv.alive and url:
                placement = _fetch(url + "/placement.json",
                                   self.config.http_timeout_s)
                signals = _fetch(url + "/tenants/signals.json",
                                 self.config.http_timeout_s)
            if placement is not None:
                hv.budget_bytes = placement.get("budgetBytes")
                # the live surface is fresher than the record roster
                roster = placement.get("tenants") or roster
            sig_rows = (signals or {}).get("tenants") or {}
            for key, entry in roster.items():
                if not isinstance(entry, dict):
                    continue
                hv.tenants[key] = self._tenant_view(
                    key, entry, sig_rows.get(key),
                    (placement or {}).get("tenants", {}).get(key))
            out.append(hv)
        with self._lock:
            for hv in out:
                for t in hv.tenants.values():
                    if t.generation > self._gens.get(t.key, 0):
                        self._gens[t.key] = t.generation
        return out

    def next_generation(self, tenant: str) -> int:
        with self._lock:
            g = self._gens.get(tenant, 0) + 1
            self._gens[tenant] = g
            return g

    # -- routing table ------------------------------------------------------
    def refresh_routes(self, hosts: Optional[List[HostView]] = None
                       ) -> Dict[str, tuple]:
        """Rebuild tenant -> (url, member, generation) from the LIVE
        placements; when a tenant appears on two hosts mid-migration,
        the newer generation wins (the fence guarantees the older one
        can no longer be acted on)."""
        if hosts is None:
            hosts = self.observe()
        routes: Dict[str, tuple] = {}
        for h in hosts:
            if not h.alive or not h.url:
                continue
            for t in h.tenants.values():
                cur = routes.get(t.key)
                if cur is None or t.generation >= cur[2]:
                    routes[t.key] = (h.url, h.member_id, t.generation)
        with self._lock:
            self._routes = routes
        return routes

    def route_for(self, tenant: str) -> Optional[tuple]:
        return self._routes.get(tenant)

    # -- failover -----------------------------------------------------------
    def _admit_body(self, t: TenantView, gen: int) -> dict:
        body = {
            "generation": gen,
            "engineId": t.engine_id or None,
            "engineVersion": t.engine_version,
            "engineVariant": t.engine_variant,
            "engineInstanceId": t.engine_instance_id or None,
            "priority": t.priority,
            "pinned": t.pinned,
        }
        if t.scheduler:
            body["scheduler"] = t.scheduler
        return body

    def _actuate_admit(self, host: HostView, t: TenantView,
                       gen: int) -> Tuple[bool, dict]:
        try:
            status, body = _post_json(
                f"{host.url}/tenants/{t.key}/admit",
                self._admit_body(t, gen),
                timeout=self.config.admit_timeout_s)
        except OSError as e:
            return False, {"error": str(e)}
        return status == 200, body

    def failover(self, dead: HostView,
                 survivors: List[HostView]) -> PlacementPlan:
        """Re-place every tenant stranded on ``dead`` onto the
        survivors. Tenants already serving on a live host (a previous
        partial failover, or a migration that raced the death) are
        skipped — the roster is where they WERE, the live placements
        are where they ARE."""
        live_keys = {k for h in survivors for k in h.tenants}
        stranded = HostView(member_id=dead.member_id, url=dead.url,
                            alive=False,
                            tenants={k: t for k, t in
                                     dead.tenants.items()
                                     if k not in live_keys})
        plan = plan_failover(survivors + [stranded], stranded)
        if not stranded.tenants:
            return plan
        by_member = {h.member_id: h for h in survivors}
        replaced, failed = [], []
        for d in plan.decisions:
            FLIGHT.record("placement_decision", tenant=d.tenant,
                          action=d.action, host=d.host,
                          fromHost=d.from_host or dead.member_id,
                          reason=d.reason, trigger="failover")
            if d.action == "refuse":
                self._c_refusals.inc()
                failed.append({"tenant": d.tenant, "reason": d.reason})
                continue
            if d.action != "admit":
                continue
            target = by_member.get(d.host)
            t = stranded.tenants.get(d.tenant) \
                or dead.tenants.get(d.tenant)
            if target is None or t is None:
                continue
            gen = self.next_generation(d.tenant)
            ok, body = self._actuate_admit(target, t, gen)
            if ok:
                replaced.append({"tenant": d.tenant,
                                 "host": d.host, "generation": gen,
                                 "modelVersion":
                                     body.get("modelVersion")})
            else:
                self._c_refusals.inc()
                failed.append({"tenant": d.tenant, "host": d.host,
                               "response": body})
        self._c_failovers.inc()
        self.refresh_routes()
        from predictionio_tpu_torch.obs.incidents import get_incidents
        try:
            get_incidents().capture(
                "host_failover",
                reason=(f"serving host {dead.member_id} died; "
                        f"re-placed {len(replaced)}/"
                        f"{len(stranded.tenants)} stranded tenants: "
                        + ", ".join(sorted(stranded.tenants))),
                context={"deadMember": dead.member_id,
                         "deadStartedAt": getattr(dead, "started_at",
                                                  None),
                         "replaced": replaced, "failed": failed,
                         "plan": plan.as_dict()},
                sync=True)
        except Exception:
            logger.exception("failover incident capture failed")
        logger.warning("failover of %s: %d re-placed, %d failed",
                       dead.member_id, len(replaced), len(failed))
        return plan

    def step(self) -> dict:
        """One control iteration: observe, fail over any newly-dead
        host that still strands tenants, refresh routes."""
        hosts = self.observe()
        survivors = [h for h in hosts if h.alive]
        actions = []
        for h in hosts:
            if h.alive or not h.tenants:
                continue
            death_key = (h.member_id, getattr(h, "started_at", None))
            if death_key in self._handled:
                continue
            self._handled.add(death_key)
            plan = self.failover(h, survivors)
            actions.append({"failover": h.member_id,
                            "plan": plan.as_dict()})
        self.refresh_routes(None if actions else hosts)
        return {"hosts": len(hosts), "alive": len(survivors),
                "actions": actions}

    # -- planned migration --------------------------------------------------
    def migrate(self, tenant: str, to_member: str,
                hosts: Optional[List[HostView]] = None) -> dict:
        """Loss-free planned migration. Order matters:

        1. evict on the source — quiesce in-flight windows, drop
           device residency to host mirrors; the slot STAYS admitted
           and re-uploads if queried, so service never gaps;
        2. admit on the target under a fresh generation — load from
           lineage, AOT-warm; the target is ready before any traffic
           moves;
        3. route flip — atomic table swap, new queries go to the
           target;
        4. remove on the source under the same generation — drains
           the last in-flight queries through the slot gate, then
           frees the slot. A stale route hitting the source after
           this 404s (and a fenced query 409s), never serves.
        """
        if hosts is None:
            hosts = self.observe()
        by_member = {h.member_id: h for h in hosts if h.alive}
        target = by_member.get(to_member)
        source = next((h for h in hosts
                       if h.alive and tenant in h.tenants
                       and h.member_id != to_member), None)
        if target is None:
            raise ValueError(f"unknown or dead target {to_member!r}")
        if source is None:
            raise ValueError(
                f"tenant {tenant!r} is not on any live host "
                f"(other than the target)")
        t = source.tenants[tenant]
        gen = self.next_generation(tenant)
        FLIGHT.record("placement_decision", tenant=tenant,
                      action="migrate", host=to_member,
                      fromHost=source.member_id, generation=gen,
                      reason="planned migration", trigger="operator")
        status, body = _post_json(
            f"{source.url}/tenants/{tenant}/evict",
            {}, timeout=self.config.http_timeout_s * 4)
        if status != 200:
            raise RuntimeError(f"source evict failed: {body}")
        ok, body = self._actuate_admit(target, t, gen)
        if not ok:
            raise RuntimeError(f"target admit failed: {body}")
        with self._lock:
            routes = dict(self._routes)
            routes[tenant] = (target.url, target.member_id, gen)
            self._routes = routes
        status, rbody = _post_json(
            f"{source.url}/tenants/{tenant}/remove",
            {"generation": gen}, timeout=self.config.http_timeout_s * 4)
        if status != 200:
            # the tenant serves on the target either way; a failed
            # source removal is an operational leak, not data loss
            logger.error("source removal of %s on %s failed: %s",
                         tenant, source.member_id, rbody)
        self._c_migrations.inc()
        return {"tenant": tenant, "from": source.member_id,
                "to": target.member_id, "generation": gen,
                "modelVersion": body.get("modelVersion"),
                "sourceRemoved": status == 200}

    # -- planning surfaces (pio placement plan/apply) -----------------------
    def plan(self, pending: Optional[List[TenantView]] = None) -> dict:
        """A dry-run plan: rebalance proposals for the current fleet,
        plus placements for any explicitly-pending tenants."""
        hosts = self.observe()
        live = [h for h in hosts if h.alive]
        out = {"rebalance": plan_rebalance(live).as_dict()}
        if pending:
            out["placement"] = plan_placement(
                live, pending,
                allow_preemption=self.config.allow_preemption).as_dict()
        return out

    def apply_rebalance(self) -> List[dict]:
        """Execute the current rebalance plan's migrations, one
        observation per migration (plan_rebalance converges on real
        signals, not a stale simulation)."""
        done = []
        for _ in range(16):   # hard cap per apply
            hosts = self.observe()
            live = [h for h in hosts if h.alive]
            plan = plan_rebalance(live)
            moves = [d for d in plan.decisions
                     if d.action == "migrate"]
            if not moves:
                break
            d = moves[0]
            done.append(self.migrate(d.tenant, d.host, hosts=hosts))
        return done

    def status(self) -> dict:
        hosts = self.observe()
        with self._lock:
            routes = dict(self._routes)
        return {
            "hosts": [{
                "memberId": h.member_id, "url": h.url,
                "alive": h.alive,
                "budgetBytes": h.budget_bytes,
                "usedBytes": h.used_bytes(),
                "tenants": {k: {"generation": t.generation,
                                "priority": t.priority,
                                "pinned": t.pinned,
                                "hbmBytes": t.hbm_bytes,
                                "trafficEwmaRps": t.traffic_ewma,
                                "sloStatus": t.slo_status}
                            for k, t in sorted(h.tenants.items())},
            } for h in sorted(hosts, key=lambda h: h.member_id)],
            "routes": {t: {"url": u, "memberId": m, "generation": g}
                       for t, (u, m, g) in sorted(routes.items())},
            "slo": self.slo.evaluate(),
        }

    # -- control thread -----------------------------------------------------
    def start(self) -> "PlacementController":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.config.interval_s):
                try:
                    self.step()
                except Exception:
                    logger.exception("placement controller step failed")

        self._thread = threading.Thread(
            target=loop, daemon=True, name="pio-placement-controller")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


class TenantRouter:
    """Client-side routing with retry-through-failover.

    ``query(tenant, body)`` looks the tenant up in the controller's
    O(1) route table, POSTs to the owning host with the placement
    generation attached (the host's fence turns a stale route into an
    honest 409), and maps every stale/transient verdict to a
    refreshed-route retry under the stock backoff policy — so a
    client calling through a host kill or a planned migration sees
    added latency, never a 5xx."""

    def __init__(self, controller: PlacementController,
                 policy: Optional[RetryPolicy] = None,
                 timeout_s: float = 10.0):
        self.controller = controller
        # deadline generous enough to ride out one failover (detection
        # + model reload); callers needing tighter bounds pass theirs
        self.policy = policy or RetryPolicy(
            max_attempts=8, base_delay_s=0.1, max_delay_s=2.0,
            deadline_s=90.0)
        self.timeout_s = timeout_s

    def _attempt(self, tenant: str, data: bytes) -> bytes:
        route = self.controller.route_for(tenant)
        if route is None:
            self.controller.refresh_routes()
            route = self.controller.route_for(tenant)
        if route is None:
            raise TransientHTTPError(
                f"no live placement for tenant {tenant!r}", status=503)
        url, _member, gen = route
        req = urllib.request.Request(
            f"{url}/engines/{tenant}/queries.json", data=data,
            method="POST",
            headers={"Content-Type": "application/json",
                     "X-PIO-Placement-Gen": str(gen)})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")[:200]
            if e.code in (404, 409, 429, 503):
                # the placement moved under us (or the host shed):
                # refresh and let the policy retry
                self.controller.refresh_routes()
                raise TransientHTTPError(
                    f"tenant {tenant!r} route stale ({e.code}): "
                    f"{detail}", status=e.code) from e
            raise
        except OSError:
            # connection refused/reset: the host just died — refresh
            # so the retry lands on a survivor (OSError is already in
            # the policy's TRANSIENT_ERRORS)
            self.controller.refresh_routes()
            raise

    def query(self, tenant: str, body: dict) -> dict:
        data = json.dumps(body).encode("utf-8")
        raw = self.policy.call(self._attempt, tenant, data)
        return json.loads(raw)
