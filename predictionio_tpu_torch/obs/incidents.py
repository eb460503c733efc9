"""Incident forensics: postmortem bundles captured when a guard fires.

The port's copy of `predictionio_tpu/obs/incidents.py`
(`IncidentManager`, `INCIDENTS`, `get_incidents`, `incidents_response`,
`incident_response`). A canary rollback, a sentinel breach, a gate
rejection, an operator rollback or a latency SLO breach is the system
saying something went wrong; by the time an operator looks, the rings
have rotated. `IncidentManager.capture` freezes the evidence when the
event fires:

    base_dir()/incidents/<id>/
        incident.json   kind, reason, context, provider states (the
                        engine server's serving and lineage state, the
                        scheduler's fold stats, the slow-query log, the
                        sampling profiler's report)
        flight.jsonl    the last N flight records (obs/flight.py)
        traces.json     the traces of the incident's trace ids (plus one
                        hop of links), else the most recent traces
        metrics.prom    a registry scrape per source

Captures run on a short-lived background thread and are rate-limited
per kind (`cooldown_s`); `max_incidents` bounds the directory, oldest
first. `incidents {list,show,export}` of the CLI read them. The
reference also freezes every other live fleet member's view into the
bundle; the port has no fleet registry yet, so its bundles hold this
process's view only.
"""

from __future__ import annotations

import datetime as _dt
import itertools
import json
import logging
import os
import shutil
import tarfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

# Join in-flight captures while daemon threads still run: plain atexit
# fires after the interpreter starts killing daemon threads, so a
# short-lived CLI would lose its bundle. threading._register_atexit
# (3.9+, same hook concurrent.futures uses) runs first.
try:
    from threading import _register_atexit as _thread_atexit
except ImportError:                                  # pragma: no cover
    import atexit
    _thread_atexit = atexit.register


def _tenant_trace_slice(traces: List[dict], tenant: str) -> List[dict]:
    """Keep this tenant's traces plus shared (untenanted) ones. Only
    records stamped with a DIFFERENT registered tenant are dropped —
    unstamped traces (device work, process-level ticks) are context the
    postmortem needs, and an unknown stamp means the registry rotated,
    not that the trace belongs to a neighbor."""
    from predictionio_tpu_torch.obs.tenantctx import registered_tenants
    others = registered_tenants() - {tenant}
    return [t for t in traces
            if t.get("root", {}).get("attrs", {}).get("tenant")
            not in others]


def _tenant_provider_slice(providers: Dict[str, Callable],
                           tenant: str) -> Dict[str, Callable]:
    """Drop providers whose dotted suffix names ANOTHER registered
    tenant (``engine_server.other`` when capturing for ``tenant``).
    Un-suffixed providers (event store, scheduler, device plane) are
    shared context and stay in the bundle."""
    from predictionio_tpu_torch.obs.tenantctx import registered_tenants
    others = registered_tenants() - {tenant}
    return {name: fn for name, fn in providers.items()
            if name.rsplit(".", 1)[-1] not in others}


class IncidentManager:
    def __init__(self, incidents_dir: Optional[str] = None,
                 flight_tail: int = 200, traces_limit: int = 50,
                 cooldown_s: float = 30.0, max_incidents: int = 50,
                 trace_settle_s: float = 0.3):
        self._dir_override = incidents_dir
        self.flight_tail = flight_tail
        self.traces_limit = traces_limit
        self.cooldown_s = cooldown_s
        self.max_incidents = max_incidents
        # incidents usually fire INSIDE the trace that explains them (a
        # gate rejection mid fold-tick): the bundle writer waits this
        # long before reading the trace rings so the in-flight trace
        # can commit. Flight records are snapshotted eagerly instead —
        # the ring there is shared across kinds and rotates faster.
        self.trace_settle_s = trace_settle_s
        self._lock = threading.Lock()
        self._last_by_kind: Dict[str, float] = {}
        self._seq = itertools.count(1)
        # name -> zero-arg callable returning a JSON-able dict; each
        # subsystem registers its own state reader (the event server's
        # WAL stats, the engine server's serving/lineage state, the
        # scheduler's fold stats). Name-keyed so a restarted subsystem
        # replaces its predecessor instead of accumulating closures.
        self._providers: Dict[str, Callable[[], dict]] = {}
        self._threads: List[threading.Thread] = []
        self._drain_registered = False
        self.captured = 0
        self.suppressed = 0
        self.failed = 0
        self._registered = False
        # eager: pio_incidents_* must scrape as 0 on an incident-free
        # server, not appear only after the first capture (absent vs 0
        # is indistinguishable from the plane being broken)
        self._register_metrics()

    # -- configuration -------------------------------------------------
    def incidents_dir(self) -> str:
        if self._dir_override:
            return self._dir_override
        env = os.environ.get("PIO_INCIDENTS_DIR")
        if env:
            return env
        from predictionio_tpu_torch.data.storage.registry import base_dir
        return os.path.join(base_dir(), "incidents")

    def configure(self, incidents_dir: Optional[str] = None,
                  cooldown_s: Optional[float] = None):
        if incidents_dir is not None:
            self._dir_override = incidents_dir
        if cooldown_s is not None:
            self.cooldown_s = cooldown_s

    def register_provider(self, name: str, fn: Callable[[], dict]):
        """Bound methods are held by WEAKREF: servers register
        ``self._incident_state``-style readers in __init__, and this
        process-lifetime singleton must not pin a stopped server (and
        its models) in memory until a same-named replacement shows up.
        Plain functions/lambdas (tests, module-level readers) are held
        strongly — WeakMethod can't wrap them and they pin nothing by
        themselves."""
        import weakref
        try:
            ref = weakref.WeakMethod(fn)
        except TypeError:
            ref = (lambda f: (lambda: f))(fn)
        with self._lock:
            self._providers[name] = ref

    def _register_metrics(self):
        if self._registered:
            return
        self._registered = True
        from predictionio_tpu_torch.obs.metrics import get_registry
        reg = get_registry()
        reg.counter_func(
            "pio_incidents_captured_total",
            "Postmortem bundles written to base_dir()/incidents/",
            lambda: self.captured)
        reg.counter_func(
            "pio_incidents_suppressed_total",
            "Incident captures skipped by the per-kind cooldown",
            lambda: self.suppressed)

    # -- capture --------------------------------------------------------
    def capture(self, kind: str, reason: str,
                context: Optional[dict] = None,
                trace_ids: Sequence[str] = (),
                sync: bool = False,
                tenant: Optional[str] = None) -> Optional[str]:
        """Fire-and-forget bundle capture. Returns the incident id (or
        None when suppressed by the cooldown / disabled). Never raises
        — a diagnosis failure must not worsen the incident.

        ``sync=True`` (CLI, tests) blocks until the bundle is on disk.

        ``tenant`` (or, absent that, the active tenant scope — a
        capture fired inside a tenant slot's routing/tick path) names
        the tenant the bundle belongs to: ``incident.json`` carries a
        top-level ``tenant`` field, and the bundle's flight/trace/
        provider slices keep only that tenant's records plus the
        shared-device context (a noisy-neighbor postmortem must not
        leak every OTHER tenant's traffic into one slot's bundle)."""
        try:
            if tenant is None:
                from predictionio_tpu_torch.obs.tenantctx import current_tenant
                tenant = current_tenant()
            self._register_metrics()
            if os.environ.get("PIO_INCIDENTS", "").strip().lower() \
                    in ("off", "0", "false"):
                return None
            now = time.monotonic()
            with self._lock:
                last = self._last_by_kind.get(kind)
                if last is not None and now - last < self.cooldown_s:
                    self.suppressed += 1
                    return None
                self._last_by_kind[kind] = now
                seq = next(self._seq)
            stamp = _dt.datetime.now(_dt.timezone.utc).strftime(
                "%Y%m%dT%H%M%S")
            # pid-qualified: the event server and engine server share
            # base_dir(), and one storage outage trips both in the
            # same second — same stamp, same kind, same per-process
            # seq — which without the pid would interleave two
            # captures into one bundle directory
            incident_id = f"{stamp}-{kind}-{os.getpid()}-{seq}"
            # snapshot the flight ring NOW (shared across kinds, it
            # rotates fast); traces are read by the bundle writer
            # after trace_settle_s so the trace the incident fired
            # inside of can commit first
            from predictionio_tpu_torch.obs.flight import FLIGHT
            flight = FLIGHT.tail(self.flight_tail)
            if tenant is not None:
                # the slot's slice plus shared-device records (no
                # tenant stamp): neighbors' traffic stays out
                flight = [r for r in flight
                          if r.get("tenant") in (tenant, None)]
            if sync:
                self._write_bundle(incident_id, kind, reason, context,
                                   flight, tuple(trace_ids), tenant)
            else:
                # daemon + bounded at-exit drain: a short-lived
                # process (a one-shot `pio update` whose fold was
                # gate-rejected) must not exit before the bundle
                # lands, but breaker_open incidents fire precisely
                # when disks misbehave — a non-daemon thread wedged
                # on a dead disk would hang server shutdown forever,
                # so the drain joins with a deadline instead
                t = threading.Thread(
                    target=self._write_bundle,
                    args=(incident_id, kind, reason, context, flight,
                          tuple(trace_ids), tenant),
                    daemon=True, name="pio-incident-capture")
                with self._lock:
                    self._threads = [th for th in self._threads
                                     if th.is_alive()]
                    self._threads.append(t)
                    if not self._drain_registered:
                        self._drain_registered = True
                        _thread_atexit(self.drain)
                t.start()
            return incident_id
        except Exception:
            with self._lock:
                self.failed += 1
            logger.exception("incident capture failed (%s)", kind)
            return None

    def drain(self, timeout_s: float = 10.0) -> bool:
        """Join in-flight capture threads, bounded by ``timeout_s``
        total. Registered at interpreter exit; callable directly by
        tests/CLI. True when every capture finished."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            threads = list(self._threads)
        done = True
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            done = done and not t.is_alive()
        return done

    def _matching_traces(self, trace_ids: Sequence[str]) -> List[dict]:
        from predictionio_tpu_torch.obs.trace import TRACER
        recent = TRACER.snapshot(limit=500)
        if not trace_ids:
            return recent[:self.traces_limit]
        wanted = set(trace_ids)
        out, rest = [], []
        for t in recent:
            if t["traceId"] in wanted \
                    or wanted & set(t.get("links") or ()):
                out.append(t)
            else:
                rest.append(t)
        # one hop outward: traces the matched set links to
        linked = {l for t in out for l in (t.get("links") or ())}
        out.extend(t for t in rest if t["traceId"] in linked)
        return out[:self.traces_limit]

    def _write_bundle(self, incident_id, kind, reason, context,
                      flight, trace_ids, tenant=None):
        try:
            if self.trace_settle_s > 0:
                time.sleep(self.trace_settle_s)
            traces = self._matching_traces(trace_ids)
            if tenant is not None:
                traces = _tenant_trace_slice(traces, tenant)
            d = os.path.join(self.incidents_dir(), incident_id)
            os.makedirs(d, exist_ok=True)
            with self._lock:
                # dereference + prune: a dead ref means the subsystem
                # is gone (not an error) — drop it from the bundle and
                # the table
                providers = {}
                for name, ref in list(self._providers.items()):
                    fn = ref()
                    if fn is None:
                        del self._providers[name]
                    else:
                        providers[name] = fn
            if tenant is not None:
                providers = _tenant_provider_slice(providers, tenant)
            provider_state = {}
            for name, fn in providers.items():
                try:
                    provider_state[name] = fn()
                except Exception as e:
                    provider_state[name] = {"error": str(e)}
            meta = {
                "id": incident_id, "kind": kind, "reason": reason,
                "capturedAt": _dt.datetime.now(
                    _dt.timezone.utc).isoformat(),
                "context": dict(context or {}),
                "providers": provider_state,
                "flightRecords": len(flight),
                "traces": len(traces),
            }
            if tenant is not None:
                meta["tenant"] = tenant
                meta["context"].setdefault("tenant", tenant)
            with open(os.path.join(d, "incident.json"), "w") as f:
                json.dump(meta, f, indent=2, default=str)
            with open(os.path.join(d, "flight.jsonl"), "w") as f:
                for rec in flight:
                    f.write(json.dumps(rec, default=str,
                                       separators=(",", ":")) + "\n")
            with open(os.path.join(d, "traces.json"), "w") as f:
                json.dump({"traces": traces}, f, default=str)
            self._write_metrics(d)
            with self._lock:   # captures run on concurrent threads
                self.captured += 1
            self._retire_old()
            logger.error("incident %s captured (%s: %s) -> %s",
                         incident_id, kind, reason, d)
        except Exception:
            with self._lock:
                self.failed += 1
            logger.exception("incident bundle write failed (%s)",
                             incident_id)

    def _write_metrics(self, d: str):
        from predictionio_tpu_torch.obs.flight import FLIGHT
        from predictionio_tpu_torch.obs.metrics import get_registry
        chunks = ["# source: process\n" + get_registry().render()]
        for i, src in enumerate(FLIGHT._live_sources()):
            try:
                # own families only: the parent chain is the process
                # render above, once
                chunks.append(f"# source: child-{i}\n"
                              + src.render(include_parent=False))
            except Exception:
                pass
        with open(os.path.join(d, "metrics.prom"), "w") as f:
            f.write("\n".join(chunks))

    def _retire_old(self):
        root = self.incidents_dir()
        try:
            names = sorted(n for n in os.listdir(root)
                           if os.path.isdir(os.path.join(root, n)))
        except OSError:
            return
        for stale in names[:max(0, len(names) - self.max_incidents)]:
            shutil.rmtree(os.path.join(root, stale), ignore_errors=True)

    # -- operator reads (pio incidents) ---------------------------------
    def list_incidents(self) -> List[dict]:
        root = self.incidents_dir()
        out = []
        try:
            names = sorted(os.listdir(root), reverse=True)
        except OSError:
            return out
        for name in names:
            meta = os.path.join(root, name, "incident.json")
            if not os.path.isfile(meta):
                continue
            try:
                with open(meta) as f:
                    m = json.load(f)
                out.append({"id": m.get("id", name),
                            "kind": m.get("kind"),
                            "reason": m.get("reason"),
                            "tenant": m.get("tenant"),
                            "capturedAt": m.get("capturedAt")})
            except (OSError, ValueError):
                out.append({"id": name, "kind": "?",
                            "reason": "unreadable incident.json"})
        return out

    def load(self, incident_id: str) -> dict:
        """The full bundle as one dict (``pio incidents show``)."""
        d = os.path.join(self.incidents_dir(), incident_id)
        with open(os.path.join(d, "incident.json")) as f:
            out = json.load(f)
        flight = []
        fpath = os.path.join(d, "flight.jsonl")
        if os.path.isfile(fpath):
            with open(fpath) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        flight.append(json.loads(line))
                    except ValueError:
                        pass   # torn tail tolerated by design
        out["flight"] = flight
        tpath = os.path.join(d, "traces.json")
        if os.path.isfile(tpath):
            with open(tpath) as f:
                out["traceDetail"] = json.load(f).get("traces", [])
        return out

    def export(self, incident_id: str,
               out_path: Optional[str] = None) -> str:
        """Bundle ``<id>`` into a ``.tar.gz`` for hand-off."""
        d = os.path.join(self.incidents_dir(), incident_id)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no incident {incident_id}")
        out_path = out_path or f"{incident_id}.tar.gz"
        with tarfile.open(out_path, "w:gz") as tar:
            tar.add(d, arcname=incident_id)
        return out_path


# The process-wide incident manager.
INCIDENTS = IncidentManager()


def get_incidents() -> IncidentManager:
    return INCIDENTS


def incidents_response(params: dict) -> dict:
    """Shared ``GET /incidents.json`` body: the bundle index, so
    ``incidents list --url`` works against a server that does not share
    the operator's filesystem."""
    limit = int(params.get("n", params.get("limit", 50)))
    return {"incidents": INCIDENTS.list_incidents()[:max(0, limit)],
            "incidentsDir": INCIDENTS.incidents_dir()}


def incident_response(incident_id: str):
    """``GET /incidents/<id>.json`` -> (status, body). Path components
    are rejected — the id names a directory under incidents_dir."""
    if not incident_id or "/" in incident_id or ".." in incident_id:
        return 400, {"message": "bad incident id"}
    try:
        return 200, INCIDENTS.load(incident_id)
    except (OSError, ValueError):
        return 404, {"message": f"no incident {incident_id}"}
