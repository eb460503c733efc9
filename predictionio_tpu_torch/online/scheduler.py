"""Delta-training scheduler: tail the event store, fold in, hot-swap.

The port's counterpart of `predictionio_tpu/online/scheduler.py`
(`EntityDelta`, `SchedulerConfig`, `DeltaTrainingScheduler`,
`attach_scheduler`). The tail read runs behind the `scheduler_tail`
`resilience.CircuitBreaker`, whose transitions are flight records,
`pio_breaker_*` samples and, on opening, a `breaker_open` incident; a
started scheduler is a fleet member (`obs/fleet.py`, role `scheduler`).
Each tick:

1. TAIL: read the events at or after the cursor through the event store
   (`LEventStore.find`), routed by entity type into per-entity deltas (a
   `$set` on an item is an item delta).
2. TRIGGER: fold when the fresh events reach `max_deltas`, the oldest
   delta is `max_staleness_s` old, or `tick(force=True)`.
3. READ: the touched entities' complete histories through the data
   source's `read_training_touched` (the store's entity pushdown) when
   at most `filtered_read_max_entities` are touched, else the full scan.
4. FOLD: each online-capable algorithm re-solves only the touched rows
   (`algo.fold_in`).
5. GATES: the candidates must pass the quality gates against the live
   models (`guard/gates.py`), else `GateRejected` and the deltas are
   restored; then the drift gate (the fold's loss against the anchor
   loss) may ask for a retrain.
6. PUBLISH: a new version through the registry, `server.swap_models` of
   an attached in-process server (with the touched user and item ids,
   so its result cache drops exactly their entries), `POST reload_url` of
   a deployed one (which clears that server's cache).

Any failure before the publish lands restores the tick's deltas, so the
next tick folds those events again. The cursor is the largest event time
seen; the events at that instant are remembered by id, so the
inclusive re-read does not count them twice.

An attached server's canary verdicts come back through
`note_canary_decision`: a promote pins the version last-good, a rollback
re-anchors the scheduler on the models the server serves, demotes the
version and asks for a retrain.

A tick's wall, its events, its upload bytes (`obs/torchmon`'s per-thread
total, the report's `h2dBytes`), the rows it read by read path, its
failures and the gate rejects are counted in the reference's
`pio_fold_*` and `pio_guard_gate_rejects_total` families on the
process-wide registry, under the scheduler's `tenant` label (`""` for a
scheduler that follows no tenant slot). The
report also carries the stage walls (`readS`, `publishS`, `reloadS`,
`tickS`) and the process's device time by executable label
(`deviceTime`: the sampled CUDA-event seconds and sample counts,
`fold_side` among them).

Each tick that sees fresh events or folds records a `fold_tick` trace:
`tail_read`, `tail_data_read`, `fold_solve` (an algorithm's fold; it
returns host tables, so the span ends after the copy that waits for the
fold's CUDA stream), `guard_gates`, `registry_publish`, `hot_swap`,
`reload` (whose POST carries the tick's trace context). The tail read
resolves each fresh event to the trace that ingested it: in this process
through `TRACER.trace_id_for_event`, in another through the fleet peers'
event maps (`fleet.resolve_event_traces`); the fold tick links those
ingest traces and each of them links the tick back. Gate verdicts,
publishes and the retrain escalation are flight records; a gate
rejection captures an incident bundle, and the scheduler's `stats()`
rides every bundle.

A scheduler that follows a serving host's tenant slot (`tenant=`) runs
each tick under the tenant's attribution scope, so its uploads and
residency slots are tagged for the host's HBM budget (and evicted with
the tenant). The schedulers a host attaches share the host's
`FoldTickGate` (`tick_gate=`): the loop's ticks take turns through it,
the tenant whose last turn is oldest first, and each tenant's wait is
observed in `pio_fold_tick_wait_seconds{tenant}`.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import logging
import threading
import time
import urllib.request
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from predictionio_tpu_torch.data.event import (Event, parse_event_time,
                                               utcnow)
from predictionio_tpu_torch.data.store import LEventStore
from predictionio_tpu_torch.guard.gates import (GateConfig, GateRejected,
                                                QualityGatekeeper)
from predictionio_tpu_torch.obs import (FLIGHT, TRACER, costmon, fleet,
                                        get_incidents, get_registry,
                                        register_tenant, tenant_scope,
                                        torchmon, trace_context_headers)
from predictionio_tpu_torch.online.registry import ONLINE_BATCH_TAG
from predictionio_tpu_torch.resilience import (CircuitBreaker,
                                               CircuitOpenError)
from predictionio_tpu_torch.resilience.policy import CLOSED

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class EntityDelta:
    """Mergeable per-entity delta state: commutative and associative."""
    count: int = 0
    first_t: Optional[_dt.datetime] = None
    last_t: Optional[_dt.datetime] = None

    @staticmethod
    def from_event(e: Event) -> "EntityDelta":
        return EntityDelta(count=1, first_t=e.event_time,
                           last_t=e.event_time)

    def merge(self, other: "EntityDelta") -> "EntityDelta":
        def opt(a, b, f):
            if a is None:
                return b
            if b is None:
                return a
            return f(a, b)
        return EntityDelta(count=self.count + other.count,
                           first_t=opt(self.first_t, other.first_t, min),
                           last_t=opt(self.last_t, other.last_t, max))


def _merge(parts) -> Dict[str, EntityDelta]:
    """Merge per-entity delta maps (the aggregator's combine)."""
    out: Dict[str, EntityDelta] = {}
    for part in parts:
        for k, d in part.items():
            prev = out.get(k)
            out[k] = d if prev is None else prev.merge(d)
    return out


@dataclass(frozen=True)
class SchedulerConfig:
    app_name: str
    channel_name: Optional[str] = None
    # None = the data source's event_names, plus $set
    event_names: Optional[Sequence[str]] = None
    max_deltas: int = 256          # fold after this many fresh events
    max_staleness_s: float = 30.0  # ... or once the oldest delta is this old
    drift_ratio: float = 1.5       # fold loss / anchor loss escalation
    poll_interval_s: float = 2.0   # the loop's cadence
    tail_batch_limit: int = 50_000  # events read a tick at most
    # the entity-filtered read when at most this many entities are
    # touched (past a few thousand, the per-id probes cost a scan)
    filtered_reads: bool = True
    filtered_read_max_entities: int = 1024
    # consecutive tick failures back off (poll_interval * 2^k, capped);
    # after max_tick_failures the loop asks for a retrain
    max_tick_failures: int = 5
    failure_backoff_cap_s: float = 60.0
    # the breaker over the tail read
    tail_breaker_failures: int = 3
    tail_breaker_reset_s: float = 10.0
    gates: bool = True
    gate_config: GateConfig = GateConfig()


class FoldTickGate:
    """One fold tick at a time for the schedulers of one serving host
    (the reference's gate). `turn(tenant)` admits one tick; among the
    waiters the grant goes to the tenant whose last grant is oldest
    (never granted first, then arrival order), so each tenant's fold
    lag is bounded by tenants x tick time. Each turn's wait is observed
    in `pio_fold_tick_wait_seconds{tenant}`."""

    def __init__(self, registry=None):
        reg = registry or get_registry()
        self._h_wait = reg.histogram(
            "pio_fold_tick_wait_seconds",
            "Time a tenant's fold tick waited for its turn at the "
            "shared per-host tick gate",
            labelnames=("tenant",))
        self._cond = threading.Condition()
        self._busy: Optional[str] = None
        self._seq = 0
        self._waiters: List[Tuple[str, int]] = []
        self._last_grant: Dict[str, float] = {}
        self._children: Dict[str, Any] = {}

    def _child(self, tenant: str):
        c = self._children.get(tenant)
        if c is None:
            if len(self._children) >= 4096:
                self._children.clear()
            c = self._children[tenant] = self._h_wait.labels(tenant=tenant)
        return c

    def _pick(self) -> Optional[Tuple[str, int]]:
        """The waiter whose tenant has gone longest without a grant."""
        if not self._waiters:
            return None
        return min(self._waiters, key=lambda w: (
            self._last_grant.get(w[0], float("-inf")), w[1]))

    @contextlib.contextmanager
    def turn(self, tenant: str):
        tenant = tenant or ""
        t0 = time.monotonic()
        with self._cond:
            me = (tenant, self._seq)
            self._seq += 1
            self._waiters.append(me)
            while self._busy is not None or self._pick() != me:
                self._cond.wait(timeout=1.0)
            self._waiters.remove(me)
            self._busy = tenant
        self._child(tenant).observe(time.monotonic() - t0)
        try:
            yield
        finally:
            with self._cond:
                self._busy = None
                if len(self._last_grant) >= 4096:
                    self._last_grant.clear()
                self._last_grant[tenant] = time.monotonic()
                self._cond.notify_all()

    def stats(self) -> dict:
        with self._cond:
            return {"busy": self._busy,
                    "waiting": [w[0] for w in sorted(self._waiters,
                                                     key=lambda w: w[1])]}


class DeltaTrainingScheduler:
    """Follows one deployed engine. `server`: an in-process
    `EngineServer` to hot-swap. `registry` + `reload_url`: publish each
    folded version and `POST /reload` a deployed server (what `update`
    does). Either, both or neither may be given."""

    def __init__(self, engine, engine_params, instance,
                 algorithms: Sequence[Any], models: Sequence[Any],
                 config: SchedulerConfig, server=None, registry=None,
                 reload_url: Optional[str] = None,
                 event_store=None, cursor: Optional[_dt.datetime] = None,
                 tenant: Optional[str] = None,
                 tick_gate: Optional[FoldTickGate] = None):
        # a serving host's tenant slot: its ticks run under the tenant's
        # attribution scope; the host's gate orders the loop's ticks
        self.tenant = str(tenant) if tenant is not None else None
        self._tick_gate = tick_gate
        self.engine = engine
        self.engine_params = engine_params
        self.instance = instance
        self.algorithms = list(algorithms)
        self.models = list(models)
        self.config = config
        self.server = server
        self.registry = registry
        self.reload_url = reload_url
        self.events = event_store or LEventStore
        # events at or after the cursor are fresh: a trained instance's
        # start, or the cursor an online version's lineage recorded
        self._cursor: Optional[_dt.datetime] = (
            cursor if cursor is not None else self._instance_cursor(instance))
        # the events already at the cursor instant are inside the model
        # this scheduler resumes from (a failed pre-read: they count once)
        self._seen_at_cursor: Set[str] = set()
        if self._cursor is not None:
            try:
                self._seen_at_cursor = {
                    e.event_id for e in self.events.find(
                        app_name=config.app_name,
                        channel_name=config.channel_name,
                        start_time=self._cursor,
                        until_time=self._cursor
                        + _dt.timedelta(milliseconds=1),
                        event_names=self._event_names())
                    if e.event_id is not None}
            except Exception:
                logger.debug("cursor-boundary pre-read failed; boundary "
                             "events may count twice", exc_info=True)
        self._user_deltas: Dict[str, EntityDelta] = {}
        self._item_deltas: Dict[str, EntityDelta] = {}
        self._pending_events = 0
        # the ingest traces of the pending events (bounded), which the
        # fold tick links
        self._pending_trace_ids: Set[str] = set()
        self.gatekeeper = (QualityGatekeeper(config.gate_config)
                           if config.gates else None)
        self.gate_rejects = 0
        # the breaker over the event-store tail read
        self._tail_breaker = CircuitBreaker(
            "scheduler_tail", failure_threshold=config.tail_breaker_failures,
            reset_timeout_s=config.tail_breaker_reset_s)
        self._fleet_id: Optional[str] = None
        self.consecutive_failures = 0
        self.last_error: Optional[str] = None
        # process-wide fold instruments (schedulers in one process share
        # the families), each under this scheduler's tenant series
        if self.tenant is not None:
            register_tenant(self.tenant)
        self._metric_tenant = self.tenant or ""
        reg = get_registry()
        self._h_tick = reg.histogram(
            "pio_fold_tick_seconds",
            "Wall time of a scheduler tick that ran a fold-in (tail read "
            "+ touched-row solves + publish + swap)",
            labelnames=("tenant",)).labels(tenant=self._metric_tenant)
        self._c_fold_events = reg.counter(
            "pio_fold_events_total",
            "Fresh events absorbed by completed fold-ins",
            labelnames=("tenant",)).labels(tenant=self._metric_tenant)
        self._c_fold_h2d = reg.counter(
            "pio_fold_upload_bytes_total",
            "Host->device bytes uploaded by fold-in solves",
            labelnames=("tenant",)).labels(tenant=self._metric_tenant)
        self._c_tick_failures = reg.counter(
            "pio_fold_tick_failures_total",
            "Scheduler ticks that raised (tail read, solve, or publish "
            "failure); consecutive failures back off exponentially",
            labelnames=("tenant",)).labels(tenant=self._metric_tenant)
        self._c_fold_read_rows = reg.counter(
            "pio_fold_read_rows_total",
            "Training-data rows read by fold ticks, by read path "
            "(entity_filtered = the touched entities' pushdown, full_scan "
            "= the whole corpus)", labelnames=("path", "tenant"))
        self._c_gate_rejects = reg.counter(
            "pio_guard_gate_rejects_total",
            "Fold publishes refused by the pre-swap quality gates (the "
            "live model kept serving)",
            labelnames=("tenant",)).labels(tenant=self._metric_tenant)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fold_in_count = 0
        self.events_folded = 0
        self.retrain_requested = False
        self.anchor_loss: Optional[float] = None
        self.last_loss: Optional[float] = None
        self.last_report: Optional[dict] = None
        # incident bundles freeze the fold lineage
        get_incidents().register_provider("scheduler", self.stats)

    @staticmethod
    def _instance_cursor(instance) -> Optional[_dt.datetime]:
        """Where a (re)attached scheduler resumes: an online version's
        lineage cursor, else the instance's training start."""
        batch = getattr(instance, "batch", "") or ""
        if batch.startswith(ONLINE_BATCH_TAG + ":"):
            try:
                lineage = json.loads(batch[len(ONLINE_BATCH_TAG) + 1:])
                if lineage.get("cursor"):
                    return parse_event_time(lineage["cursor"])
            except (ValueError, KeyError):
                logger.warning("unparseable online lineage tag %r", batch)
        return getattr(instance, "start_time", None)

    # -- the tail ----------------------------------------------------------
    def _event_names(self) -> Optional[List[str]]:
        if self.config.event_names is not None:
            return list(self.config.event_names)
        _, ds_params = self.engine_params.data_source_params
        names = getattr(ds_params, "event_names", None)
        if names is None:
            return None
        # a property-only update (new item metadata) is freshness too
        out = list(names)
        if "$set" not in out:
            out.append("$set")
        return out

    def poll_events(self) -> int:
        """Advance the tail: the fresh events into the delta state.
        Returns the number of new events (each counts once, however many
        entities it touches). Only store work counts against the tail
        breaker; the state commits after the whole read."""
        cfg = self.config
        fresh = 0
        self._tail_breaker.allow()
        new_users: Dict[str, EntityDelta] = {}
        new_items: Dict[str, EntityDelta] = {}
        new_trace_ids: Set[str] = set()
        miss_ids: List[str] = []
        max_t = self._cursor
        boundary: Set[str] = set()
        try:
            it = iter(self.events.find(
                app_name=cfg.app_name, channel_name=cfg.channel_name,
                start_time=self._cursor, event_names=self._event_names(),
                limit=cfg.tail_batch_limit))
        except Exception:
            self._tail_breaker.record_failure()
            raise
        while True:
            try:
                e = next(it)
            except StopIteration:
                break
            except Exception:
                self._tail_breaker.record_failure()
                raise
            try:
                if e.event_id is not None \
                        and e.event_id in self._seen_at_cursor:
                    continue    # the boundary instant, read again
                fresh += 1
                if e.event_id is not None:
                    tid = TRACER.trace_id_for_event(e.event_id)
                    if tid:
                        new_trace_ids.add(tid)
                    else:
                        miss_ids.append(e.event_id)
                d = EntityDelta.from_event(e)
                # by entity type: a rating's subject is a user, its
                # target an item; an item's $set is an item delta
                if e.entity_id:
                    side = (new_items if e.entity_type == "item"
                            else new_users)
                    prev = side.get(e.entity_id)
                    side[e.entity_id] = d if prev is None else prev.merge(d)
                if e.target_entity_id and e.target_entity_type != "user":
                    prev = new_items.get(e.target_entity_id)
                    new_items[e.target_entity_id] = (
                        d if prev is None else prev.merge(d))
                if max_t is None or e.event_time > max_t:
                    max_t = e.event_time
                    boundary = {e.event_id} if e.event_id else set()
                elif e.event_time == max_t and e.event_id:
                    boundary.add(e.event_id)
            except Exception:
                # the store answered; the event itself was bad
                self._tail_breaker.record_success()
                raise
        self._tail_breaker.record_success()
        if miss_ids:
            # ingest traces of other processes: ask the fleet peers'
            # event maps (fail-soft; co-located servers share this
            # process's tracer, so a local miss is another pid's or none)
            try:
                new_trace_ids.update(
                    fleet.resolve_event_traces(miss_ids).values())
            except Exception:
                logger.debug("fleet event-trace resolution failed",
                             exc_info=True)
        with self._lock:
            self._user_deltas = _merge([self._user_deltas, new_users])
            self._item_deltas = _merge([self._item_deltas, new_items])
            self._pending_events += fresh
            # bounded (Trace.MAX_LINKS caps the fold trace's side too)
            room = 256 - len(self._pending_trace_ids)
            for tid in list(new_trace_ids)[:max(room, 0)]:
                self._pending_trace_ids.add(tid)
            if max_t is not None and (self._cursor is None
                                      or max_t > self._cursor):
                self._cursor = max_t
                self._seen_at_cursor = boundary
            elif max_t is not None:
                self._seen_at_cursor |= boundary
        return fresh

    # -- the trigger -------------------------------------------------------
    def pending_deltas(self) -> int:
        """Fresh events since the last fold."""
        with self._lock:
            return self._pending_events

    def should_fold(self, now: Optional[_dt.datetime] = None) -> bool:
        cfg = self.config
        with self._lock:
            if self._pending_events == 0:
                return False
            if self._pending_events >= cfg.max_deltas:
                return True
            firsts = [d.first_t for d in list(self._user_deltas.values())
                      + list(self._item_deltas.values())
                      if d.first_t is not None]
            if not firsts:
                return False
            now = now or utcnow()
            return (now - min(firsts)).total_seconds() \
                >= cfg.max_staleness_s

    # -- the fold ----------------------------------------------------------
    def _read_training_data(self):
        """The full scan through the engine's data source."""
        return self.engine.make_data_source(self.engine_params
                                            ).read_training()

    @staticmethod
    def _td_rows(td) -> Optional[int]:
        """Rows of a template's training payload (ratings, or view and
        like events); None for an unknown shape."""
        total = None
        for attr in ("ratings", "view_events", "like_events"):
            rows = getattr(td, attr, None)
            if rows is None:
                continue
            try:
                n = int(len(rows))
            except TypeError:
                continue
            total = n if total is None else total + n
        return total

    def _read_training(self, touched_users, touched_items):
        """The entity-filtered read when the data source has it and the
        touched set is small, else the full scan. Returns (td, info)."""
        cfg = self.config
        n_touched = len(touched_users) + len(touched_items)
        if cfg.filtered_reads and 0 < n_touched \
                <= cfg.filtered_read_max_entities:
            reader = getattr(self.engine.make_data_source(
                self.engine_params), "read_training_touched", None)
            if reader is not None:
                td = reader(touched_users, touched_items)
                return td, {"readPath": "entity_filtered",
                            "readRows": self._td_rows(td)}
        td = self._read_training_data()
        return td, {"readPath": "full_scan", "readRows": self._td_rows(td)}

    def fold_in(self) -> dict:
        """One fold over the accumulated deltas, gated and published."""
        with self._lock:
            user_deltas, item_deltas = self._user_deltas, self._item_deltas
            n_events = self._pending_events
            trace_ids = self._pending_trace_ids
            self._user_deltas, self._item_deltas = {}, {}
            self._pending_events = 0
            self._pending_trace_ids = set()
        touched_users = list(user_deltas)
        touched_items = list(item_deltas)
        # two-way links: the tick's trace names the ingest traces it
        # absorbs, and each of them gains a link to the tick
        tick_trace = TRACER.current_trace()
        if tick_trace is not None:
            for tid in trace_ids:
                tick_trace.link(tid)
                TRACER.link_completed(tid, tick_trace.trace_id)
        # this thread's uploads only
        h2d_before = torchmon.thread_h2d_total()
        try:
            t0 = time.perf_counter()
            with TRACER.span("tail_data_read") as sp:
                td, read_info = self._read_training(touched_users,
                                                    touched_items)
                if sp is not None:
                    sp.attrs.update(read_info)
            read_info["readS"] = time.perf_counter() - t0
            new_models: List[Any] = []
            reports: List[dict] = []
            folded_any = False
            # the fold replays the preparator's policy (dedup, exclusions)
            _, prep_params = self.engine_params.preparator_params
            for algo, model in zip(self.algorithms, self.models):
                fold = getattr(algo, "fold_in", None)
                if fold is None:
                    new_models.append(model)   # not online-capable
                    continue
                # the fold returns host tables: the span ends after the
                # copy that waits for the fold's stream, so it times the
                # solves and not only their launch
                with TRACER.span("fold_solve",
                                 touchedUsers=len(touched_users),
                                 touchedItems=len(touched_items)):
                    new_model, report = fold(model, td, touched_users,
                                             touched_items,
                                             preparator_params=prep_params)
                new_models.append(new_model)
                reports.append(report)
                folded_any = True
        except Exception:
            self._restore_deltas(user_deltas, item_deltas, n_events,
                                 trace_ids)
            raise
        report = {
            "foldIn": self.fold_in_count + 1,
            "touchedUsers": len(touched_users),
            "touchedItems": len(touched_items),
            "events": n_events,
            "algorithms": reports,
            "h2dBytes": torchmon.h2d_delta(h2d_before),
            **read_info,
        }
        # a sharded tick's layout rides the report and the trace
        sharding = next((r.get("sharding") for r in reports
                         if r.get("sharding")), None)
        if sharding is not None:
            report["sharding"] = sharding
            TRACER.annotate(sharding=sharding)
        TRACER.annotate(h2dBytes=report["h2dBytes"])
        if read_info.get("readRows") is not None:
            self._c_fold_read_rows.labels(
                path=read_info["readPath"],
                tenant=self._metric_tenant).inc(read_info["readRows"])
        if not folded_any:
            logger.warning("no algorithm supports fold_in; deltas dropped")
            self.last_report = report
            return report
        if all(nm is old for nm, old in zip(new_models, self.models)):
            # every algorithm no-opped: nothing to gate or publish, and
            # folding these events again would no-op the same way
            report["degenerate"] = True
            TRACER.annotate(degenerate=True)
            logger.info("fold tick was a clean no-op (%d event(s) "
                        "contributed nothing solvable)", n_events)
            self.last_report = report
            return report
        guard_wall_s = sum(r.get("guardWallS") or 0.0 for r in reports)
        if self.gatekeeper is not None:
            g0 = time.perf_counter()
            with TRACER.span("guard_gates") as sp:
                gate_report = self.gatekeeper.evaluate(
                    new_models, self.models, self.algorithms)
                if sp is not None:
                    sp.attrs["passed"] = gate_report["passed"]
                    sp.attrs["verdicts"] = {
                        g["gate"]: g["verdict"]
                        for g in gate_report["gates"]}
            guard_wall_s += time.perf_counter() - g0
            report["gateReport"] = gate_report
        report["guardOverheadMs"] = round(guard_wall_s * 1000, 3)
        if self.gatekeeper is not None:
            TRACER.annotate(gatesPassed=gate_report["passed"])
            FLIGHT.record(
                "gate_verdict",
                model_version=getattr(self.instance, "id", None),
                passed=gate_report["passed"],
                verdicts={g["gate"]: g["verdict"]
                          for g in gate_report["gates"]},
                events=n_events)
        if self.gatekeeper is not None and not gate_report["passed"]:
            # restored for the record; the same data folds the same way,
            # so the loop's escalation to a retrain is the real exit
            self._restore_deltas(user_deltas, item_deltas, n_events,
                                 trace_ids)
            self.gate_rejects += 1
            self._c_gate_rejects.inc()
            if self.server is not None:
                self.server.note_publish_failure()
            self.last_report = report
            get_incidents().capture(
                "gate_rejected",
                "fold publish refused by quality gate(s): "
                + ", ".join(g["gate"] for g in gate_report["gates"]
                            if g["verdict"] == "fail"),
                context={"gateReport": gate_report, "events": n_events,
                         "baseInstance": getattr(self.instance, "id",
                                                 None)},
                trace_ids=(tick_trace.trace_id,) if tick_trace else ())
            raise GateRejected(gate_report)
        # the drift gate: the anchor is the first fold's loss
        losses = [r["loss"] for r in reports if r.get("loss") is not None]
        loss = max(losses) if losses else None
        report["loss"] = loss
        if loss is not None:
            self.last_loss = loss
            if self.anchor_loss is None:
                self.anchor_loss = loss
            elif loss > self.config.drift_ratio * self.anchor_loss:
                self.retrain_requested = True
                report["retrainRequested"] = True
                logger.warning(
                    "fold-in drift: loss %.5f > %.2f x anchor %.5f — "
                    "escalating to full retrain", loss,
                    self.config.drift_ratio, self.anchor_loss)
        report["anchorLoss"] = self.anchor_loss
        try:
            self._publish(new_models, report,
                          touched_entities={"user": touched_users,
                                            "item": touched_items})
        except Exception:
            # the served model never advanced: fold these events again
            self._restore_deltas(user_deltas, item_deltas, n_events,
                                 trace_ids)
            if self.server is not None:
                self.server.note_publish_failure()
            raise
        self.models = new_models
        self.fold_in_count += 1
        self.events_folded += n_events
        self._c_fold_events.inc(n_events)
        self._c_fold_h2d.inc(report["h2dBytes"])
        self.last_report = report
        return report

    def _restore_deltas(self, user_deltas, item_deltas, n_events: int,
                        trace_ids: Optional[Set[str]] = None) -> None:
        with self._lock:
            self._user_deltas = _merge([user_deltas, self._user_deltas])
            self._item_deltas = _merge([item_deltas, self._item_deltas])
            self._pending_events += n_events
            if trace_ids:
                self._pending_trace_ids |= trace_ids

    def _publish(self, models: Sequence[Any], report: dict,
                 touched_entities: Optional[dict] = None) -> None:
        """`touched_entities` ({"user": ids, "item": ids}): the rows the
        fold re-solved, handed to the attached server's swap so its
        result cache drops only their entries."""
        version = None
        if self.registry is not None:
            with self._lock:
                cursor = self._cursor
            meta = {"foldIn": report["foldIn"], "events": report["events"]}
            if cursor is not None:
                # a restarted follower resumes from the folded data's
                # horizon, not from the publish instant
                meta["cursor"] = cursor.isoformat()
            t0 = time.perf_counter()
            with TRACER.span("registry_publish"):
                version = self.registry.publish(
                    self.engine, self.engine_params, self.instance, models,
                    meta=meta)
            report["publishS"] = time.perf_counter() - t0
            TRACER.annotate(version=version)
            report["publishedVersion"] = version
        FLIGHT.record("fold_publish", model_version=version,
                      events=report["events"], foldIn=report["foldIn"],
                      readPath=report.get("readPath"))
        if self.server is not None:
            with TRACER.span("hot_swap", version=version or ""):
                self.server.swap_models(models, version=version,
                                        fold_in_events=report["events"],
                                        touched_entities=touched_entities)
        if self.reload_url is not None:
            t0 = time.perf_counter()
            with TRACER.span("reload", url=self.reload_url):
                try:
                    # the deployed server adopts the tick's trace id, so
                    # its hot_swap record joins this trace
                    req = urllib.request.Request(
                        self.reload_url, method="POST", data=b"",
                        headers=trace_context_headers())
                    urllib.request.urlopen(req, timeout=120).read()
                    report["reloaded"] = True
                except Exception as e:
                    report["reloaded"] = False
                    logger.error("POST %s failed: %s", self.reload_url, e)
            report["reloadS"] = time.perf_counter() - t0

    # -- tick and loop -----------------------------------------------------
    def tick(self, force: bool = False) -> Optional[dict]:
        """One step: tail, then fold if a threshold fired (or `force`).
        Returns the fold report (its `tickS` the step's wall time), or
        None when no fold ran. A tick that saw fresh events or folded is
        a `fold_tick` trace; an idle one is discarded, so the poll loop
        does not flood the ring. A tenant's tick runs under its scope."""
        with tenant_scope(self.tenant):
            return self._tick_inner(force)

    def _tick_inner(self, force: bool) -> Optional[dict]:
        t0 = time.perf_counter()
        with TRACER.trace("fold_tick") as tr:
            with TRACER.span("tail_read") as sp:
                fresh = self.poll_events()
                if sp is not None:
                    sp.attrs["freshEvents"] = fresh
            tr.discard = fresh == 0    # kept only if a fold runs below
            if self.retrain_requested and not force:
                return None    # drifted: wait for the retrain
            if not (force or self.should_fold()) \
                    or self.pending_deltas() == 0:
                return None
            tr.discard = False
            report = self.fold_in()
            tr.root.attrs["events"] = report["events"]
        report["tickS"] = time.perf_counter() - t0
        self._h_tick.observe(report["tickS"])
        # the process's device time by executable label so far, the
        # fold's sampled CUDA-event time (`fold_side`) among it
        costmon.flush()
        report["deviceTime"] = {
            "seconds": costmon.device_time_by_executable(),
            "samples": costmon.device_samples_by_executable()}
        return report

    def start(self) -> "DeltaTrainingScheduler":
        """Tick on a background thread every `poll_interval_s`; failures
        back off, and `max_tick_failures` in a row ask for a retrain
        (`retrain_requested`, which `stats()` shows and `update --follow`
        exits on). An open tail breaker waits for its probe and counts
        toward nothing."""
        if self._thread is not None:
            return self
        self._stop.clear()
        # a following scheduler is a fleet member (no port): its
        # liveness shows in `fleet status` and guards its flight files
        self._fleet_id = fleet.register_member("scheduler")

        def loop():
            cfg = self.config
            delay = cfg.poll_interval_s
            while not self._stop.wait(delay):
                try:
                    if self._tick_gate is not None:
                        with self._tick_gate.turn(self.tenant or ""):
                            self.tick()
                    else:
                        self.tick()
                    self.consecutive_failures = 0
                    self.last_error = None
                    delay = cfg.poll_interval_s
                except CircuitOpenError as e:
                    self.last_error = str(e)
                    delay = min(max(e.retry_after_s, cfg.poll_interval_s),
                                cfg.failure_backoff_cap_s)
                    logger.warning("scheduler tail breaker open; next "
                                   "probe in %.1fs", delay)
                except Exception as e:
                    self.last_error = str(e)
                    self._c_tick_failures.inc()
                    if self._tail_breaker.state != CLOSED:
                        # a store outage: the breaker's cadence owns it
                        delay = max(cfg.poll_interval_s,
                                    min(cfg.tail_breaker_reset_s,
                                        cfg.failure_backoff_cap_s))
                        logger.warning(
                            "scheduler tail read failed and the breaker "
                            "is %s; next attempt in %.1fs",
                            self._tail_breaker.state, delay)
                        continue
                    self.consecutive_failures += 1
                    delay = min(cfg.poll_interval_s
                                * (2 ** self.consecutive_failures),
                                cfg.failure_backoff_cap_s)
                    logger.exception("scheduler tick failed (%d "
                                     "consecutive)",
                                     self.consecutive_failures)
                    if (self.consecutive_failures >= cfg.max_tick_failures
                            and not self.retrain_requested):
                        self.retrain_requested = True
                        logger.error("scheduler: %d consecutive tick "
                                     "failures — escalating to full "
                                     "retrain", self.consecutive_failures)
                        FLIGHT.record("retrain_escalation",
                                      failures=self.consecutive_failures,
                                      lastError=self.last_error)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pio-delta-scheduler")
        self._thread.start()
        return self

    def stop(self) -> None:
        fleet.deregister_member(self._fleet_id)
        self._fleet_id = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def note_canary_decision(self, decision: dict) -> None:
        """The attached server's canary watchdog decided. A promote pins
        the version last-good (the durable rollback target). A rollback
        means the fold's lineage made a model that serves badly where the
        gates could not see it: re-anchor on what the server serves, ask
        for a retrain, and demote the version so no `/reload` or restart
        deploys it."""
        version = decision.get("candidateVersion")
        if decision.get("decision") == "promote":
            if self.registry is not None and version:
                inst = self.instance
                try:
                    self.registry.pin_last_good(
                        inst.engine_id, inst.engine_version,
                        inst.engine_variant, version)
                except Exception:
                    logger.exception("last-good pin failed")
            return
        if decision.get("decision") == "rollback":
            if self.server is not None:
                self.models = list(self.server.models)
            self.retrain_requested = True
            if self.registry is not None and version:
                try:
                    self.registry.demote_version(version)
                except Exception:
                    logger.exception("demoting %s failed", version)
            logger.error(
                "canary rollback of %s (%s): scheduler re-anchored on "
                "the serving models and escalated to a full retrain",
                version, decision.get("reason"))

    def stats(self) -> dict:
        with self._lock:
            pending = self._pending_events
            cursor = self._cursor
        return {
            "foldIns": self.fold_in_count,
            "eventsFolded": self.events_folded,
            "pendingEvents": pending,
            "cursor": cursor.isoformat() if cursor else None,
            "anchorLoss": self.anchor_loss,
            "lastLoss": self.last_loss,
            "retrainRequested": self.retrain_requested,
            "consecutiveFailures": self.consecutive_failures,
            "lastError": self.last_error,
            "tailBreaker": self._tail_breaker.state,
            "gateRejects": self.gate_rejects,
        }


def attach_scheduler(server, config: SchedulerConfig, registry=None,
                     **kw) -> DeltaTrainingScheduler:
    """A scheduler bound to a loaded in-process `EngineServer`: engine,
    params, instance and live models come from the server, every fold
    hot-swaps it, and its canary verdicts come back to the scheduler."""
    if not server.algorithms:
        raise RuntimeError("server has no engine loaded; call load() first")
    sched = DeltaTrainingScheduler(
        engine=server.engine, engine_params=server.engine_params,
        instance=server.engine_instance, algorithms=server.algorithms,
        models=server.models, config=config, server=server,
        registry=registry, **kw)
    server.on_canary_decision = sched.note_canary_decision
    return sched
