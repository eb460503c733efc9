"""Flight recorder: a bounded, crash-safe lifecycle log of wide events.

The port's copy of `predictionio_tpu/obs/flight.py` (`FlightRecorder`,
`FLIGHT`, `get_flight`, `flight_response`). Traces answer "what happened
inside this request" and counters "how often"; the flight recorder
answers "what was the system doing around the time the rollback fired".
Every lifecycle transition (train start and end, the first model load
(`model_load`) and every replacement after it (`hot_swap`), the deploy's
warm-up (`aot_warm`), fold publishes, gate verdicts, canary promote and
rollback, sentinel breaches, sheds, slow queries) lands as one wide JSON
record stamped with the current trace id, the serving model version when
the caller knows it, and the deltas of a small watched metric set since
the previous record.

Two sinks:

- an in-memory ring (`snapshot()`/`tail()`) serving `GET /flight.json`
  on both HTTP servers and feeding incident bundles (`obs/incidents.py`),
  always on, never blocking;
- a size-rotated JSONL directory under `base_dir()/flight/` written by
  one background thread through a bounded hand-off queue.

`record()` never blocks, never raises and never fsyncs. A full hand-off
queue drops the record for the disk sink (counted in
`pio_flight_dropped_total`) while the ring keeps it, so a saturated or
dead disk costs serving nothing. Per-event kinds (`shed`, `slow_query`)
coalesce: the first record of a burst is emitted and the next emission
carries `coalesced=<suppressed count>`.

Each process rotates and retains its own files (`flight-<pid>-N.jsonl`);
a dead process's files are retired by the `os.kill` liveness probe (the
reference also asks its fleet registry, which the port does not have
yet).
"""

from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

#: metric families whose deltas are stamped onto each record — the
#: "what moved since the last transition" context an operator reads
#: first. Resolved across every registered source registry (the process
#: registry plus each server's child), missing names simply absent.
DEFAULT_WATCHED = (
    "pio_engine_requests_total",
    "pio_fold_events_total",
    "pio_fold_tick_failures_total",
    "pio_ingest_spilled_total",
    "pio_guard_gate_rejects_total",
    "pio_guard_rollbacks_total",
    "pio_jax_compiles_total",
)


def _pid_alive(pid: Optional[int]) -> bool:
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True   # EPERM: exists, owned by someone else
    return True


def _pid_is_live(pid: Optional[int]) -> bool:
    """Liveness for the foreign-series GC: the `os.kill` probe."""
    return _pid_alive(pid)


def _sum_samples(family) -> Optional[float]:
    """Scalar value of a family: sum of its (labeled) samples. None for
    histograms/summaries (deltas of those mean nothing as one number)."""
    if family is None or getattr(family, "mtype", None) not in (
            "counter", "gauge"):
        return None
    try:
        return float(sum(v for _, v in family.samples()))
    except Exception:
        return None


class FlightRecorder:
    """Process-wide lifecycle recorder. All public methods are safe to
    call from any thread, including under other subsystems' locks —
    nothing on the record() path blocks on I/O; the locks it takes
    guard bounded in-memory work only."""

    def __init__(self, ring_capacity: int = 2048,
                 queue_capacity: int = 4096,
                 max_file_bytes: int = 4 << 20,
                 max_files: int = 4,
                 flight_dir: Optional[str] = None,
                 watched=DEFAULT_WATCHED,
                 metric_min_interval_s: float = 0.01):
        self._lock = threading.Lock()
        self._metrics_lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=ring_capacity)
        self._seq = itertools.count(1)
        self._q: "queue.Queue[str]" = queue.Queue(maxsize=queue_capacity)
        self._writer: Optional[threading.Thread] = None
        self._writer_lock = threading.Lock()
        self._stop = threading.Event()
        self.max_file_bytes = max_file_bytes
        self.max_files = max_files
        self._dir_override = flight_dir
        self.watched = tuple(watched)
        # registries to resolve watched metric names from; the process
        # registry is implicit, servers add their child registries
        self._sources: List[object] = []
        self._last_vals: Dict[str, float] = {}
        self._last_metrics_t = 0.0
        self._metric_min_interval_s = metric_min_interval_s
        # per-kind coalescing state: kind -> (last emit t, suppressed)
        self._coalesce: Dict[str, tuple] = {}
        # self-accounting: dropped disk records, cumulative record()
        # wall (the bench's obs-overhead numerator), write errors
        self.dropped = 0
        self.write_errors = 0
        self.records = 0
        self.coalesced = 0
        self.spent_s = 0.0
        self._registered = False
        # register the self-metrics NOW, not at first disk write: a
        # process that never enqueues (PIO_FLIGHT=off, or ring-only
        # use) must still scrape pio_flight_* as 0, not absent —
        # absent is indistinguishable from the recorder being broken.
        # counter_func is first-registrant-wins, so the module-import
        # singleton owns the families and later instances no-op.
        self._register_metrics()

    # -- configuration -------------------------------------------------
    def add_source(self, registry):
        """Let watched-metric resolution see ``registry`` (a server's
        child registry). Held by WEAKREF — the process-lifetime
        singleton must not pin dead servers' registries (their func
        collectors capture the server) — and resolved newest-first, so
        a restarted server's fresh registry wins over a replaced one."""
        import weakref
        with self._lock:
            self._sources = [r for r in self._sources
                             if r() is not None and r() is not registry]
            self._sources.append(weakref.ref(registry))

    def _live_sources(self):
        """Live source registries, newest first."""
        with self._lock:
            refs = list(self._sources)
        return [reg for reg in (r() for r in reversed(refs))
                if reg is not None]

    def configure(self, flight_dir: Optional[str] = None,
                  max_file_bytes: Optional[int] = None,
                  max_files: Optional[int] = None):
        """Test/operator hook; takes effect at the next rotation."""
        if flight_dir is not None:
            self._dir_override = flight_dir
        if max_file_bytes is not None:
            self.max_file_bytes = max_file_bytes
        if max_files is not None:
            self.max_files = max_files

    def _register_metrics(self):
        if self._registered:
            return
        self._registered = True
        from predictionio_tpu_torch.obs.metrics import get_registry
        reg = get_registry()
        reg.counter_func(
            "pio_flight_records_total",
            "Lifecycle records accepted by the flight recorder",
            lambda: self.records)
        reg.counter_func(
            "pio_flight_dropped_total",
            "Flight records dropped by the disk sink (hand-off queue "
            "full); the in-memory ring kept them",
            lambda: self.dropped)
        reg.counter_func(
            "pio_flight_write_errors_total",
            "Flight-file write/rotate failures (records dropped on "
            "disk, kept in the ring)",
            lambda: self.write_errors)
        reg.counter_func(
            "pio_flight_coalesced_total",
            "Per-event flight records (spill/shed) suppressed into "
            "their burst's next emitted record's coalesced count",
            lambda: self.coalesced)

    def flight_dir(self) -> str:
        if self._dir_override:
            return self._dir_override
        env = os.environ.get("PIO_FLIGHT_DIR")
        if env:
            return env
        from predictionio_tpu_torch.data.storage.registry import base_dir
        return os.path.join(base_dir(), "flight")

    # -- the one entry point -------------------------------------------
    def record(self, kind: str, model_version: Optional[str] = None,
               coalesce_s: Optional[float] = None,
               **fields) -> Optional[dict]:
        """Append one wide event. Returns the record dict, or None when
        recording itself failed (never raises into the caller).

        ``coalesce_s`` is for per-event/per-request kinds (ingest
        spill, query shed) that fire thousands of times per second
        during exactly the outages the ring exists to narrate: the
        first record of a burst is emitted immediately, later ones
        inside the window are suppressed (their fields dropped), and
        the next emission carries ``coalesced=<suppressed count>``.
        Every other kind is transition-granularity and records
        unconditionally."""
        t0 = time.perf_counter()
        try:
            if coalesce_s:
                pending = 0
                with self._lock:
                    last, n = self._coalesce.get(kind, (0.0, 0))
                    now = time.monotonic()
                    if now - last < coalesce_s:
                        self._coalesce[kind] = (last, n + 1)
                        self.coalesced += 1
                        return None
                    self._coalesce[kind] = (now, 0)
                    pending = n
                if pending:
                    fields["coalesced"] = pending
            rec = self._build(kind, model_version, fields)
            # += on an attribute is LOAD/ADD/STORE — concurrent
            # recorders would lose increments, so the self-accounting
            # counters ride the ring lock
            with self._lock:
                self._ring.append(rec)
                self.records += 1
            if os.environ.get("PIO_FLIGHT", "").strip().lower() \
                    not in ("off", "0", "false"):
                self._enqueue(rec)
            return rec
        except Exception:
            logger.debug("flight record failed", exc_info=True)
            return None
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.spent_s += dt

    def _build(self, kind, model_version, fields) -> dict:
        from predictionio_tpu_torch.obs.tenantctx import current_tenant
        from predictionio_tpu_torch.obs.trace import TRACER
        rec = {"seq": next(self._seq), "t": time.time(), "kind": kind}
        tid = TRACER.current_trace_id()
        if tid:
            rec["traceId"] = tid
        if model_version is not None:
            rec["modelVersion"] = model_version
        # tenant attribution: a record emitted inside a
        # tenant scope carries the id; an explicit tenant= field
        # (tenant_admitted/eviction records) wins below
        ten = current_tenant()
        if ten is not None:
            rec["tenant"] = ten
        if fields:
            rec.update(fields)
        deltas = self._metric_deltas()
        if deltas:
            rec["metrics"] = deltas
        return rec

    def _metric_deltas(self) -> Dict[str, float]:
        """Deltas of the watched families since the last computation.
        Recomputed at most every ``metric_min_interval_s`` so a record
        flood (spill storm, shed storm) pays ring+queue cost only;
        records inside the interval carry NO metrics block — the
        movement lands, once, on the first record after it. Deltas
        along a flight chain therefore always sum to the true total
        (re-stamping the last deltas would show phantom movement).

        Serialized under ``_metrics_lock``: record() is called
        concurrently from request, ingest, and scheduler threads, and
        two interleaved read-modify-writes of ``_last_vals`` would
        stamp the same movement onto two records or lose it entirely.
        The work under the lock is bounded in-memory reads — no I/O."""
        with self._metrics_lock:
            now = time.monotonic()
            if now - self._last_metrics_t < self._metric_min_interval_s:
                return {}
            self._last_metrics_t = now
            from predictionio_tpu_torch.obs.metrics import get_registry
            sources = self._live_sources()
            sources.append(get_registry())
            out: Dict[str, float] = {}
            for name in self.watched:
                val = None
                for src in sources:
                    try:
                        val = _sum_samples(src.get(name))
                    except Exception:
                        val = None
                    if val is not None:
                        break
                if val is None:
                    continue
                prev = self._last_vals.get(name)
                self._last_vals[name] = val
                if prev is not None and val != prev:
                    out[name] = round(val - prev, 6)
            return out

    # -- disk sink ------------------------------------------------------
    def _enqueue(self, rec: dict):
        self._ensure_writer()
        try:
            self._q.put_nowait(json.dumps(rec, default=str,
                                          separators=(",", ":")))
        except queue.Full:
            with self._lock:
                self.dropped += 1

    def _ensure_writer(self):
        if self._writer is not None and self._writer.is_alive():
            return
        with self._writer_lock:
            if self._writer is not None and self._writer.is_alive():
                return
            self._register_metrics()
            self._stop.clear()
            self._writer = threading.Thread(
                target=self._write_loop, daemon=True,
                name="pio-flight-writer")
            self._writer.start()

    def _write_loop(self):
        fh = None
        path = None
        while not self._stop.is_set():
            try:
                line = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [line]
            # drain opportunistically: one write + one flush per batch
            # is what keeps the writer ahead of lifecycle-rate traffic
            while len(batch) < 256:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            try:
                if fh is None or fh.closed \
                        or fh.tell() >= self.max_file_bytes:
                    fh, path = self._rotate(fh)
                fh.write("\n".join(batch) + "\n")
                fh.flush()   # page cache only — fsync-light by contract
            except Exception:
                # same lock as dropped/spent_s: the self-accounting
                # counters are read-modify-written from several threads
                with self._lock:
                    self.write_errors += 1
                try:
                    if fh is not None:
                        fh.close()
                except Exception:
                    pass
                fh = None   # reopen (and re-resolve the dir) next batch
        if fh is not None:
            try:
                fh.close()
            except Exception:
                pass

    def _rotate(self, old_fh):
        if old_fh is not None and not old_fh.closed:
            old_fh.close()
        d = self.flight_dir()
        os.makedirs(d, exist_ok=True)
        # files are named flight-<pid>-NNNNNN.jsonl: the event server
        # and engine server normally share base_dir(), and one writer
        # adopting or retiring another live process's open file would
        # tear lines / lose that process's records to an unlinked
        # inode with no drop accounting. Each process rotates and
        # retains ONLY its own series.
        prefix = f"flight-{os.getpid()}-"
        all_files = [f for f in os.listdir(d)
                     if f.startswith("flight-") and f.endswith(".jsonl")]
        own = sorted(f for f in all_files if f.startswith(prefix))
        nxt = 1
        if own:
            try:
                nxt = int(own[-1][len(prefix):-len(".jsonl")]) + 1
            except ValueError:
                nxt = len(own) + 1
        # adopt our own non-full newest file (writer restarts and
        # write-error reopens land here repeatedly; JSONL readers skip
        # a torn last line)
        path = os.path.join(d, own[-1]) if own else None
        creating_new = (path is None
                        or os.path.getsize(path) >= self.max_file_bytes)
        if creating_new:
            path = os.path.join(d, f"{prefix}{nxt:06d}.jsonl")
        # retention counts the file we are about to open: adopting an
        # existing file must not cost a history file
        total = len(own) + (1 if creating_new else 0)
        for stale in own[:max(0, total - self.max_files)]:
            try:
                os.remove(os.path.join(d, stale))
            except OSError:
                pass
        self._retire_foreign(
            d, [f for f in all_files if not f.startswith(prefix)])
        return open(path, "a", encoding="utf-8"), path

    @staticmethod
    def _file_pid(name: str) -> Optional[int]:
        parts = name[len("flight-"):-len(".jsonl")].split("-")
        if len(parts) == 2:
            try:
                return int(parts[0])
            except ValueError:
                return None
        return None   # legacy flight-NNNNNN.jsonl: no owner

    def _retire_foreign(self, d: str, others: List[str]):
        """Bound files no LIVE process owns (dead pids, legacy names):
        keep the newest ``max_files`` so post-crash history stays
        readable, delete older. Ranked by mtime — filename order would
        rank by pid string, and a just-crashed process's series (the
        history worth keeping) can carry a lexicographically smaller
        pid than last week's. A live process's series is never
        touched — it retains its own."""
        dead = [f for f in others
                if not _pid_is_live(self._file_pid(f))]
        if len(dead) <= self.max_files:
            return

        def mtime(name):
            try:
                return os.path.getmtime(os.path.join(d, name))
            except OSError:
                return 0.0

        dead.sort(key=mtime)   # oldest first
        for stale in dead[:len(dead) - self.max_files]:
            try:
                os.remove(os.path.join(d, stale))
            except OSError:
                pass

    # -- reads ----------------------------------------------------------
    def snapshot(self, limit: int = 100, kind: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 tenant: Optional[str] = None) -> List[dict]:
        """Newest-first records from the ring, optionally filtered.
        The ``tenant`` filter keeps that tenant's records PLUS
        untenanted (shared-device) ones — the slice a tenant-scoped
        incident bundle wants."""
        with self._lock:
            recs = list(self._ring)
        if kind is not None:
            recs = [r for r in recs if r.get("kind") == kind]
        if trace_id is not None:
            recs = [r for r in recs if r.get("traceId") == trace_id]
        if tenant is not None:
            recs = [r for r in recs
                    if r.get("tenant") in (tenant, None)]
        recs.reverse()
        return recs[:max(0, int(limit))]

    def tail(self, n: int = 200) -> List[dict]:
        """The last ``n`` records in arrival order (incident bundles)."""
        with self._lock:
            recs = list(self._ring)
        return recs[-max(0, int(n)):]

    def flush(self, timeout_s: float = 2.0) -> bool:
        """Wait for the disk queue to drain (tests); True when empty."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._q.empty():
                time.sleep(0.05)   # let the in-flight batch hit the file
                return True
            time.sleep(0.01)
        return False

    def close(self):
        self._stop.set()
        w = self._writer
        if w is not None:
            w.join(timeout=2.0)
        self._writer = None


# The process-wide recorder (module import = process singleton).
FLIGHT = FlightRecorder()


def get_flight() -> FlightRecorder:
    return FLIGHT


def flight_response(params: dict) -> dict:
    """Shared ``GET /flight.json`` handler body for both HTTP servers:
    ``?n=``/``?limit=`` (default 100), ``?kind=``, ``?trace_id=``,
    ``?tenant=`` (that tenant's records plus untenanted ones)."""
    limit = int(params.get("n", params.get("limit", 100)))
    return {"records": FLIGHT.snapshot(
        limit=limit, kind=params.get("kind"),
        trace_id=params.get("trace_id") or params.get("traceId"),
        tenant=params.get("tenant")),
        "dropped": FLIGHT.dropped}
