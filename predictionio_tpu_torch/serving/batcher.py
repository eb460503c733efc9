"""Micro-batching for the query path.

The port's counterpart of `predictionio_tpu/serving/batcher.py`
(`ShedError`, `ShutdownError`, `MicroBatcher` with `submit`,
`_target_batch`, `_window_deadline`, `_loop`, `_dispatch_pipelined`,
`_completion_loop`, `_finish_one`, `_run_batch`, `stop`, `stats`,
`queue_wait_bound_s`). Concurrent queries that arrive within a short
window are coalesced into one batched device call and the results are
fanned back out.

Coalescing is drain-first: each dispatch takes everything that queued
while the previous window was on the device, so batches grow with load.
The door is held open (up to `max_wait_ms`) only while more queries are
known to be in flight (submitted, not yet dispatched, not in this batch)
than the batch holds; a lone closed-loop client and an idle server
dispatch at once and pay no window. `latency_budget_ms`, when set, caps
how long the oldest query may sit in the coalescing stage.

Pipelined executor: with `process_batch_begin` and `inflight` > 1
(`PIO_SERVE_INFLIGHT`, default 2) the formation thread forms window N+1
and enqueues its device work (and the copy of its result, see
`ops/readback.py`) while window N's work is still on the device, and a
completion thread waits for window N's result, builds its answers and
wakes its waiters. A semaphore caps the windows between dispatch and
completion at `inflight`; formation blocks on it (counted as a stall).

Adaptive sizing: each window derives a pow2 target from the known demand
(undispatched and queued queries) and aims one bucket higher when the
device is busy; the straggler hold scales with device occupancy and queue
depth. `_occupancy()` reads `obs/costmon.occupancy()`, the EWMA of the
device time the serve dispatches book from CUDA events, as the
reference's reads its cost monitor.

Deadline shedding: `submit(deadline_s=)` refuses a query whose deadline
the queue's wait bound already exceeds (`ShedError`, 503 + Retry-After).
`stop()` completes the windows already dispatched and fails every queued
query loudly (`ShutdownError`). With a `metrics` registry (the engine
server's) the counters are also mounted as the reference's families
(`pio_engine_batch*`, `pio_engine_shed_total`, `pio_serve_*`) and the
per-query coalescing wait and per-window stage seconds are histograms.

Tracing: `submit` records the calling thread's trace (the query's
ingress trace) and waits under a `batch_wait` span; a window whose
members carry traces runs under a `batch_predict` trace of its own
(`formationMs`, and `completionWaitMs` on the pipelined path), linked
both ways to its members' traces, begun on the formation thread and
resumed and committed by the completion thread. A shed query leaves a
coalesced `shed` flight record, and the admission lock's waits go into
`pio_lock_wait_seconds{lock="batcher_inflight"}`. The reference's tenant
scopes belong to a later slice.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Any, Callable, Optional

from predictionio_tpu_torch.compile.buckets import bucket_batch
from predictionio_tpu_torch.obs.flight import FLIGHT
from predictionio_tpu_torch.obs.slo import lock_probe, timed_acquire
from predictionio_tpu_torch.obs.trace import TRACER
from predictionio_tpu_torch.ops import readback

logger = logging.getLogger(__name__)

#: the per-window stages `stats()["stageSeconds"]` sums: formation (first
#: dequeue -> dispatch), dispatch (the begin call: host prep + enqueue),
#: completion_wait (dispatched -> completion thread pickup), readback
#: (blocked on the window's copy) and completion (answers + wakeup, less
#: the readback)
STAGES = ("formation", "dispatch", "completion_wait", "readback",
          "completion")


def _inflight_default() -> int:
    """Dispatched-not-completed window cap (`PIO_SERVE_INFLIGHT`)."""
    try:
        return max(1, int(os.environ.get("PIO_SERVE_INFLIGHT", 2)))
    except (TypeError, ValueError):
        return 2


#: device occupancy at or above which the adaptive target aims one bucket
#: higher (the reference's default)
ADAPT_OCC = 0.4


class ShedError(RuntimeError):
    """Load shed: the queue's wait bound exceeds the request's deadline.
    `retry_after_s` is that bound, the earliest a retry could be
    served."""

    http_status = 503

    def __init__(self, wait_bound_s: float, deadline_s: float):
        super().__init__(
            f"overloaded: queue wait bound {wait_bound_s * 1000:.0f}ms "
            f"exceeds request deadline {deadline_s * 1000:.0f}ms")
        self.retry_after_s = wait_bound_s


class ShutdownError(RuntimeError):
    """The micro-batcher is stopping; queued requests fail explicitly
    instead of hanging."""

    http_status = 503

    def __init__(self, message: str = "server shutting down"):
        super().__init__(message)


class _Pending:
    __slots__ = ("query", "event", "result", "error", "t_enqueue",
                 "trace_id", "batch_trace_id")

    def __init__(self, query):
        self.query = query
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_enqueue = time.perf_counter()
        # the submitting thread's trace; the window's batch_predict
        # trace links it (and back)
        self.trace_id: Optional[str] = None
        self.batch_trace_id: Optional[str] = None


class _InFlight:
    """One dispatched-not-completed window: its members, its deferred
    finish(), its open batch_predict trace, and when it was dispatched
    and handed over."""

    __slots__ = ("batch", "finish", "trace", "t_dispatch", "t_ready")

    def __init__(self, batch, finish, trace, t_dispatch):
        self.batch = batch
        self.finish = finish
        self.trace = trace
        self.t_dispatch = t_dispatch
        self.t_ready = time.perf_counter()


class MicroBatcher:
    def __init__(self, process_batch, max_batch: int = 32,
                 max_wait_ms: float = 5.0,
                 latency_budget_ms: Optional[float] = None,
                 process_batch_begin: Optional[Callable] = None,
                 inflight: Optional[int] = None,
                 adaptive: bool = True, metrics=None):
        """process_batch: fn(List[query]) -> List[result].
        `process_batch_begin`: fn(List[query]) -> finish() -> results,
        the two-stage split the pipelined executor runs (with `inflight`
        > 1). `metrics`: a registry to mount the counters on."""
        self.process_batch = process_batch
        self.process_batch_begin = process_batch_begin
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.latency_budget_s = (latency_budget_ms / 1000.0
                                 if latency_budget_ms is not None else None)
        self.inflight = max(1, int(inflight) if inflight is not None
                            else _inflight_default())
        self.pipelined = (process_batch_begin is not None
                          and self.inflight > 1)
        self.adaptive = bool(adaptive)
        self.n_batches = 0
        self.n_queries = 0
        self.max_batch_seen = 0
        # dispatches that never held the window for a straggler
        self.n_immediate = 0
        # why each dispatch closed its batch: full (max_batch), drain
        # gate (every undispatched query is in it), window (the hold
        # expired), adaptive (the pow2 demand target was reached)
        self.n_exit_full = 0
        self.n_exit_drain_gate = 0
        self.n_exit_window = 0
        self.n_exit_adaptive = 0
        self.inflight_at_dispatch_sum = 0
        self.stage_s = dict.fromkeys(STAGES, 0.0)
        # queries submitted and not yet answered
        self._inflight = 0
        # queries submitted and not yet taken into a dispatched batch:
        # the hold's signal (members of windows awaiting completion are
        # in flight but are not coming to this window)
        self._undispatched = 0
        # windows dispatched and not yet completed
        self._inflight_batches = 0
        self._flight_lock = threading.Lock()
        # EWMA of a window's service time, the queue wait bound's basis
        self._service_ewma_s = 0.0
        self.n_shed = 0
        self.n_shutdown_failed = 0
        # formation blocked on the in-flight cap (backpressure)
        self.n_pipeline_stalls = 0
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._lock_wait = lock_probe("batcher_inflight")
        self.wait_hist = None
        self.stage_hist = None
        if metrics is not None:
            self._register_metrics(metrics)
        self._stop = threading.Event()
        self._inflight_sem = threading.Semaphore(self.inflight)
        self._completions: "queue.Queue[Optional[_InFlight]]" = \
            queue.Queue()
        self._completion_thread = None
        if self.pipelined:
            self._completion_thread = threading.Thread(
                target=self._completion_loop, daemon=True,
                name="pio-serve-completion")
            self._completion_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pio-serve-formation")
        self._thread.start()

    def _register_metrics(self, metrics) -> None:
        self.wait_hist = metrics.histogram(
            "pio_engine_batch_wait_seconds",
            "Per-query time in the coalescing stage (enqueue -> dispatch)")
        self.stage_hist = metrics.histogram(
            "pio_serve_stage_seconds",
            "Per-window wall time by pipeline stage (formation = first "
            "dequeue -> dispatch, dispatch = the begin call, "
            "completion_wait = dispatched -> completion thread pickup, "
            "readback = blocked on the window's copy, completion = "
            "answers + wakeup less the readback)",
            labelnames=("stage",))
        for st in STAGES:
            self.stage_hist.labels(stage=st)
        metrics.counter_func("pio_engine_batches_total",
                             "Micro-batch dispatches",
                             lambda: self.n_batches)
        metrics.counter_func("pio_engine_batched_queries_total",
                             "Queries through the micro-batcher",
                             lambda: self.n_queries)
        metrics.counter_func("pio_engine_immediate_batches_total",
                             "Dispatches that never blocked on the window",
                             lambda: self.n_immediate)
        metrics.gauge_func("pio_engine_max_batch_size",
                           "Largest coalesced batch",
                           lambda: self.max_batch_seen)
        metrics.counter_func(
            "pio_engine_batch_exits_total",
            "Why each dispatch closed its batch (drain_gate = the client "
            "pool was the limit, window = straggler hold expired, full = "
            "max_batch hit, adaptive = pow2 demand target reached)",
            lambda: [({"reason": "full"}, self.n_exit_full),
                     ({"reason": "drain_gate"}, self.n_exit_drain_gate),
                     ({"reason": "window"}, self.n_exit_window),
                     ({"reason": "adaptive"}, self.n_exit_adaptive)])
        metrics.gauge_func(
            "pio_engine_avg_inflight_at_dispatch",
            "Mean submitted-unanswered queries at dispatch (the effective "
            "concurrent-client count)",
            lambda: round(self.inflight_at_dispatch_sum / self.n_batches, 3)
            if self.n_batches else 0.0)
        metrics.counter_func(
            "pio_engine_shed_total",
            "Queries refused at admission because the queue wait bound "
            "exceeded their deadline (503 + Retry-After)",
            lambda: self.n_shed)
        metrics.gauge_func(
            "pio_engine_queue_wait_bound_seconds",
            "Current admission-time wait bound (queue depth x EWMA batch "
            "service time + window)", lambda: self.queue_wait_bound_s())
        metrics.gauge_func(
            "pio_serve_inflight_batches",
            "Windows dispatched to the device and not yet completed "
            "(bounded by PIO_SERVE_INFLIGHT)",
            lambda: self._inflight_batches)
        metrics.counter_func(
            "pio_serve_pipeline_stalls_total",
            "Formation blocked on the in-flight window cap (backpressure: "
            "device or completion is the bottleneck)",
            lambda: self.n_pipeline_stalls)

    def _stage(self, name: str, seconds: float) -> None:
        self.stage_s[name] += seconds
        if self.stage_hist is not None:
            self.stage_hist.labels(stage=name).observe(seconds)

    def stats(self) -> dict:
        # queries read before batches: the derived average stays <=
        # max_batch even when a window lands mid-read
        nq = self.n_queries
        nb = self.n_batches
        return {"batches": nb, "batchedQueries": nq,
                "avgBatchSize": (nq / nb if nb else 0.0),
                "maxBatchSize": self.max_batch_seen,
                "immediateBatches": self.n_immediate,
                "exitFullBatch": self.n_exit_full,
                "exitDrainGate": self.n_exit_drain_gate,
                "exitWindow": self.n_exit_window,
                "exitAdaptive": self.n_exit_adaptive,
                "shedQueries": self.n_shed,
                "queueWaitBoundSec": self.queue_wait_bound_s(),
                "pipelined": self.pipelined,
                "inflightWindows": self.inflight,
                "inflightBatches": self._inflight_batches,
                "pipelineStalls": self.n_pipeline_stalls,
                "avgInflightAtDispatch": (
                    self.inflight_at_dispatch_sum / nb if nb else 0.0),
                "stageSeconds": dict(self.stage_s)}

    def queue_wait_bound_s(self) -> float:
        """Upper bound on how long a query enqueued now waits before its
        window dispatches: one EWMA service time for each window ahead
        (queued or on the device) plus one coalescing window; 0 for an
        idle batcher. The admission signal and the Retry-After value."""
        depth = self._q.qsize()
        if self.pipelined:
            busy = self._inflight_batches
        else:
            busy = 1 if self._inflight > depth else 0
        batches_ahead = (depth + self.max_batch - 1) // self.max_batch \
            + busy
        if batches_ahead == 0:
            return 0.0
        ewma = self._service_ewma_s
        if self.pipelined:
            # dispatch -> completion already includes the wait behind the
            # other windows in flight
            ewma /= max(self.inflight, 1)
        return batches_ahead * ewma + self.max_wait_s

    def submit(self, query, deadline_s: Optional[float] = None) -> Any:
        """Blocking: enqueue and wait for the batched result. A query
        whose `deadline_s` the queue's wait bound already exceeds is shed
        at admission (`ShedError`)."""
        if deadline_s is not None:
            bound = self.queue_wait_bound_s()
            if bound > deadline_s:
                self.n_shed += 1
                FLIGHT.record("shed", coalesce_s=1.0,
                              waitBoundS=round(bound, 4),
                              deadlineS=round(deadline_s, 4))
                raise ShedError(bound, deadline_s)
        p = _Pending(query)
        p.trace_id = TRACER.current_trace_id()
        with timed_acquire(self._flight_lock, self._lock_wait):
            # check-and-enqueue is atomic with stop()'s set-and-sweep
            if self._stop.is_set():
                raise ShutdownError("micro-batcher is shut down")
            self._inflight += 1
            self._undispatched += 1
            self._q.put(p)
        with TRACER.span("batch_wait"):
            p.event.wait()
        if p.batch_trace_id is not None:
            # the query's trace links the window that answered it (the
            # window linked the query before waking it)
            cur = TRACER.current_trace()
            if cur is not None:
                cur.link(p.batch_trace_id)
        if p.error is not None:
            raise p.error
        return p.result

    # -- adaptive sizing -----------------------------------------------------
    def _occupancy(self) -> float:
        """The device's busy share in [0, 1], from the cost monitor."""
        from predictionio_tpu_torch.obs import costmon
        return costmon.occupancy()

    def _target_batch(self) -> int:
        """The pow2 target for this window: cover the known demand, one
        bucket higher when the device is busy; never above max_batch."""
        demand = min(max(self._undispatched, self._q.qsize() + 1),
                     self.max_batch)
        if self._occupancy() >= ADAPT_OCC:
            demand = min(demand * 2, self.max_batch)
        return min(bucket_batch(max(demand, 1)), self.max_batch)

    def _window_deadline(self, t_first: float, first: _Pending) -> float:
        """The straggler hold's deadline: adaptive mode scales the window
        with device occupancy and queue depth; the latency budget caps
        the oldest query's time in the coalescing stage."""
        window_s = self.max_wait_s
        if self.adaptive:
            depth = self._q.qsize()
            scale = min(1.0, 0.25 + self._occupancy()
                        + depth / max(self.max_batch, 1))
            window_s = self.max_wait_s * scale
        deadline = t_first + window_s
        if self.latency_budget_s is not None:
            deadline = min(deadline,
                           first.t_enqueue + self.latency_budget_s)
        return deadline

    # -- formation loop -------------------------------------------------------
    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            t_first = time.perf_counter()
            batch = [first]
            held = False
            exit_reason = "full"   # the loop falls through at max_batch
            deadline = self._window_deadline(t_first, first)
            target = self._target_batch() if self.adaptive \
                else self.max_batch
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._q.get_nowait())
                    continue
                except queue.Empty:
                    pass
                if self._undispatched <= len(batch):
                    exit_reason = "drain_gate"
                    break          # nobody else known in flight
                if self.adaptive and len(batch) >= target:
                    exit_reason = "adaptive"
                    break          # the pow2 demand target is covered
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    exit_reason = "window"
                    break
                held = True
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    exit_reason = "window"
                    break
            self.n_batches += 1
            self.n_queries += len(batch)
            self.max_batch_seen = max(self.max_batch_seen, len(batch))
            self.inflight_at_dispatch_sum += self._inflight
            if exit_reason == "full":
                self.n_exit_full += 1
            elif exit_reason == "drain_gate":
                self.n_exit_drain_gate += 1
            elif exit_reason == "adaptive":
                self.n_exit_adaptive += 1
            else:
                self.n_exit_window += 1
            if not held:
                self.n_immediate += 1
            with self._flight_lock:
                self._undispatched -= len(batch)
            if self._stop.is_set():
                # stop landed while this batch was forming: fail it
                # rather than race the device call against shutdown
                self.n_shutdown_failed += len(batch)
                self._fail_batch(batch, ShutdownError())
                continue
            t_dispatch = time.perf_counter()
            if self.wait_hist is not None:
                for p in batch:
                    self.wait_hist.observe(t_dispatch - p.t_enqueue)
            self._stage("formation", t_dispatch - t_first)
            if self.pipelined:
                self._dispatch_pipelined(batch, t_first, t_dispatch)
                continue
            try:
                results = self._run_batch(batch, t_dispatch - t_first)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"batch handler returned {len(results)} results "
                        f"for {len(batch)} queries")
                with self._flight_lock:
                    self._inflight -= len(batch)
                for p, r in zip(batch, results):
                    p.result = r
                    p.event.set()
            except Exception as e:   # every waiter gets the error
                self._fail_batch(batch, e)
            self._note_service_time(time.perf_counter() - t_dispatch)

    def _note_service_time(self, dt: float):
        self._service_ewma_s = (dt if self._service_ewma_s == 0.0
                                else 0.8 * self._service_ewma_s + 0.2 * dt)

    def _fail_batch(self, batch, err: BaseException):
        with self._flight_lock:
            self._inflight -= len(batch)
        for p in batch:
            p.error = err
            p.event.set()

    # -- pipelined dispatch / completion --------------------------------------
    def _batch_trace(self, batch, formation_s: float, **attrs):
        """The window's batch_predict trace, begun (not current, not
        committed) and linked both ways to its members' traces; None
        when no member carries one."""
        members = [p.trace_id for p in batch if p.trace_id]
        if not members:
            return None
        bt = TRACER.begin_trace(
            "batch_predict", batch=len(batch),
            formationMs=round(formation_s * 1000.0, 3), **attrs)
        for tid in members:
            bt.link(tid)
        for p in batch:
            p.batch_trace_id = bt.trace_id
        return bt

    def _dispatch_pipelined(self, batch, t_first: float,
                            t_dispatch: float):
        """Enqueue the window's device work through `process_batch_begin`
        (under the window's batch_predict trace) and hand its finish()
        to the completion thread, after taking an in-flight slot
        (formation blocks here when completion lags)."""
        if not self._inflight_sem.acquire(blocking=False):
            self.n_pipeline_stalls += 1
            while not self._inflight_sem.acquire(timeout=0.1):
                if self._stop.is_set():
                    self.n_shutdown_failed += len(batch)
                    self._fail_batch(batch, ShutdownError())
                    return
        bt = self._batch_trace(batch, t_dispatch - t_first, pipelined=True)
        try:
            queries = [p.query for p in batch]
            if bt is not None:
                with TRACER.resume(bt):
                    finish = self.process_batch_begin(queries)
            else:
                finish = self.process_batch_begin(queries)
        except Exception as e:
            self._inflight_sem.release()
            if bt is not None:
                # committed, so the members' links resolve
                with TRACER.resume(bt, commit=True):
                    pass
            self._fail_batch(batch, e)
            self._note_service_time(time.perf_counter() - t_dispatch)
            return
        self._stage("dispatch", time.perf_counter() - t_dispatch)
        with self._flight_lock:
            self._inflight_batches += 1
        self._completions.put(_InFlight(batch, finish, bt, t_dispatch))

    def _completion_loop(self):
        while True:
            item = self._completions.get()
            if item is None:        # stop() sentinel
                break
            self._finish_one(item)

    def _finish_one(self, item: _InFlight):
        """Wait for one window's result, build its answers, fan them out;
        the time blocked on the window's copy is read from the readback
        plane's per-thread counter."""
        batch, bt = item.batch, item.trace
        t_c0 = time.perf_counter()
        rb0 = readback.thread_wait_s()
        try:
            if bt is not None:
                bt.root.attrs["completionWaitMs"] = round(
                    (t_c0 - item.t_ready) * 1000.0, 3)
                with TRACER.resume(bt, commit=True):
                    results = item.finish()
            else:
                results = item.finish()
            if len(results) != len(batch):
                raise RuntimeError(
                    f"batch handler returned {len(results)} results "
                    f"for {len(batch)} queries")
        except Exception as e:
            self._inflight_sem.release()
            with self._flight_lock:
                self._inflight_batches -= 1
            self._fail_batch(batch, e)
            self._note_service_time(time.perf_counter() - item.t_dispatch)
            return
        self._inflight_sem.release()
        with self._flight_lock:
            self._inflight -= len(batch)
            self._inflight_batches -= 1
        for p, r in zip(batch, results):
            p.result = r
            p.event.set()
        rb_s = readback.thread_wait_s() - rb0
        self._stage("completion_wait", t_c0 - item.t_ready)
        self._stage("readback", rb_s)
        self._stage("completion", max(0.0, time.perf_counter() - t_c0
                                      - rb_s))
        self._note_service_time(time.perf_counter() - item.t_dispatch)

    def _run_batch(self, batch, formation_s: float = 0.0):
        """One synchronous dispatch (not pipelined), under the window's
        batch_predict trace when a member carries a trace."""
        bt = self._batch_trace(batch, formation_s)
        if bt is None:
            return self.process_batch([p.query for p in batch])
        with TRACER.resume(bt, commit=True):
            return self.process_batch([p.query for p in batch])

    def stop(self, join_timeout_s: float = 10.0):
        """Drain on stop: the formation thread finishes the window it is
        dispatching, the completion thread finishes every window already
        dispatched, then every query still queued fails with
        `ShutdownError`. Atomic with submit()'s check-and-enqueue."""
        self._stop.set()
        self._thread.join(timeout=join_timeout_s)
        if self._thread.is_alive():
            logger.warning("micro-batcher formation thread still busy "
                           "after %.1fs; sweeping the queue anyway",
                           join_timeout_s)
        if self._completion_thread is not None:
            # the sentinel goes in after formation stopped enqueuing:
            # every window dispatched before it completes first
            self._completions.put(None)
            self._completion_thread.join(timeout=join_timeout_s)
            if self._completion_thread.is_alive():
                logger.warning("completion thread still busy after "
                               "%.1fs; failing its undelivered windows",
                               join_timeout_s)
            while True:
                try:
                    item = self._completions.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    continue
                with self._flight_lock:
                    self._inflight_batches -= 1
                self.n_shutdown_failed += len(item.batch)
                self._fail_batch(item.batch, ShutdownError())
        with self._flight_lock:
            while True:
                try:
                    p = self._q.get_nowait()
                except queue.Empty:
                    break
                self._inflight -= 1
                self._undispatched -= 1
                self.n_shutdown_failed += 1
                p.error = ShutdownError()
                p.event.set()
