"""The always-on sampling profiler and the torch.profiler device trace.

The port's copy of `predictionio_tpu/obs/profiler.py`
(`SamplingProfiler`, `PROFILER`, `get_profiler`, `ensure_started`,
`profile_response`, `profile_response_from_request`), with
`TorchTraceController` in the place of the reference's
`JaxTraceController`:

- `SamplingProfiler`: a low-rate (`PIO_PROFILER_HZ`, default 19)
  folded-stack sampler over every live thread through
  `sys._current_frames()`, cheap enough to stay on for the process's
  life (its own wall is counted in `spent_s`). Stacks aggregate as
  root-first `file:func;file:func -> count` lines, bounded to
  `max_stacks` distinct stacks with an `(other)` overflow count. Both
  servers start it unless `PIO_PROFILER=off`.
- `TorchTraceController`: the idempotent `/profile.json` start/stop
  toggle of a device trace. `start` begins a
  `torch.profiler.profile(activities=[CPU, CUDA])`; a second start
  reports the running trace, a stop without a trace reports idle, and
  every answer carries the state. `stop` writes a Chrome trace
  (`pio_trace_<pid>_<n>.json`, with the CUDA kernels and graph launches
  the card ran meanwhile) into the directory `start` named. The CPU
  activity alone is asked for only when the caller's device is `"cpu"`
  (the request body's `device`, else the server's); on the card a trace
  that cannot record CUDA activity answers an error instead of a CPU-only
  trace. The profiler's session belongs to the thread that started it
  (a stop on another thread finds no session), and each HTTP request
  runs on a thread of its own, so one worker thread of the controller
  runs every start and stop; the CPU ops of every thread are recorded
  where the torch build can (`profile_all_threads`, the answer's
  `allThreads`), and the CUDA activity is the whole process's. A profiler start or stop may flush the CUDA
  activity buffers and synchronize the device, which would invalidate a
  CUDA-graph capture in flight on another thread, so both run under
  `compile/aot.capture_quiesced()`: they wait for the captures in flight
  and hold new ones off meanwhile.

`profile_response` is the handler body both servers mount at
`/profile.json`: POST `{"action": "start"|"stop"}` toggles the device
trace; `action=report` (GET or POST) returns the sampler's report (what
`profile top` prints and what incident bundles embed through the
`profiler` provider).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

_FOLD_SKIP_PREFIXES = ("<",)   # <string>, <frozen importlib...>


def profiler_enabled() -> bool:
    return os.environ.get("PIO_PROFILER", "").strip().lower() not in (
        "off", "0", "false", "no")


def _hz_default() -> float:
    try:
        hz = float(os.environ.get("PIO_PROFILER_HZ", 19.0))
    except (TypeError, ValueError):
        hz = 19.0
    return min(max(hz, 0.1), 250.0)


def _fold(frame) -> str:
    """One thread's stack as a folded line, root first, leaf last —
    ``file:func;file:func``. File paths compress to their basename
    (the repo has no duplicate module basenames worth a full path)."""
    parts: List[str] = []
    while frame is not None:
        code = frame.f_code
        fname = code.co_filename
        if not fname.startswith(_FOLD_SKIP_PREFIXES):
            fname = fname.rsplit("/", 1)[-1]
        parts.append(f"{fname}:{code.co_name}")
        frame = frame.f_back
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """Process-wide folded-stack sampler. ``start()`` is idempotent;
    the sampling thread is a daemon and excludes itself from samples.
    All public methods are thread-safe."""

    def __init__(self, hz: Optional[float] = None,
                 max_stacks: int = 1024):
        self.hz = hz if hz is not None else _hz_default()
        self.max_stacks = max_stacks
        self._lock = threading.Lock()
        self._stacks: Dict[str, int] = {}
        self._other = 0              # samples past the max_stacks bound
        self.samples = 0             # thread-stacks recorded
        self.ticks = 0               # sampling rounds completed
        self.spent_s = 0.0           # the sampler's own cumulative wall
        self.started_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registered = False
        self._register_metrics()

    def _register_metrics(self):
        if self._registered:
            return
        self._registered = True
        from predictionio_tpu_torch.obs.metrics import get_registry
        reg = get_registry()
        # eager, first-registrant-wins (the FLIGHT/incidents pattern):
        # a quiet server scrapes 0, not absent
        reg.counter_func(
            "pio_profiler_samples_total",
            "Thread-stack samples recorded by the always-on sampling "
            "profiler", lambda: self.samples)
        reg.counter_func(
            "pio_profiler_spent_seconds_total",
            "Cumulative wall time the sampling profiler spent walking "
            "stacks (its own overhead)", lambda: self.spent_s)
        reg.gauge_func(
            "pio_profiler_running",
            "1 while the sampling profiler thread is alive",
            lambda: int(self.running))

    # -- lifecycle -----------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        """Idempotent; returns True when the sampler is (now) running.
        Respects ``PIO_PROFILER=off``."""
        if not profiler_enabled():
            return False
        with self._lock:
            if self.running:
                return True
            self._stop.clear()
            if self.started_at is None:
                self.started_at = time.time()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="pio-profiler")
            self._thread.start()
        return True

    def stop(self, join_timeout_s: float = 2.0):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=join_timeout_s)
        self._thread = None

    # -- sampling ------------------------------------------------------
    def _loop(self):
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(interval):
            t0 = time.perf_counter()
            try:
                frames = sys._current_frames()
                folded = [_fold(f) for tid, f in frames.items()
                          if tid != me]
            except Exception:
                continue
            with self._lock:
                self.ticks += 1
                for line in folded:
                    self.samples += 1
                    cur = self._stacks.get(line)
                    if cur is not None:
                        self._stacks[line] = cur + 1
                    elif len(self._stacks) < self.max_stacks:
                        self._stacks[line] = 1
                    else:
                        self._other += 1
                self.spent_s += time.perf_counter() - t0

    def reset(self):
        with self._lock:
            self._stacks.clear()
            self._other = 0
            self.samples = 0
            self.ticks = 0
            self.started_at = time.time() if self.running else None

    # -- reads ---------------------------------------------------------
    def report(self, top: int = 30) -> dict:
        """The operator view (``/profile.json?action=report``,
        ``pio profile top``, incident bundles): top folded stacks by
        sample count with percentages, plus the sampler's own
        self-accounting."""
        with self._lock:
            stacks = sorted(self._stacks.items(), key=lambda kv: -kv[1])
            samples, ticks = self.samples, self.ticks
            other, spent = self._other, self.spent_s
            started = self.started_at
        wall_s = (time.time() - started) if started else 0.0
        out = {
            "running": self.running,
            "hz": self.hz,
            "samples": samples,
            "ticks": ticks,
            "distinctStacks": len(stacks),
            "otherSamples": other,
            "wallS": round(wall_s, 3),
            "spentS": round(spent, 6),
            # the sampler's own cost as a fraction of the window it
            # covered — what profiler_overhead_ms prices per-tick
            "overheadPct": (round(100.0 * spent / wall_s, 4)
                            if wall_s > 0 else 0.0),
            "topStacks": [
                {"stack": line, "count": n,
                 "pct": round(100.0 * n / samples, 2) if samples else 0}
                for line, n in stacks[:max(0, int(top))]],
        }
        return out

    def report_state(self) -> dict:
        """Compact provider view for incident bundles (top 15)."""
        return self.report(top=15)


def _all_threads_config():
    """(experimental config, True) recording every thread's CPU ops, or
    (None, False) on a torch build without `profile_all_threads` (the
    controller's thread alone then; CUDA activity is unaffected)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True), True
    except (ImportError, TypeError):
        return None, False


class ProfilerUnavailable(RuntimeError):
    """The device trace cannot record what the caller's device needs."""


class TorchTraceController:
    """The idempotent `/profile.json` device-trace toggle over
    `torch.profiler`: a second start reports the running trace, a stop
    without a trace reports idle, and every response carries state.
    `last_start_s`/`last_stop_s` are the walls the last start and stop
    took (the export of the trace file included)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._prof = None
        self._seq = 0
        self._worker = None
        self.last_start_s: Optional[float] = None
        self.last_stop_s: Optional[float] = None

    def _on_worker(self, fn):
        """Run `fn()` on the controller's one worker thread (created at
        first use) and return what it returns, or raise what it
        raises."""
        if self._worker is None:
            from concurrent.futures import ThreadPoolExecutor
            self._worker = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pio-device-trace")
        return self._worker.submit(fn).result()

    @property
    def tracing(self) -> bool:
        return self._dir is not None

    @staticmethod
    def _activities(device: Optional[str]):
        """CPU alone for a process whose device is "cpu"; CPU and CUDA
        otherwise, which needs a CUDA device."""
        import torch
        from torch.profiler import ProfilerActivity
        if device is not None and str(device).startswith("cpu"):
            return [ProfilerActivity.CPU]
        if not torch.cuda.is_available():
            raise ProfilerUnavailable(
                "a device trace records CUDA activity and this process "
                "has no CUDA device; name the device \"cpu\" for a CPU "
                "trace")
        if ProfilerActivity.CUDA not in \
                torch.profiler.supported_activities():
            raise ProfilerUnavailable(
                "this torch build's profiler cannot record CUDA activity")
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def start(self, trace_dir: str, device: Optional[str] = None) -> dict:
        """Begin a trace whose Chrome file `stop` writes into
        `trace_dir`. Raises `ProfilerUnavailable` (nothing started)."""
        import torch
        from predictionio_tpu_torch.compile.aot import capture_quiesced
        with self._lock:
            if self._dir is not None:
                return {"message": "already tracing",
                        "tracing": True, "dir": self._dir}
            activities = self._activities(device)
            t0 = time.perf_counter()
            config, all_threads = _all_threads_config()
            prof = torch.profiler.profile(activities=activities,
                                          experimental_config=config)

            def start():
                with capture_quiesced():
                    prof.start()
            self._on_worker(start)
            self.last_start_s = time.perf_counter() - t0
            self._prof, self._dir = prof, trace_dir
        return {"message": "tracing", "tracing": True, "dir": trace_dir,
                "activities": [a.name for a in activities],
                "allThreads": all_threads}

    def stop(self) -> dict:
        from predictionio_tpu_torch.compile.aot import capture_quiesced
        with self._lock:
            if self._dir is None:
                return {"message": "not tracing", "tracing": False}
            trace_dir, prof = self._dir, self._prof
            self._dir = self._prof = None
            t0 = time.perf_counter()

            def stop():
                with capture_quiesced():
                    prof.stop()
            self._on_worker(stop)
            self._seq += 1
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(
                trace_dir, f"pio_trace_{os.getpid()}_{self._seq}.json")
            prof.export_chrome_trace(path)
            self.last_stop_s = time.perf_counter() - t0
        return {"message": "trace stopped", "tracing": False,
                "dir": trace_dir, "traceFile": path}


# Process-wide singletons (module import = process singleton, the
# FLIGHT/INCIDENTS pattern).
PROFILER = SamplingProfiler()
TORCH_TRACE = TorchTraceController()


def get_profiler() -> SamplingProfiler:
    return PROFILER


def ensure_started() -> bool:
    """Both servers call this at start(): the sampler is ALWAYS ON for
    server processes unless ``PIO_PROFILER=off``."""
    return PROFILER.start()


def profile_response(action: Optional[str],
                     body: Optional[dict] = None,
                     device: Optional[str] = None):
    """Shared ``/profile.json`` handler body for both HTTP servers.
    Returns ``(http_status, response_dict)``.

    - ``start``/``stop``: the device-trace toggle (``dir``, default
      ``/tmp/pio_trace``; ``device``, default the server's `device`);
      a start the process cannot record answers 500, tracing false;
    - ``report``: the sampling profiler's folded-stack report
      (``top`` bounds the stack list).
    """
    body = body or {}
    if action == "start":
        try:
            return 200, TORCH_TRACE.start(
                body.get("dir", "/tmp/pio_trace"),
                device=body.get("device", device))
        except ProfilerUnavailable as e:
            return 500, {"message": str(e), "tracing": False}
    if action == "stop":
        return 200, TORCH_TRACE.stop()
    if action == "report":
        try:
            top = int(body.get("top", 30))
        except (TypeError, ValueError):
            top = 30
        out = PROFILER.report(top=top)
        out["message"] = "profiler report"
        out["tracing"] = TORCH_TRACE.tracing
        return 200, out
    return 400, {"message": "action must be start|stop|report",
                 "tracing": TORCH_TRACE.tracing}


def profile_response_from_request(req, device: Optional[str] = None):
    """The shared Request-to-response body both servers' /profile.json
    handlers delegate to: action from the JSON body or query params
    (GET report carries no body), with the ``top`` query param
    promoted for reports. Returns ``(http_status, response_dict)``."""
    d = req.json() or {}
    action = d.get("action") or req.params.get("action")
    if action == "report" and "top" not in d and "top" in req.params:
        d = dict(d, top=req.params["top"])
    return profile_response(action, d, device=device)
