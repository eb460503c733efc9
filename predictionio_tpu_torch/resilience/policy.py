"""Retry policies and circuit breakers: the fault-tolerance substrate.

The port's copy of `predictionio_tpu/resilience/policy.py`, with the same
names and the same behaviour. Every storage or network hop that degrades
instead of failing composes the two primitives here:

- `RetryPolicy`: bounded retries with exponential backoff and full
  jitter (each delay uniform in [0, min(cap, base * 2^attempt)]), under
  an optional deadline for the whole operation. A server's
  `Retry-After` hint replaces the computed delay, clamped to the cap.
- `CircuitBreaker`: a per-backend closed -> open -> half-open gate.
  `failure_threshold` consecutive failures open it; while open every
  `allow()` fails fast with `CircuitOpenError` (the event server spills
  to its WAL, the fold scheduler skips its tail read). After
  `reset_timeout_s` one probe is admitted; its success closes the
  circuit, its failure reopens it with the timeout doubled up to
  `max_reset_timeout_s`.

Each transition sets `pio_breaker_state{breaker=...}` (0 closed, 1 open,
2 half-open) and `pio_breaker_transitions_total{breaker,to}` on the
process registry, writes a `breaker` flight record, and a closed -> open
transition captures a `breaker_open` incident. Each fast failure counts
in `pio_breaker_fast_failures_total`. Clocks and sleeps are injectable
for tests in virtual time.

One difference from the reference, in cost only: a closed breaker's
`allow()`, and a `record_success()` that has nothing to reset, read the
state without taking the lock. Each such call takes effect at its read,
where the locked path would have admitted the call or changed nothing,
so the verdicts are the reference's; every event-store write passes
both, and under concurrent ingest the lock was contended on each of them.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger(__name__)

# breaker state encoding for the state gauge
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}

#: THE transient (outage-class) error set: what retries retry, what the
#: ingest path spills on, and what the replayer refuses to quarantine.
#: One definition so the spill/replay loss-and-dedup contract cannot
#: silently diverge between producers and consumers.
TRANSIENT_ERRORS = (IOError, OSError, ConnectionError, TimeoutError)


class RetryBudgetExceeded(IOError):
    """Retries exhausted (attempt cap or deadline budget). Carries the
    last underlying error as ``__cause__``."""


class TransientHTTPError(IOError):
    """A retryable HTTP verdict: the bridge between status codes and
    `TRANSIENT_ERRORS` for a router whose placement is stale or whose
    host is momentarily unhappy (404 mid-failover, 409 generation
    fence, 503 shed). An `IOError`, so a stock `RetryPolicy` retries
    it. A 400 is not transient and is never mapped here."""

    def __init__(self, message: str, status: int = 503,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.http_status = int(status)
        if retry_after_s is not None:
            self.retry_after_s = float(retry_after_s)


class CircuitOpenError(IOError):
    """Fail-fast: the breaker guarding this backend is open. Maps to 503
    on HTTP surfaces; ``retry_after_s`` tells clients when the next
    half-open probe will be admitted."""

    http_status = 503

    def __init__(self, name: str, retry_after_s: float):
        super().__init__(
            f"circuit breaker {name!r} is open; retry in "
            f"{retry_after_s:.1f}s")
        self.breaker = name
        self.retry_after_s = retry_after_s


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """A server-suggested delay carried by an exception (the shed path's
    503 + Retry-After, a breaker's probe deadline), if any."""
    v = getattr(exc, "retry_after_s", None)
    try:
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


@dataclass(frozen=True)
class RetryPolicy:
    """Composable retry schedule: exponential backoff + full jitter
    under a deadline budget.

    ``deadline_s`` bounds the WHOLE operation (attempts + sleeps) from
    the first ``call``; a computed delay that would overshoot it is
    clamped, and when no attempt can complete inside the budget the
    last error is raised wrapped in ``RetryBudgetExceeded``.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 5.0
    deadline_s: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = TRANSIENT_ERRORS
    # injectable for virtual-time tests
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)
    rng: random.Random = field(default_factory=random.Random, repr=False)

    def delay_for(self, attempt: int) -> float:
        """Full-jitter delay before retry number ``attempt`` (1-based)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * (2 ** max(attempt - 1, 0)))
        return self.rng.uniform(0.0, cap)

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under this policy. Exceptions not in ``retry_on``
        propagate immediately (a 400 is not transient)."""
        t0 = self.clock()
        last: Optional[BaseException] = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                last = e
                if attempt >= self.max_attempts:
                    break
                delay = self.delay_for(attempt)
                hint = retry_after_hint(e)
                if hint is not None:
                    # clamp to [0, max_delay_s]: a server-suggested wait
                    # (or an open breaker's probe deadline) must not
                    # park this caller past its own backoff ceiling,
                    # and a buggy negative value must not hit sleep()
                    delay = max(0.0, min(hint, self.max_delay_s))
                if self.deadline_s is not None:
                    remaining = self.deadline_s - (self.clock() - t0)
                    if remaining <= delay:
                        # no room for the sleep AND another attempt:
                        # the budget is the caller's SLO — stop here
                        break
                logger.debug("retry %d/%d after %.3fs: %s", attempt,
                             self.max_attempts, delay, e)
                self.sleep(delay)
        raise RetryBudgetExceeded(
            f"gave up after {self.max_attempts} attempt(s): {last}"
        ) from last


class CircuitBreaker:
    """Per-backend closed -> open -> half-open breaker.

    Usage (both equivalent)::

        br.call(store.insert, event, app_id)

        with br.guard():
            store.insert(event, app_id)

    ``allow()`` raises ``CircuitOpenError`` while open; callers that
    degrade rather than fail (spill, skip-tick) catch it. State changes
    are pushed to the process metrics registry at transition time, so
    ``/metrics`` shows each breaker's live state and its transition
    history without the breaker owning a scrape surface.
    """

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 10.0,
                 max_reset_timeout_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.base_reset_timeout_s = reset_timeout_s
        self.max_reset_timeout_s = max_reset_timeout_s
        self.clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._reset_timeout_s = reset_timeout_s
        self._probe_inflight = False
        if registry is None:
            from predictionio_tpu_torch.obs import get_registry
            registry = get_registry()
        self._g_state = registry.gauge(
            "pio_breaker_state",
            "Circuit-breaker state (0 closed, 1 open, 2 half-open)",
            labelnames=("breaker",)).labels(breaker=name)
        self._c_transitions = registry.counter(
            "pio_breaker_transitions_total",
            "Circuit-breaker state transitions",
            labelnames=("breaker", "to"))
        self._c_fast_fail = registry.counter(
            "pio_breaker_fast_failures_total",
            "Calls rejected while a breaker was open",
            labelnames=("breaker",)).labels(breaker=name)
        self._g_state.set(_STATE_CODE[CLOSED])

    # -- state machine ------------------------------------------------------
    def _transition(self, to: str):
        """Caller holds self._lock."""
        if to == self._state:
            return
        came_from = self._state
        self._state = to
        self._g_state.set(_STATE_CODE[to])
        self._c_transitions.labels(breaker=self.name, to=to).inc()
        logger.info("breaker %s -> %s", self.name, to)
        # every transition is a flight record; an OPEN transition is an
        # incident (the dependency is down and callers now degrade).
        # Both calls are non-blocking, so safe under self._lock.
        try:
            from predictionio_tpu_torch.obs.flight import FLIGHT
            FLIGHT.record("breaker", breaker=self.name, to=to,
                          from_=came_from,
                          consecutiveFailures=self._consecutive_failures)
            if to == OPEN and came_from == CLOSED:
                from predictionio_tpu_torch.obs.incidents import INCIDENTS
                INCIDENTS.capture(
                    "breaker_open",
                    f"breaker {self.name!r} opened after "
                    f"{self._consecutive_failures} consecutive failures",
                    context={"breaker": self.name,
                             "failures": self._consecutive_failures,
                             "resetTimeoutS": self._reset_timeout_s})
        except Exception:   # diagnosis must never worsen the fault
            logger.debug("flight/incident hook failed", exc_info=True)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        """Caller holds self._lock: open -> half-open once the probe
        window arrives."""
        if (self._state == OPEN
                and self.clock() - self._opened_at >= self._reset_timeout_s):
            self._transition(HALF_OPEN)
            self._probe_inflight = False

    def allow(self):
        """Admission check: raises ``CircuitOpenError`` when the call
        must fail fast. In half-open, exactly one probe is admitted at a
        time; concurrent callers fail fast until it reports."""
        if self._state == CLOSED:
            return
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return
            if self._state == HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return
            retry_in = (self._reset_timeout_s
                        - (self.clock() - self._opened_at))
            self._c_fast_fail.inc()
            raise CircuitOpenError(self.name, max(retry_in, 0.0))

    def record_success(self):
        if (self._state == CLOSED and not self._consecutive_failures
                and not self._probe_inflight):
            return
        with self._lock:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._reset_timeout_s = self.base_reset_timeout_s
                self._transition(CLOSED)

    def record_failure(self):
        with self._lock:
            self._consecutive_failures += 1
            if self._state == HALF_OPEN:
                # failed probe: re-open with the timeout doubled so a
                # hard-down backend is probed ever more gently
                self._probe_inflight = False
                self._reset_timeout_s = min(self._reset_timeout_s * 2,
                                            self.max_reset_timeout_s)
                self._opened_at = self.clock()
                self._transition(OPEN)
            elif (self._state == CLOSED and
                  self._consecutive_failures >= self.failure_threshold):
                self._opened_at = self.clock()
                self._transition(OPEN)

    # -- call surfaces ------------------------------------------------------
    def guard(self):
        """Context manager: admission on enter, success/failure recorded
        on exit. ``CircuitOpenError`` from the admission is NOT counted
        as a backend failure."""
        return _BreakerGuard(self)

    def call(self, fn: Callable, *args, **kwargs):
        self.allow()
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class _BreakerGuard:
    def __init__(self, breaker: CircuitBreaker):
        self.breaker = breaker

    def __enter__(self):
        self.breaker.allow()
        return self.breaker

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        return False
