"""The canary of a guarded deploy, and its watchdog.

The port's counterpart of `predictionio_tpu/guard/canary.py`
(`INCUMBENT`, `CANDIDATE`, `CanaryConfig`, `CanaryController`,
`count_nonfinite`). A version the fold publishes has passed the
numerical sentinels and the pre-swap gates, but only serving shows how it
serves. With a canary on (`ServerConfig.canary_fraction` > 0),
`EngineServer.swap_models` stages the new models as a candidate instead
of swapping them in: the incumbent answers `1 - fraction` of the traffic,
the candidate the rest (its responses carry `X-PIO-Canary`), and this
controller keeps each arm's outcomes (errors, non-finite scores,
latency).

The watchdog decides on the query path:

- a candidate response with non-finite scores beyond `nan_tolerance`
  rolls back at once;
- once the candidate has `min_requests` samples, an error rate above
  `max_error_ratio` x the incumbent's (plus a floor) rolls back;
- when `window_s` has passed with enough samples, a p50 latency above
  `max_latency_ratio` x the incumbent's rolls back, else the candidate is
  promoted (and pinned last-good).

A rollback is in memory and instant: the incumbent never left the
server. The registry's last-good pin and `pio rollback` make it durable
across a restart. The arms' requests, the promotions and the rollbacks
are counted in the reference's `pio_guard_*` families on the registry
the server hands in. Each verdict is a `canary_promote` or
`canary_rollback` flight record, and a rollback captures an incident
bundle (the flight tail, the traces, the registry scrape, the providers'
states) that `incidents show` replays.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

INCUMBENT = "incumbent"
CANDIDATE = "candidate"


@dataclass(frozen=True)
class CanaryConfig:
    fraction: float = 0.0         # the candidate's traffic share; 0 = off
    window_s: float = 30.0        # the watchdog's decision window
    min_requests: int = 20        # candidate samples needed to judge
    max_error_ratio: float = 2.0  # vs the incumbent's error rate
    error_floor: float = 0.02     # extra error rate tolerated outright
    max_latency_ratio: float = 3.0  # candidate p50 vs incumbent p50
    nan_tolerance: int = 0        # candidate non-finite scores tolerated


class _ArmStats:
    __slots__ = ("requests", "errors", "nonfinite", "latencies")

    def __init__(self):
        self.requests = 0
        self.errors = 0
        self.nonfinite = 0
        self.latencies = collections.deque(maxlen=512)

    def error_rate(self) -> float:
        return self.errors / self.requests if self.requests else 0.0

    def p50(self) -> Optional[float]:
        if not self.latencies:
            return None
        return float(np.median(self.latencies))

    def snapshot(self) -> dict:
        return {"requests": self.requests, "errors": self.errors,
                "nonFiniteScores": self.nonfinite,
                "p50LatencySec": self.p50()}


class CanaryController:
    """The canary state machine of one engine server. Its methods take
    only its own lock: a caller may hold its server lock around them,
    never the reverse. `clock` is injectable (a test's fake clock)."""

    def __init__(self, config: CanaryConfig,
                 clock: Callable[[], float] = time.time, registry=None):
        self.config = config
        self.clock = clock
        if registry is None:
            from predictionio_tpu_torch.obs import get_registry
            registry = get_registry()
        self._c_requests = registry.counter(
            "pio_guard_canary_requests_total",
            "Queries served during canary windows, by arm",
            labelnames=("arm",))
        self._c_rollbacks = registry.counter(
            "pio_guard_rollbacks_total",
            "Automatic canary rollbacks by breach reason",
            labelnames=("reason",))
        self._c_promotions = registry.counter(
            "pio_guard_promotions_total",
            "Canary candidates promoted to full traffic")
        self._lock = threading.Lock()
        self._active = False
        self._candidate_models: Optional[List[Any]] = None
        self._candidate_version: Optional[str] = None
        self._candidate_events = 0
        self._started_at = 0.0
        self._seq = 0
        self._arms = {INCUMBENT: _ArmStats(), CANDIDATE: _ArmStats()}
        self.superseded = 0
        self.last_decision: Optional[dict] = None

    @property
    def enabled(self) -> bool:
        return self.config.fraction > 0.0

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    # -- lifecycle ---------------------------------------------------------
    def stage(self, models: Sequence[Any], version: Optional[str],
              fold_in_events: int = 0) -> bool:
        """Begin (or replace) a canary of `models`. False when the canary
        is off: the caller swaps directly."""
        if not self.enabled:
            return False
        with self._lock:
            if self._active:
                # a newer publish supersedes an undecided candidate; the
                # incumbent answers either way
                self.superseded += 1
                logger.warning(
                    "canary candidate %s superseded before a decision",
                    self._candidate_version)
            self._active = True
            self._candidate_models = list(models)
            self._candidate_version = version
            self._candidate_events = int(fold_in_events)
            self._started_at = self.clock()
            self._seq = 0
            self._arms = {INCUMBENT: _ArmStats(), CANDIDATE: _ArmStats()}
        logger.info("canary staged: version %s at %.0f%% of traffic",
                    version, self.config.fraction * 100)
        return True

    def abandon(self, reason: str) -> None:
        """Drop an undecided candidate without a verdict (a full load
        replaced the models under it)."""
        with self._lock:
            if not self._active:
                return
            self._active = False
            self._candidate_models = None
            self.superseded += 1
        logger.warning("canary abandoned: %s", reason)

    # -- the query path ----------------------------------------------------
    def route(self) -> Optional[tuple]:
        """(models, version) when this request (or window) is the
        candidate's, else None. A deterministic Bresenham split: the
        candidate's turns are spread evenly at exactly `fraction` of the
        stream, so a canary run reproduces and a burst never lands on the
        candidate alone."""
        with self._lock:
            if not self._active:
                return None
            slot = self._seq
            self._seq += 1
            f = self.config.fraction
            if int((slot + 1) * f) > int(slot * f):
                return self._candidate_models, self._candidate_version
            return None

    def record(self, arm: str, error: bool = False, nonfinite: int = 0,
               latency_s: Optional[float] = None, n: int = 1) -> None:
        with self._lock:
            if not self._active:
                return
            st = self._arms[arm]
            st.requests += n
            if error:
                st.errors += n
            if nonfinite:
                st.nonfinite += nonfinite
            if latency_s is not None:
                st.latencies.extend([latency_s] * n)
        self._c_requests.labels(arm=arm).inc(n)

    # -- the watchdog ------------------------------------------------------
    def _breach(self) -> Optional[str]:
        """The breach, or None. The caller holds the lock."""
        cfg = self.config
        cand = self._arms[CANDIDATE]
        inc = self._arms[INCUMBENT]
        if cand.nonfinite > cfg.nan_tolerance:
            return "nan_scores"
        if cand.requests >= cfg.min_requests:
            allowed = (inc.error_rate() * cfg.max_error_ratio
                       + cfg.error_floor)
            if cand.error_rate() > allowed:
                return "error_rate"
        return None

    def take_decision(self) -> Optional[dict]:
        """Run the watchdog. On a promote or a rollback, end the canary
        and return the decision (the caller applies the model change);
        None while the window is open."""
        with self._lock:
            if not self._active:
                return None
            reason = self._breach()
            verdict = None
            cand = self._arms[CANDIDATE]
            inc = self._arms[INCUMBENT]
            if reason is not None:
                verdict = ("rollback", reason)
            elif (self.clock() - self._started_at) >= self.config.window_s:
                if cand.requests >= self.config.min_requests:
                    c50, i50 = cand.p50(), inc.p50()
                    if c50 is not None and i50 is not None and i50 > 0 \
                            and c50 > self.config.max_latency_ratio * i50:
                        verdict = ("rollback", "latency")
                    else:
                        verdict = ("promote", "window_clean")
                # else too little candidate traffic to judge: the window
                # stays open (an idle candidate serves almost nothing)
            if verdict is None:
                return None
            kind, why = verdict
            decision = {
                "decision": kind, "reason": why,
                "candidateVersion": self._candidate_version,
                "models": self._candidate_models,
                "foldInEvents": self._candidate_events,
                "windowSec": round(self.clock() - self._started_at, 3),
                "arms": {a: s.snapshot() for a, s in self._arms.items()},
            }
            self._active = False
            self._candidate_models = None
            self.last_decision = {k: v for k, v in decision.items()
                                  if k != "models"}
        if kind == "promote":
            self._c_promotions.inc()
            logger.info("canary PROMOTED: %s (%s)",
                        decision["candidateVersion"], why)
        else:
            self._c_rollbacks.labels(reason=why).inc()
            logger.error(
                "canary ROLLBACK of %s: %s — incumbent keeps serving",
                decision["candidateVersion"], why)
        try:
            from predictionio_tpu_torch.obs import FLIGHT, get_incidents
            FLIGHT.record("canary_" + kind,
                          model_version=decision["candidateVersion"],
                          reason=why, windowSec=decision["windowSec"],
                          arms=decision["arms"])
            if kind == "rollback":
                get_incidents().capture(
                    "canary_rollback",
                    f"canary rollback of {decision['candidateVersion']} "
                    f"({why})",
                    context={k: v for k, v in decision.items()
                             if k != "models"})
        except Exception:
            logger.debug("canary forensics failed", exc_info=True)
        return decision

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "active": self._active,
                "fraction": self.config.fraction,
                "superseded": self.superseded,
                "lastDecision": self.last_decision,
            }
            if self._active:
                out.update({
                    "candidateVersion": self._candidate_version,
                    "ageSec": round(self.clock() - self._started_at, 3),
                    "arms": {a: s.snapshot()
                             for a, s in self._arms.items()},
                })
            return out


def count_nonfinite(obj, depth: int = 0) -> int:
    """Non-finite floats anywhere in a JSON-shaped prediction, to a depth
    of 6: the per-response NaN-score detector."""
    if isinstance(obj, float):
        return 0 if math.isfinite(obj) else 1
    if depth >= 6:
        return 0
    if isinstance(obj, dict):
        return sum(count_nonfinite(v, depth + 1) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(count_nonfinite(v, depth + 1) for v in obj)
    return 0
