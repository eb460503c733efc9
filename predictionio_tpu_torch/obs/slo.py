"""SLO engine: declarative objectives with fast and slow burn-rate windows.

The port's copy of `predictionio_tpu/obs/slo.py` (`SLOSpec`,
`SLOEngine`, `default_engine_specs`, `default_event_specs`,
`health_response`, `lock_probe`,
`timed_acquire`). Each `SLOSpec` names a registry family and an
objective; the engine samples the family at every evaluation, keeps a
bounded history, and derives each objective's burn rate over a fast and
a slow window (the multi-window burn-rate alerting shape: the fast
window catches a fire within a minute, the slow one keeps a blip from
paging). Served at `GET /health.json` on both HTTP servers and read by
`status --slo`.

Spec kinds:

- `latency`: a histogram, a threshold and an objective ("99% of
  queries under 250 ms"); burn = bad fraction / error budget a window.
- `rate_min`: a counter or histogram count must sustain a minimum rate
  (`min_rate=0` renders the rates without judging).
- `gauge_max`: a gauge must stay under a bound (model staleness).
- `counter_budget`: named events (rollbacks, gate rejects) against a
  budget a slow window; the default budget 0 flips the SLO on the first
  event inside a fast window.

Also home to the lock-wait probes (`pio_lock_wait_seconds{lock}`):
`lock_probe(label)` returns a cached per-label histogram child and
`timed_acquire` wraps an acquisition in two `perf_counter` reads (the
micro-batcher's admission lock, the storage registry's lock).
"""

from __future__ import annotations

import bisect
import collections
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from predictionio_tpu_torch.obs.metrics import Histogram, get_registry

# -- lock-wait probes ---------------------------------------------------

#: sub-µs .. 1 s: lock waits live orders of magnitude below the request
#: latency buckets, so they get their own scale
LOCK_WAIT_BUCKETS: Tuple[float, ...] = (
    1e-6, 5e-6, 2.5e-5, 1e-4, 5e-4, 2.5e-3, 1e-2, 5e-2, 0.25, 1.0)

_probe_lock = threading.Lock()
_probes: Dict[str, Histogram] = {}


def lock_probe(label: str) -> Histogram:
    """The cached ``pio_lock_wait_seconds{lock=label}`` child — resolve
    once at init time, observe on the hot path."""
    with _probe_lock:
        h = _probes.get(label)
        if h is None:
            family = get_registry().histogram(
                "pio_lock_wait_seconds",
                "Wall time spent waiting to acquire contended locks, "
                "by lock site", buckets=LOCK_WAIT_BUCKETS,
                labelnames=("lock",))
            h = family.labels(lock=label)
            _probes[label] = h
        return h


@contextmanager
def timed_acquire(lock, probe: Histogram):
    """``with timed_acquire(lk, probe):`` — acquire ``lock`` observing
    the wait into ``probe`` (a ``lock_probe`` child). Two perf_counter
    reads + one histogram observe of overhead (~1 µs)."""
    t0 = time.perf_counter()
    lock.acquire()
    probe.observe(time.perf_counter() - t0)
    try:
        yield
    finally:
        lock.release()


# -- SLO specs ----------------------------------------------------------

def _env_f(name: str, default: float,
           tenant: Optional[str] = None) -> float:
    """Float env knob. A tenant-scoped lookup checks the per-tenant
    override ``NAME__<TENANT>`` (tenant upper-cased, non-alphanumerics
    folded to ``_``) before falling back to the fleet-wide ``NAME`` —
    so one latency-sensitive slot can run a tighter serve p99 than its
    neighbors without re-deploying the host."""
    raw = None
    if tenant:
        safe = "".join(ch if ch.isalnum() else "_"
                       for ch in tenant).upper()
        raw = os.environ.get(f"{name}__{safe}")
    if raw is None:
        raw = os.environ.get(name)
    try:
        return float(raw) if raw is not None else float(default)
    except (TypeError, ValueError):
        return float(default)


@dataclass(frozen=True)
class SLOSpec:
    name: str
    kind: str                      # latency | rate_min | gauge_max |
    #                                counter_budget
    metrics: Tuple[str, ...]       # registry family name(s)
    objective: float = 0.99        # latency: fraction under threshold
    threshold_s: float = 0.25      # latency bound
    min_rate: float = 0.0          # rate_min: events/s (0 = advisory)
    max_value: float = 0.0         # gauge_max bound (0 = advisory)
    budget: float = 0.0            # counter_budget per slow window
    fast_window_s: float = field(
        default_factory=lambda: _env_f("PIO_SLO_FAST_WINDOW_S", 60.0))
    slow_window_s: float = field(
        default_factory=lambda: _env_f("PIO_SLO_SLOW_WINDOW_S", 600.0))
    fast_burn: float = 14.0        # burn-rate alert thresholds
    slow_burn: float = 6.0


def default_engine_specs(tenant: Optional[str] = None) -> List[SLOSpec]:
    """The engine server's objectives (docs/operations.md). With
    ``tenant``, every threshold honours per-tenant env overrides
    (``PIO_SLO_SERVE_P99_MS__<TENANT>`` etc) so slots on one host can
    carry different objectives."""
    fw = _env_f("PIO_SLO_FAST_WINDOW_S", 60.0, tenant)
    sw = _env_f("PIO_SLO_SLOW_WINDOW_S", 600.0, tenant)
    return [
        SLOSpec("serve_p99", "latency",
                ("pio_engine_query_seconds",),
                objective=0.99,
                threshold_s=_env_f("PIO_SLO_SERVE_P99_MS", 250.0,
                                   tenant) / 1000.0,
                fast_window_s=fw, slow_window_s=sw),
        SLOSpec("fold_tick_duration", "latency",
                ("pio_fold_tick_seconds",),
                objective=0.95,
                threshold_s=_env_f("PIO_SLO_FOLD_TICK_MS", 2500.0,
                                   tenant) / 1000.0,
                fast_window_s=fw, slow_window_s=sw),
        SLOSpec("model_staleness", "gauge_max",
                ("pio_engine_model_staleness_seconds",),
                max_value=_env_f("PIO_SLO_STALENESS_MAX_S", 600.0,
                                 tenant),
                fast_window_s=fw, slow_window_s=sw),
        SLOSpec("guarded_deploys", "counter_budget",
                ("pio_guard_rollbacks_total",
                 "pio_guard_gate_rejects_total"),
                budget=_env_f("PIO_SLO_GUARD_BUDGET", 0.0, tenant),
                fast_window_s=fw, slow_window_s=sw),
    ]


def default_event_specs() -> List[SLOSpec]:
    """The event server's objectives."""
    return [
        SLOSpec("ingest_write_p99", "latency",
                ("pio_event_write_seconds",),
                objective=0.99,
                threshold_s=_env_f("PIO_SLO_INGEST_P99_MS", 100.0)
                / 1000.0),
        SLOSpec("ingest_rate", "rate_min",
                ("pio_event_write_seconds",),
                min_rate=_env_f("PIO_SLO_INGEST_MIN_EVS", 0.0)),
        SLOSpec("ingest_durability", "counter_budget",
                ("pio_ingest_spilled_total",),
                budget=_env_f("PIO_SLO_SPILL_BUDGET", 0.0)),
    ]


class SLOEngine:
    """Evaluates a spec set against live registries on demand (every
    ``/health.json`` scrape / ``pio status --slo`` poll). Stateful only
    in its sample history ring; safe to share across request threads."""

    def __init__(self, specs: Sequence[SLOSpec], registries=(),
                 clock=time.monotonic, max_samples: int = 512,
                 min_window_s: float = 1.0,
                 sample_spacing_s: Optional[float] = None,
                 tenant: Optional[str] = None):
        self.specs = list(specs)
        self.registries = list(registries)
        # a tenant-scoped engine (one per host slot) reads
        # ONLY its own tenant's children out of tenant-labeled
        # families — fold ticks and guard events booked by a neighbor
        # must not move this slot's burn rates
        self.tenant = tenant
        self.clock = clock
        self.min_window_s = min_window_s
        self._lock = threading.Lock()
        self._history: collections.deque = collections.deque(
            maxlen=max_samples)
        # history must SPAN the slowest window at any poll rate:
        # /health.json is polled by load balancers at whatever
        # frequency they like, and appending per poll would cap the
        # deque at max_samples/poll_rate seconds — a breached SLO
        # would silently clear once the triggering event rotated out.
        # Appends are therefore spaced so max_samples covers the
        # slowest window with ~15% slack; polls in between evaluate
        # against the existing history.
        if sample_spacing_s is None:
            slowest = max((s.slow_window_s for s in self.specs),
                          default=600.0)
            sample_spacing_s = slowest * 1.15 / max(max_samples, 2)
        self.sample_spacing_s = sample_spacing_s
        self.spent_s = 0.0   # cumulative evaluation wall (obs overhead)

    # -- resolution -----------------------------------------------------
    def _family(self, name: str):
        for reg in self.registries:
            fam = reg.get(name)
            if fam is not None:
                return fam
        return get_registry().get(name)

    def _scalar(self, family) -> Optional[float]:
        if family is None:
            return None
        try:
            samples = family.samples()
            if self.tenant and "tenant" in getattr(
                    family, "labelnames", ()):
                samples = [(lab, v) for lab, v in samples
                           if (lab or {}).get("tenant") == self.tenant]
            return float(sum(v for _, v in samples
                             if not isinstance(v, str)))
        except Exception:
            return None

    def _hist_children(self, fam: Histogram) -> List[Histogram]:
        """The concrete histograms holding a family's data. A labeled
        parent keeps its own counters empty — the children carry the
        observations — so a labeled family aggregates its children,
        and a tenant-scoped engine reads only its own tenant's child
        out of a tenant-labeled family."""
        if not fam.labelnames:
            return [fam]
        with fam._lock:
            items = sorted(fam._children.items())
        if self.tenant and "tenant" in fam.labelnames:
            i = fam.labelnames.index("tenant")
            items = [(k, c) for k, c in items if k[i] == self.tenant]
        return [c for _, c in items]

    def _counter_sum(self, names: Tuple[str, ...]) -> Optional[float]:
        total, seen = 0.0, False
        for n in names:
            fam = self._family(n)
            if fam is None:
                continue
            if isinstance(fam, Histogram):
                total += sum(h.count for h in self._hist_children(fam))
                seen = True
                continue
            v = self._scalar(fam)
            if v is not None:
                total += v
                seen = True
        return total if seen else None

    def _latency_state(self, name: str,
                       threshold_s: float) -> Optional[Tuple[float, float]]:
        """(good_cumulative, total_cumulative) for a histogram family,
        good = observations in buckets whose bound <= threshold."""
        fam = self._family(name)
        if not isinstance(fam, Histogram):
            return None
        children = self._hist_children(fam)
        if not children:
            return None
        counts: Optional[List[float]] = None
        for h in children:
            c = h.bucket_counts()
            counts = c if counts is None \
                else [a + b for a, b in zip(counts, c)]
        k = bisect.bisect_right(list(fam.bounds), threshold_s)
        good = float(sum(counts[:k]))
        total = float(sum(counts))
        return good, total

    # -- sampling -------------------------------------------------------
    def _sample(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for spec in self.specs:
            if spec.kind == "latency":
                out[spec.name] = self._latency_state(spec.metrics[0],
                                                     spec.threshold_s)
            elif spec.kind == "rate_min":
                out[spec.name] = self._counter_sum(spec.metrics)
            elif spec.kind == "counter_budget":
                out[spec.name] = self._counter_sum(spec.metrics)
            elif spec.kind == "gauge_max":
                out[spec.name] = self._scalar(
                    self._family(spec.metrics[0]))
        return out

    def _baseline(self, history, now: float, window_s: float):
        """The newest sample at least ``window_s`` old, else the oldest
        available (a short history evaluates over what it has)."""
        base = None
        for t, state in history:
            if now - t >= window_s:
                base = (t, state)
            else:
                break
        if base is None and history:
            base = history[0]
        return base

    # -- evaluation -----------------------------------------------------
    def evaluate(self) -> dict:
        t0 = time.perf_counter()
        now = self.clock()
        cur = self._sample()
        with self._lock:
            history = list(self._history)   # strictly pre-now samples
            if not history \
                    or now - history[-1][0] >= self.sample_spacing_s:
                self._history.append((now, cur))
        slo = [self._evaluate_spec(spec, cur, history, now)
               for spec in self.specs]
        order = {"breached": 2, "burning": 1}
        worst = max((order.get(s["status"], 0) for s in slo), default=0)
        overall = {2: "breached", 1: "burning"}.get(worst, "ok")
        dt = time.perf_counter() - t0
        with self._lock:   # concurrent /health.json polls
            self.spent_s += dt
        out = {"status": overall, "slo": slo}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        return out

    def _windows(self, spec, cur_val, history, now):
        """((delta, window_dt) fast, (delta, window_dt) slow) for a
        scalar cumulative value; deltas None when no usable baseline."""
        out = []
        for w in (spec.fast_window_s, spec.slow_window_s):
            base = self._baseline(history, now, w)
            if base is None or cur_val is None \
                    or base[1].get(spec.name) is None:
                out.append((None, None))
                continue
            dt = max(now - base[0], self.min_window_s)
            out.append((cur_val - base[1][spec.name], dt))
        return out

    def _evaluate_spec(self, spec, cur, history, now) -> dict:
        out = {"name": spec.name, "kind": spec.kind,
               "metrics": list(spec.metrics),
               "fastWindowS": spec.fast_window_s,
               "slowWindowS": spec.slow_window_s}
        val = cur.get(spec.name)
        if spec.kind == "latency":
            return self._eval_latency(spec, val, history, now, out)
        if spec.kind == "gauge_max":
            out["value"] = val
            out["maxValue"] = spec.max_value
            if val is None:
                out["status"] = "no_data"
            elif spec.max_value > 0 and val > spec.max_value:
                out["status"] = "breached"
            else:
                out["status"] = "ok"
            return out
        if spec.kind == "rate_min":
            (df, dtf), (ds, dts) = self._windows(spec, val, history, now)
            rf = (df / dtf) if df is not None else None
            rs = (ds / dts) if ds is not None else None
            out["rateFast"] = round(rf, 3) if rf is not None else None
            out["rateSlow"] = round(rs, 3) if rs is not None else None
            out["minRate"] = spec.min_rate
            # no_data only before ANY traffic (cumulative count 0 —
            # fresh boot); a stream that HAD traffic and stalled to
            # zero is the worst breach, not missing data
            if rf is None or (val or 0.0) == 0.0:
                out["status"] = "no_data"
            elif spec.min_rate > 0 and rf < spec.min_rate:
                out["status"] = "breached"
            else:
                out["status"] = "ok"
            return out
        # counter_budget
        (df, dtf), (ds, dts) = self._windows(spec, val, history, now)
        out["eventsFast"] = df
        out["eventsSlow"] = ds
        out["budget"] = spec.budget
        if df is None:
            out["status"] = "no_data"
        elif df > spec.budget or (ds is not None and ds > spec.budget):
            out["status"] = "breached"
        else:
            out["status"] = "ok"
        return out

    def _eval_latency(self, spec, val, history, now, out) -> dict:
        out["thresholdS"] = spec.threshold_s
        out["objective"] = spec.objective
        if val is None:
            out["status"] = "no_data"
            return out
        good_now, total_now = val
        budget = max(1.0 - spec.objective, 1e-9)
        burns = []
        for w in (spec.fast_window_s, spec.slow_window_s):
            base = self._baseline(history, now, w)
            if base is None or base[1].get(spec.name) is None:
                burns.append(None)
                continue
            g0, t0 = base[1][spec.name]
            d_total = total_now - t0
            if d_total <= 0:
                burns.append(None)
                continue
            bad_frac = max(0.0, (d_total - (good_now - g0)) / d_total)
            burns.append(bad_frac / budget)
        out["burnFast"] = round(burns[0], 3) if burns[0] is not None \
            else None
        out["burnSlow"] = round(burns[1], 3) if burns[1] is not None \
            else None
        fast_hit = burns[0] is not None and burns[0] >= spec.fast_burn
        slow_hit = burns[1] is not None and burns[1] >= spec.slow_burn
        if burns[0] is None:
            out["status"] = "no_data"
        elif fast_hit and (burns[1] is None or slow_hit):
            out["status"] = "breached"
        elif fast_hit or slow_hit:
            # one window alone: a fresh spike the slow window hasn't
            # confirmed, OR a sustained sub-fast-threshold burn eating
            # budget at >= slow_burn for the whole slow window — both
            # must surface (a steady 8x burn would otherwise read
            # "ok" forever)
            out["status"] = "burning"
        else:
            out["status"] = "ok"
        return out


def health_response(engine: Optional[SLOEngine], extra: Optional[dict]
                    = None) -> dict:
    """Shared ``GET /health.json`` body: SLO verdicts + caller extras.
    A server without an engine still answers (liveness without SLOs)."""
    out = {"status": "ok", "slo": []}
    if engine is not None:
        out = engine.evaluate()
    if extra:
        out.update(extra)
    return out
