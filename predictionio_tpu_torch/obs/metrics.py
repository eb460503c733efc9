"""Process metrics registry: Counter / Gauge / Histogram primitives.

The port's copy of `predictionio_tpu/obs/metrics.py` (`Counter`,
`Gauge`, `Histogram`, `FuncCollector`, `MetricsRegistry(parent=)`,
`REGISTRY`, `get_registry`, `json_label`):

- `REGISTRY` (`get_registry()`) is the process-wide registry: the
  compile plane, device time, transfer bytes, the fold and the data
  plane report into it.
- Each HTTP server mounts its own `MetricsRegistry(parent=REGISTRY)`, so
  its counters start at zero per instance while its `/metrics`
  exposition still carries the process-wide families through the
  parent chain.

Three sample sources render the same way: native counters, gauges and
histograms (thread-safe, optionally labeled); func collectors
(`gauge_func`, `counter_func`, `summary_func`), read at scrape time from
state that lives elsewhere; and the parent registry's families.
Histograms use cumulative Prometheus buckets and derive p50/p95/p99 by
linear interpolation inside the owning bucket for the JSON surfaces.

Exemplars: every `observe()` made inside an active trace stamps the
trace id on the bucket the observation landed in (last writer wins), so
a tail bucket in a scrape names a request whose span tree
`GET /traces.json?trace_id=` returns: the `# {trace_id="..."} value ts`
OpenMetrics suffix on `_bucket` lines (`?exemplars=1`), and the
`exemplars` block of a snapshot (`/stats.json`'s histograms).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# Default latency buckets (seconds): sub-ms serving paths up through
# multi-second fold/train stages. 14 bounds + +Inf.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_INF = float("inf")

_trace_id_fn: Optional[Callable] = None


def _current_trace_id() -> Optional[str]:
    """The active trace id, through `obs.trace` resolved at first use
    (metrics is the bottom of the obs imports; a module-level import
    would cycle through `obs/__init__`)."""
    global _trace_id_fn
    fn = _trace_id_fn
    if fn is None:
        from predictionio_tpu_torch.obs.trace import TRACER
        fn = _trace_id_fn = TRACER.current_trace_id
    return fn()


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]):
    if sorted(labels) != sorted(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[k]) for k in labelnames)


class Counter:
    """Monotonic counter. With ``labelnames``, acts as a family:
    ``labels(**kv)`` returns the per-labelset child counter (cache the
    child on hot paths)."""

    mtype = "counter"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: Dict[Tuple[str, ...], "Counter"] = {}

    def labels(self, **labels) -> "Counter":
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Counter(self.name, self.help)
                self._children[key] = child
            return child

    def inc(self, amount: float = 1.0):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels()")
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        if not self.labelnames:
            return [(None, self._value)]
        with self._lock:
            items = sorted(self._children.items())
        return [(dict(zip(self.labelnames, key)), child._value)
                for key, child in items]


class Gauge:
    """Point-in-time value: ``set``/``inc``/``dec``. With labels, a
    family like Counter."""

    mtype = "gauge"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: Dict[Tuple[str, ...], "Gauge"] = {}

    def labels(self, **labels) -> "Gauge":
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Gauge(self.name, self.help)
                self._children[key] = child
            return child

    def set(self, value: float):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels()")
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def samples(self):
        if not self.labelnames:
            return [(None, self._value)]
        with self._lock:
            items = sorted(self._children.items())
        return [(dict(zip(self.labelnames, key)), child._value)
                for key, child in items]


class Histogram:
    """Prometheus-bucketed histogram with percentile derivation.

    Exposition: cumulative ``_bucket{le=...}`` (``le`` ascending, +Inf
    last), ``_sum``, ``_count``. JSON surfaces call ``percentile(q)`` /
    ``percentiles_ms()``: linear interpolation inside the bucket that
    holds the q-th observation (0 as the implicit lower bound of the
    first bucket; an observation in the +Inf bucket reports the last
    finite bound — the standard Prometheus ``histogram_quantile`` clamp).
    """

    mtype = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Optional[Sequence[float]] = None,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        bounds = tuple(sorted(buckets if buckets is not None
                              else DEFAULT_BUCKETS))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if bounds[-1] == _INF:
            bounds = bounds[:-1]
        self.bounds = bounds                  # finite bounds, ascending
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)  # + the +Inf bucket
        self._sum = 0.0
        self._count = 0
        # per bucket: (trace_id, value, unix ts) of the latest in-trace
        # observation that landed in it
        self._exemplars: List[Optional[Tuple[str, float, float]]] = \
            [None] * (len(bounds) + 1)
        self._children: Dict[Tuple[str, ...], "Histogram"] = {}

    def labels(self, **labels) -> "Histogram":
        key = _label_key(self.labelnames, labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = Histogram(self.name, self.help, self.bounds)
                self._children[key] = child
            return child

    def observe(self, value: float):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels()")
        i = bisect.bisect_left(self.bounds, value)
        tid = _current_trace_id()
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if tid is not None:
                self._exemplars[i] = (tid, value, time.time())

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 100]. None when empty."""
        with self._lock:
            counts = list(self._counts)
        return self._percentile_of(counts, q)

    def _percentile_of(self, counts, q: float) -> Optional[float]:
        total = sum(counts)
        if total == 0:
            return None
        target = (q / 100.0) * total
        cum = 0
        lower = 0.0
        for i, c in enumerate(counts):
            upper = self.bounds[i] if i < len(self.bounds) \
                else self.bounds[-1]
            if cum + c >= target and c > 0:
                if i >= len(self.bounds):
                    return upper  # +Inf bucket: clamp to last bound
                frac = (target - cum) / c
                return lower + frac * (upper - lower)
            cum += c
            lower = upper if i < len(self.bounds) else lower
        return self.bounds[-1]

    def bucket_counts(self):
        """Point-in-time per-bucket counts (non-cumulative) — pair with
        ``percentile_since`` to derive percentiles for a measurement
        window (e.g. a bench's timed phase, excluding warmup/compile
        observations)."""
        with self._lock:
            return list(self._counts)

    def percentile_since(self, prev_counts, q: float) -> Optional[float]:
        """Percentile over observations made AFTER ``prev_counts`` (a
        prior ``bucket_counts()`` snapshot)."""
        with self._lock:
            counts = [c - p for c, p in zip(self._counts, prev_counts)]
        return self._percentile_of(counts, q)

    def snapshot(self) -> dict:
        """JSON view with derived tail percentiles (the /stats.json
        shape)."""
        with self._lock:
            total, s = self._count, self._sum
        out = {"count": total, "sum": s,
               "avg": (s / total if total else 0.0)}
        for q, k in ((50, "p50"), (95, "p95"), (99, "p99")):
            v = self.percentile(q)
            if v is not None:
                out[k] = v
        ex = self.exemplars()
        if ex:
            # each id resolves through GET /traces.json?trace_id=
            out["exemplars"] = ex
        return out

    def exemplars(self) -> Dict[str, dict]:
        """{le label: {"traceId", "value", "ts"}} for the buckets an
        in-trace observation landed in."""
        with self._lock:
            ex = list(self._exemplars)
        out = {}
        for i, bound in enumerate(list(self.bounds) + [_INF]):
            if ex[i] is None:
                continue
            le = "+Inf" if bound == _INF else format(bound, "g")
            tid, value, ts = ex[i]
            out[le] = {"traceId": tid, "value": value, "ts": ts}
        return out

    def _own_samples(self, label_base: Optional[dict]):
        with self._lock:
            counts = list(self._counts)
            ex = list(self._exemplars)
            s, total = self._sum, self._count
        out = []
        cum = 0
        for i, bound in enumerate(list(self.bounds) + [_INF]):
            cum += counts[i]
            le = "+Inf" if bound == _INF else format(bound, "g")
            labels = dict(label_base or {})
            labels["le"] = le
            if ex[i] is not None:
                tid, value, ts = ex[i]
                # a 4-tuple: the renderer appends the OpenMetrics
                # exemplar suffix to this _bucket line only
                out.append(("_bucket", labels, cum,
                            {"labels": {"trace_id": tid},
                             "value": value, "ts": ts}))
            else:
                out.append(("_bucket", labels, cum))
        out.append(("_sum", label_base, s))
        out.append(("_count", label_base, total))
        return out

    def samples(self):
        if not self.labelnames:
            return self._own_samples(None)
        with self._lock:
            items = sorted(self._children.items())
        out = []
        for key, child in items:
            out.extend(child._own_samples(dict(zip(self.labelnames, key))))
        return out


class FuncCollector:
    """A metric family whose samples come from a callback at collect
    time: the owner of the state (a server, a batcher, a scheduler)
    stays the single source of truth and the registry
    samples it on scrape. ``fn`` returns a number or a list of
    ``(labels-or-None, value)`` pairs; a raising/None callback renders
    no samples rather than failing the whole scrape."""

    def __init__(self, name: str, help: str, fn: Callable,
                 mtype: str = "gauge"):
        self.name = name
        self.help = help
        self.fn = fn
        self.mtype = mtype
        self.labelnames = ()

    def samples(self):
        try:
            got = self.fn()
        except Exception:
            return []
        if got is None:
            return []
        if isinstance(got, (int, float)):
            return [(None, got)]
        return [(labels, v) for labels, v in got
                if v is not None and not (isinstance(v, float)
                                          and math.isnan(v))]


class MetricsRegistry:
    """Named, typed metric families; get-or-create registration.

    ``parent`` chains a server-local registry onto the process-wide one:
    ``collect()``/``render()`` walk own families first, then the
    parent's (own names shadow). Registration of an existing name with
    the same type returns the existing family; a type clash raises —
    two subsystems silently writing one name as different types is the
    classic scrape-breaking bug."""

    def __init__(self, parent: Optional["MetricsRegistry"] = None):
        self.parent = parent
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _register(self, cls, name, help, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not cls:
                    raise ValueError(
                        f"metric {name} already registered as "
                        f"{type(existing).__name__}")
                return existing
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames=labelnames)

    def histogram(self, name: str, help: str,
                  buckets: Optional[Sequence[float]] = None,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets,
                              labelnames=labelnames)

    def gauge_func(self, name: str, help: str, fn: Callable):
        with self._lock:
            if name in self._metrics:
                return self._metrics[name]
            m = FuncCollector(name, help, fn, mtype="gauge")
            self._metrics[name] = m
            return m

    def counter_func(self, name: str, help: str, fn: Callable):
        with self._lock:
            if name in self._metrics:
                return self._metrics[name]
            m = FuncCollector(name, help, fn, mtype="counter")
            self._metrics[name] = m
            return m

    def summary_func(self, name: str, help: str, fn: Callable):
        """fn returns [({"quantile": "0.5"}, v), ...] or None."""
        with self._lock:
            if name in self._metrics:
                return self._metrics[name]
            m = FuncCollector(name, help, fn, mtype="summary")
            self._metrics[name] = m
            return m

    def get(self, name: str):
        """The registered family, walking the parent chain; None when
        absent."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None and self.parent is not None:
            return self.parent.get(name)
        return m

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    # -- exposition ----------------------------------------------------
    def collect(self, include_parent: bool = True
                ) -> List[Tuple[str, str, str, list]]:
        """(name, type, help, samples) families — own first, then the
        parent chain's (shadowed by name)."""
        with self._lock:
            own = list(self._metrics.values())
        out = [(m.name, m.mtype, m.help, m.samples()) for m in own]
        if include_parent and self.parent is not None:
            seen = {m.name for m in own}
            for fam in self.parent.collect():
                if fam[0] not in seen:
                    out.append(fam)
        return out

    def render(self, include_parent: bool = True,
               exemplars: bool = False) -> str:
        """Prometheus text exposition of everything this registry knows
        — the producer behind every ``GET /metrics`` of the port.
        ``exemplars=True`` emits the OpenMetrics form (``# {trace_id=...}``
        bucket suffixes, ``# EOF`` terminated); the default stays
        parseable by the classic 0.0.4 scraper."""
        from predictionio_tpu_torch.utils.prometheus import \
            render_metrics
        return render_metrics(self.collect(include_parent=include_parent),
                              exemplars=exemplars)

    def snapshot(self) -> dict:
        """Compact JSON view (own families only): scalar for plain
        counters/gauges, label-keyed dict for families, histogram dicts
        with derived p50/p95/p99."""
        with self._lock:
            own = list(self._metrics.values())
        out = {}
        for m in own:
            if isinstance(m, Histogram):
                if not m.labelnames:
                    out[m.name] = m.snapshot()
                else:
                    with m._lock:
                        items = sorted(m._children.items())
                    out[m.name] = {
                        json_label(dict(zip(m.labelnames, key))):
                            child.snapshot()
                        for key, child in items}
            elif isinstance(m, (Counter, Gauge)) and not m.labelnames:
                out[m.name] = m.value
            else:   # labeled counter/gauge or func collector
                out[m.name] = {json_label(labels): v
                               for labels, v in m.samples()}
        return out


def json_label(labels) -> str:
    if not labels:
        return ""
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


# The process-wide registry (module import = process singleton).
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
