"""Seeded chaos injection: wrap storage backends and HTTP hops with
deterministic error, latency and partition faults.

The port's copy of `predictionio_tpu/resilience/faults.py`: the same
spec grammar, the same seeded decision stream (one `random.Random` under
a lock, consulted in the same order), so one spec and seed inject the
same faults in either package.

Spec syntax (the `PIO_FAULTS` environment variable or the CLI's
`faults`)::

    target:key=value[,key=value...][;target:...]

    PIO_FAULTS='storage.write:error=0.3,seed=42'
    PIO_FAULTS='storage:latency_ms=50,latency_rate=0.5;http:error=0.1'

Targets are dotted names matched by segment prefix: a `storage` clause
applies to `storage.write` and `storage.read`. Keys:

    error=P        raise InjectedFault with probability P
    partition=P    raise ConnectionError with probability P
    latency_ms=D   inject D ms of latency ...
    latency_rate=P ... with probability P (default 1.0 when latency set)
    corrupt=P      (alias: nan=P) NaN-corrupt the data at the sites that
                   opt in through `maybe_corrupt_array` (`fold.ratings`,
                   `fold.factors`) with probability P
    seed=N         RNG seed (whole spec; the first clause naming it wins)

`FaultyEvents` wraps an `Events` DAO (writes consult `storage.write`,
reads `storage.read`); the storage registry applies it to every events
DAO it hands out when `PIO_FAULTS` names a storage target. Injections
count in `pio_faults_injected_total{target,kind}`.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from predictionio_tpu_torch.data.storage import base

logger = logging.getLogger(__name__)

ENV_VAR = "PIO_FAULTS"


class InjectedFault(IOError):
    """A fault the chaos harness injected on purpose."""


@dataclass(frozen=True)
class FaultRule:
    """Per-target fault settings. ``None`` = the clause said nothing
    about this field (so a broader clause may supply it) — distinct
    from an explicit 0, which OVERRIDES a broader clause (the way a
    sub-target is exempted: ``storage:error=0.3;storage.write:error=0``
    faults reads only)."""

    error: Optional[float] = None        # P(raise InjectedFault)
    partition: Optional[float] = None    # P(raise ConnectionError)
    latency_ms: Optional[float] = None
    latency_rate: Optional[float] = None  # P(apply latency); default 1
    corrupt: Optional[float] = None      # P(NaN-corrupt opted-in data)

    def merged_over(self, other: "FaultRule") -> "FaultRule":
        """This rule layered over a less specific one: specific wins
        per field where it says ANYTHING (including an explicit 0)."""
        return FaultRule(*(
            s if s is not None else o
            for s, o in zip(
                (self.error, self.partition, self.latency_ms,
                 self.latency_rate, self.corrupt),
                (other.error, other.partition, other.latency_ms,
                 other.latency_rate, other.corrupt))))


@dataclass(frozen=True)
class FaultSpec:
    rules: Dict[str, FaultRule] = field(default_factory=dict)
    seed: Optional[int] = None

    @staticmethod
    def parse(spec: str) -> "FaultSpec":
        rules: Dict[str, FaultRule] = {}
        seed = None
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if ":" not in clause:
                raise ValueError(
                    f"bad fault clause {clause!r}: want target:key=value")
            target, _, kvs = clause.partition(":")
            target = target.strip()
            kw: Dict[str, float] = {}
            for item in kvs.split(","):
                item = item.strip()
                if not item:
                    continue
                if "=" not in item:
                    raise ValueError(
                        f"bad fault setting {item!r} in {clause!r}")
                k, _, v = item.partition("=")
                k = k.strip()
                try:
                    val = float(v)
                except ValueError:
                    raise ValueError(
                        f"fault setting {k}={v!r} is not a number")
                if k == "seed":
                    if seed is None:
                        seed = int(val)
                    continue
                if k == "nan":   # operator-friendly alias
                    k = "corrupt"
                if k not in ("error", "partition", "latency_ms",
                             "latency_rate", "corrupt"):
                    raise ValueError(f"unknown fault key {k!r}")
                kw[k] = val
            for p in ("error", "partition", "latency_rate", "corrupt"):
                if p in kw and not 0.0 <= kw[p] <= 1.0:
                    raise ValueError(f"{p} must be in [0, 1]")
            rules[target] = FaultRule(**kw)
        return FaultSpec(rules=rules, seed=seed)

    def rule_for(self, target: str) -> Optional[FaultRule]:
        """Most-specific match layered over broader ones: for target
        ``storage.write``, a ``storage.write`` clause wins per field
        over a ``storage`` clause."""
        matched = None
        # broadest first so later (more specific) layers override
        parts = target.split(".")
        for i in range(1, len(parts) + 1):
            prefix = ".".join(parts[:i])
            rule = self.rules.get(prefix)
            if rule is not None:
                matched = rule if matched is None \
                    else rule.merged_over(matched)
        return matched


class FaultInjector:
    """Seeded decision engine. One shared RNG under a lock: decisions
    are deterministic in call order for a given (spec, seed) — the
    chaos suite serializes its faulted ops, so runs reproduce."""

    def __init__(self, spec: FaultSpec, seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 registry=None):
        self.spec = spec
        self.seed = seed if seed is not None else (
            spec.seed if spec.seed is not None else 0)
        self.rng = random.Random(self.seed)
        self.sleep = sleep
        self._lock = threading.Lock()
        if registry is None:
            from predictionio_tpu_torch.obs import get_registry
            registry = get_registry()
        self._c_injected = registry.counter(
            "pio_faults_injected_total",
            "Chaos-harness injections by target and kind",
            labelnames=("target", "kind"))

    def before(self, target: str):
        """Consult the spec at an operation's entry: maybe inject
        latency, then maybe raise. Call sites place this BEFORE the
        real work so an injected error never half-applies the op."""
        rule = self.spec.rule_for(target)
        if rule is None:
            return
        error = rule.error or 0.0
        partition = rule.partition or 0.0
        latency_ms = rule.latency_ms or 0.0
        latency_rate = 1.0 if rule.latency_rate is None \
            else rule.latency_rate
        with self._lock:
            r_lat = self.rng.random() if latency_ms > 0 else 1.0
            r_err = self.rng.random() if error > 0 else 1.0
            r_part = self.rng.random() if partition > 0 else 1.0
        if latency_ms > 0 and r_lat < latency_rate:
            self._c_injected.labels(target=target, kind="latency").inc()
            self.sleep(latency_ms / 1000.0)
        if partition > 0 and r_part < partition:
            self._c_injected.labels(target=target, kind="partition").inc()
            raise ConnectionError(
                f"injected network partition on {target}")
        if error > 0 and r_err < error:
            self._c_injected.labels(target=target, kind="error").inc()
            raise InjectedFault(f"injected fault on {target}")

    def corrupt_array(self, target: str, arr):
        """Maybe NaN-corrupt a float numpy array at an opted-in site
        (``fold.ratings``, ``fold.factors``). Returns
        ``(array, injected)`` — the original object untouched when the
        seeded decision says no. The whole array goes NaN, which is the
        realistic shape of an ALS blow-up: one non-finite row poisons
        the shared Gram and the next sweep spreads it to every solve."""
        import numpy as _np
        rule = self.spec.rule_for(target)
        p = (rule.corrupt or 0.0) if rule is not None else 0.0
        if p <= 0.0:
            return arr, False
        with self._lock:
            r = self.rng.random()
        if r >= p:
            return arr, False
        self._c_injected.labels(target=target, kind="corrupt").inc()
        logger.warning("chaos: NaN-corrupting %s", target)
        return _np.full_like(_np.asarray(arr, dtype=_np.float32),
                             _np.nan), True

    def wrap_callable(self, target: str, fn: Callable) -> Callable:
        """Chaos-wrap any hop (an HTTP request function, a publish):
        the injector consults ``target`` before each call."""
        def wrapped(*args, **kwargs):
            self.before(target)
            return fn(*args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped


class FaultyEvents(base.Events):
    """An ``Events`` DAO with chaos injection at every operation entry.
    Write ops consult ``storage.write``, read ops ``storage.read`` —
    the granularity the spill/replay and breaker-gated-tail paths
    degrade on."""

    def __init__(self, inner: base.Events, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    # -- writes -------------------------------------------------------------
    def insert(self, event, app_id, channel_id=None):
        self.injector.before("storage.write")
        return self.inner.insert(event, app_id, channel_id)

    def insert_batch(self, events, app_id, channel_id=None):
        self.injector.before("storage.write")
        return self.inner.insert_batch(events, app_id, channel_id)

    def insert_columnar(self, batch, app_id, channel_id=None):
        # explicit forward: base.Events has a materialize-and-batch
        # default, so __getattr__ would bypass the backend's fast path
        self.injector.before("storage.write")
        return self.inner.insert_columnar(batch, app_id, channel_id)

    def delete(self, event_id, app_id, channel_id=None):
        self.injector.before("storage.write")
        return self.inner.delete(event_id, app_id, channel_id)

    # -- reads --------------------------------------------------------------
    def get(self, event_id, app_id, channel_id=None):
        self.injector.before("storage.read")
        return self.inner.get(event_id, app_id, channel_id)

    def find(self, app_id, channel_id=None, **kw):
        self.injector.before("storage.read")
        return self.inner.find(app_id, channel_id=channel_id, **kw)

    def find_columnar(self, app_id, channel_id=None, **kw):
        self.injector.before("storage.read")
        return self.inner.find_columnar(app_id, channel_id=channel_id,
                                        **kw)

    def find_columnar_by_entities(self, app_id, channel_id=None, **kw):
        # explicit forward (not __getattr__): base.Events defines a
        # fallback impl, so attribute lookup would otherwise run the
        # un-faulted full-scan default instead of the backend's pushdown
        self.injector.before("storage.read")
        return self.inner.find_columnar_by_entities(
            app_id, channel_id=channel_id, **kw)

    def aggregate_properties(self, app_id, channel_id=None, **kw):
        self.injector.before("storage.read")
        return self.inner.aggregate_properties(app_id,
                                               channel_id=channel_id, **kw)

    # -- lifecycle / passthrough -------------------------------------------
    def init(self, app_id, channel_id=None):
        return self.inner.init(app_id, channel_id)

    def remove(self, app_id, channel_id=None):
        return self.inner.remove(app_id, channel_id)

    def close(self):
        return self.inner.close()

    def __getattr__(self, name):
        # backend-specific extras pass through un-faulted; only the
        # Events surface above is chaos-gated
        return getattr(self.inner, name)


_ENV_INJECTOR: Optional[FaultInjector] = None
_ENV_LOCK = threading.Lock()


def injector_from_env() -> Optional[FaultInjector]:
    """The process-wide injector for ``PIO_FAULTS``, or None when the
    env is unset/empty. One injector per process so the seeded decision
    stream is shared by every wrapped surface."""
    global _ENV_INJECTOR
    spec_s = os.environ.get(ENV_VAR, "").strip()
    if not spec_s:
        return None
    with _ENV_LOCK:
        if _ENV_INJECTOR is None or _ENV_INJECTOR._spec_string != spec_s:
            spec = FaultSpec.parse(spec_s)
            inj = FaultInjector(spec)
            inj._spec_string = spec_s
            _ENV_INJECTOR = inj
            logger.warning("chaos harness ACTIVE: %s=%s (seed=%d)",
                           ENV_VAR, spec_s, inj.seed)
        return _ENV_INJECTOR


def reset_env_injector():
    """Forget the cached env injector (tests toggling PIO_FAULTS)."""
    global _ENV_INJECTOR
    with _ENV_LOCK:
        _ENV_INJECTOR = None


def maybe_corrupt_array(target: str, arr):
    """Module-level corruption hook for the fold path: consults the
    process-wide ``PIO_FAULTS`` injector; identity when chaos is off or
    the target has no ``corrupt=`` clause. Returns ``(array, bool)``."""
    inj = injector_from_env()
    if inj is None:
        return arr, False
    return inj.corrupt_array(target, arr)


def maybe_wrap_events(events: base.Events) -> base.Events:
    """Chaos-wrap an events DAO when ``PIO_FAULTS`` names any
    ``storage*`` target; identity otherwise. The storage registry calls
    this on every events object it hands out."""
    inj = injector_from_env()
    if inj is None:
        return events
    if not any(t == "storage" or t.startswith("storage.")
               for t in inj.spec.rules):
        return events
    if isinstance(events, FaultyEvents):
        return events
    return FaultyEvents(events, inj)
