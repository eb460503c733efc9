"""Per-executable compile and device-time attribution.

The port's copy of `predictionio_tpu/obs/costmon.py`. It attributes
what the card spends to a stable **executable label**, the handful of
programs the system runs: `als_sweep`, `fold_side`, `batch_predict`,
`batch_predict_masked`, `gates_probe`.

Compile attribution. Call sites wrap their dispatch in
`executable(label)`. What the port compiles are the `nvcc` builds of its
kernels and the CUDA graphs it captures; `obs/torchmon.record_compile`
reports each on the thread that paid it, and a contextvar label plus a
thread-local accumulator book it to the scope:

- `pio_compile_executable_seconds_total{executable}`: compile wall;
- `pio_compile_cache_hits_total{executable}` /
  `pio_compile_cache_misses_total{executable}`: a scope that built or
  captured nothing was a hit;
- `pio_compile_pcache_hits_total{executable}` /
  `..._misses_total{executable}`: a kernel library found built in the
  salted build directory (`compile/cache.py`), or built by `nvcc`.

Device time. `device_timed(label, fn, *args)` counts every dispatch's
enqueue wall into `pio_dispatch_seconds_total{executable,tenant}`.
Every `PIO_DEVICE_SYNC_EVERY`-th dispatch per label (default 16, the
first included; 0 turns the sampling off) reads a CUDA event pair
around its work on the current stream (a captured graph's own stamps,
`compile/aot.GraphExecutable`). Once the end event has passed,
the elapsed device time, multiplied by the sampling factor, goes into
`pio_device_time_seconds_total{executable,tenant}`, the sampled walls
into a per-label ring (`device_time_percentiles`) and the estimate into
the `pio_device_occupancy` EWMA, which the micro-batcher's adaptive
sizing reads (`occupancy()`). The reference syncs the sampled dispatch
(`block_until_ready`) and books its wall, host dispatch included; the
port reads the card's own time without the host's enqueue in it, and
blocks no dispatch for it but one: a graph's next replay first waits for
a sampled previous replay (whose stamps it would overwrite). A sample is
read when a later dispatch or a read of these views finds its work
complete (`harvest()` reads what has passed, `flush()` waits for all).
Work on CPU tensors is synchronous, so its sampled wall is booked at
once, as the reference's is. A sampled dispatch inside a trace sets
`deviceMs` on the span open at the dispatch when its sample is booked,
as the reference's annotates the span after its sync.

`install()` also mounts `pio_hbm_table_bytes{table}`, the device bytes
of each residency slot of `utils/device_cache`.

Cost analysis. `analyze_jit(label, fn, *args)` banks a program's FLOPs
and bytes per label (`pio_executable_flops{executable}`,
`pio_executable_bytes_accessed{executable}`), the reference's reading of
XLA's `cost_analysis()`. torch has no compiled program to ask, so the
port runs `fn` once under `executable(label)`, on the tensors' own
device, and counts: FLOPs with `torch.utils.flop_counter.FlopCounterMode`,
bytes as each aten op's input and output tensor bytes (view ops, which
move none, are skipped). Like the reference's, it pays one run, meant for
bench and smoke paths, never a serving path. `record_cost_analysis(label,
compiled)` banks anything exposing `cost_analysis()`, as the reference's.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from predictionio_tpu_torch.obs import torchmon
from predictionio_tpu_torch.obs.metrics import get_registry
from predictionio_tpu_torch.obs.tenantctx import metric_tenant_label
from predictionio_tpu_torch.obs.trace import TRACER

logger = logging.getLogger(__name__)

#: the canonical labels
ALS_SWEEP = "als_sweep"
FOLD_SIDE = "fold_side"
BATCH_PREDICT = "batch_predict"
BATCH_PREDICT_MASKED = "batch_predict_masked"
GATES_PROBE = "gates_probe"

_label_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "pio_exec_label", default=None)
_tls = threading.local()

_lock = threading.Lock()
_installed = False
_c_seconds = None
_c_hits = None
_c_misses = None
_c_pc_hits = None
_c_pc_misses = None
_c_dispatch_s = None
_c_device_s = None
_c_device_syncs = None
_g_occupancy = None
_g_tenant_occ = None
_g_flops = None
_g_bytes = None


def install(registry=None):
    """Register the families and the compile listeners. Idempotent."""
    global _installed, _c_seconds, _c_hits, _c_misses, _c_pc_hits, \
        _c_pc_misses, _c_dispatch_s, _c_device_s, _c_device_syncs, \
        _g_occupancy, _g_tenant_occ, _g_flops, _g_bytes
    with _lock:
        if _installed:
            return
        _installed = True
        reg = registry or get_registry()
        _c_seconds = reg.counter(
            "pio_compile_executable_seconds_total",
            "nvcc build and graph capture wall time attributed to the "
            "executable label whose dispatch triggered it",
            labelnames=("executable",))
        _c_hits = reg.counter(
            "pio_compile_cache_hits_total",
            "executable() scopes that built and captured nothing",
            labelnames=("executable",))
        _c_misses = reg.counter(
            "pio_compile_cache_misses_total",
            "executable() scopes that ran an nvcc build or a graph "
            "capture", labelnames=("executable",))
        _g_flops = reg.gauge(
            "pio_executable_flops",
            "FLOPs of the last analyzed run of each executable label "
            "(torch.utils.flop_counter)", labelnames=("executable",))
        _g_bytes = reg.gauge(
            "pio_executable_bytes_accessed",
            "Bytes its aten ops read and wrote in the last analyzed run of "
            "each executable label", labelnames=("executable",))
        _c_pc_hits = reg.counter(
            "pio_compile_pcache_hits_total",
            "kernel libraries found built in the salted build directory "
            "by the executable label that loaded them",
            labelnames=("executable",))
        _c_pc_misses = reg.counter(
            "pio_compile_pcache_misses_total",
            "kernel libraries built by nvcc into the salted build "
            "directory, by executable", labelnames=("executable",))
        reg.gauge_func(
            "pio_hbm_table_bytes",
            "Device bytes held by each named residency slot in "
            "utils/device_cache (per-table accounting)",
            _hbm_table_samples)
        _c_dispatch_s = reg.counter(
            "pio_dispatch_seconds_total",
            "Wall time spent in dispatch calls (the enqueue, not device "
            "execution) by executable label and serving tenant (empty = "
            "untenanted)", labelnames=("executable", "tenant"))
        _c_device_s = reg.counter(
            "pio_device_time_seconds_total",
            "Estimated device time by executable and serving tenant: "
            "each 1-in-N sampled dispatch's CUDA-event time, multiplied "
            "by the sampling factor", labelnames=("executable", "tenant"))
        _c_device_syncs = reg.counter(
            "pio_device_syncs_total",
            "Sampled dispatches whose device time was measured",
            labelnames=("executable", "tenant"))
        _g_occupancy = reg.gauge(
            "pio_device_occupancy",
            "EWMA fraction of wall-clock time the device spent executing "
            "attributed work (clamped to 1; from the sampled device-time "
            "estimates)")
        _g_tenant_occ = reg.gauge(
            "pio_tenant_occupancy_share",
            "Per-tenant EWMA share of wall-clock device occupancy (from "
            "the sampled device-time estimates; decays when a tenant "
            "stops dispatching)", labelnames=("tenant",))
    torchmon.add_compile_listener(_on_compile)
    torchmon.add_pcache_listener(_on_pcache)


def _on_compile(secs: float):
    _tls.compile_s = getattr(_tls, "compile_s", 0.0) + secs
    label = _label_ctx.get() or "unlabeled"
    _c_seconds.labels(executable=label).inc(max(secs, 0.0))


def _on_pcache(hit: bool):
    label = _label_ctx.get() or "unlabeled"
    (_c_pc_hits if hit else _c_pc_misses).labels(executable=label).inc()


def _hbm_table_samples():
    from predictionio_tpu_torch.utils import device_cache
    sizes = device_cache.resident_sizes()
    return [({"table": name}, float(nbytes))
            for name, nbytes in sorted(sizes.items())]


@contextmanager
def executable(label: str, defer_to_outer: bool = False):
    """Attribute any build or capture inside this scope to `label` and
    count the scope as a hit or a miss. `defer_to_outer`: a shared
    kernel dispatched from several higher-level executables defers
    entirely to the caller's scope when one is active."""
    if not _installed:
        install()
    if defer_to_outer and _label_ctx.get() is not None:
        yield
        return
    token = _label_ctx.set(label)
    before = getattr(_tls, "compile_s", 0.0)
    ok = False
    try:
        yield
        ok = True
    finally:
        _label_ctx.reset(token)
        # clean exits only: a body that raised compiled nothing worth
        # counting as a hit
        if ok:
            if getattr(_tls, "compile_s", 0.0) > before:
                _c_misses.labels(executable=label).inc()
            else:
                _c_hits.labels(executable=label).inc()


# -- device-time attribution ------------------------------------------------

def _sync_every_default() -> int:
    try:
        return max(0, int(os.environ.get("PIO_DEVICE_SYNC_EVERY", 16)))
    except (TypeError, ValueError):
        return 16


class _DeviceState:
    """Per-(label, tenant) hot-path state: resolved counter children, an
    atomic dispatch tick for the 1-in-N sampling decision, and a bounded
    ring of sampled device times for percentile views."""

    __slots__ = ("dispatch_s", "device_s", "syncs", "tick", "ring",
                 "every", "tenant")

    def __init__(self, label: str, tenant: str, every: int):
        self.tenant = tenant
        self.dispatch_s = _c_dispatch_s.labels(executable=label,
                                               tenant=tenant)
        self.device_s = _c_device_s.labels(executable=label,
                                           tenant=tenant)
        self.syncs = _c_device_syncs.labels(executable=label,
                                            tenant=tenant)
        self.tick = itertools.count()       # next() is GIL-atomic
        self.ring = collections.deque(maxlen=128)
        self.every = every


_dev_lock = threading.Lock()
_dev_state: Dict[tuple, _DeviceState] = {}
# sampled dispatches not read yet: `poll(wait) -> bool`, True once the
# sample is booked
_pending: list = []
# process occupancy: estimated device seconds accumulate into a ~1 s
# wall window shared by every label; the EWMA updates once a window
_OCC_WINDOW_S = 1.0
_occ_window_t0: Optional[float] = None
_occ_acc = 0.0
_occ_ewma = 0.0
_occ_acc_tenant: Dict[str, float] = {}
_occ_share_ewma: Dict[str, float] = {}


def _device_state(label: str, tenant: str = "") -> _DeviceState:
    st = _dev_state.get((label, tenant))
    if st is None:
        if not _installed:
            install()
        with _dev_lock:
            st = _dev_state.get((label, tenant))
            if st is None:
                every = _sync_every_default()
                # a tenant's scope inherits the untenanted state's
                # cadence, so `st.every = 0` governs label-wide
                base = _dev_state.get((label, ""))
                if base is not None:
                    every = base.every
                st = _DeviceState(label, tenant, every)
                _dev_state[(label, tenant)] = st
    return st


def _note_device_time(est_s: float, tenant: str = ""):
    """Fold one sampled dispatch's extrapolated device seconds into the
    occupancy window; when the window (~1 s) closes, its estimate over
    its wall becomes the instantaneous occupancy feeding the EWMA
    (clamped to 1). The same window's per-tenant split feeds the
    `pio_tenant_occupancy_share` EWMAs."""
    global _occ_window_t0, _occ_acc, _occ_ewma
    with _dev_lock:
        now = time.monotonic()
        if _occ_window_t0 is None:
            _occ_window_t0 = now
        _occ_acc += est_s
        if tenant:
            _occ_acc_tenant[tenant] = \
                _occ_acc_tenant.get(tenant, 0.0) + est_s
        wall = now - _occ_window_t0
        if wall >= _OCC_WINDOW_S:
            inst = min(_occ_acc / wall, 1.0)
            _occ_ewma = (inst if _occ_ewma == 0.0
                         else 0.7 * _occ_ewma + 0.3 * inst)
            _g_occupancy.set(round(_occ_ewma, 4))
            for t in set(_occ_share_ewma) | set(_occ_acc_tenant):
                inst_t = min(_occ_acc_tenant.get(t, 0.0) / wall, 1.0)
                old = _occ_share_ewma.get(t, 0.0)
                share = (inst_t if old == 0.0
                         else 0.7 * old + 0.3 * inst_t)
                if share < 1e-6:
                    _occ_share_ewma.pop(t, None)
                    share = 0.0
                else:
                    _occ_share_ewma[t] = share
                _g_tenant_occ.labels(tenant=t).set(round(share, 4))
            _occ_window_t0 = now
            _occ_acc = 0.0
            _occ_acc_tenant.clear()


def _book(st: _DeviceState, wall: float, every: int, span=None) -> None:
    """Book one sampled dispatch's measured device time `wall`; `span`,
    the trace span open at the dispatch, gains `deviceMs` (a slow-query
    waterfall's `device_sync` stage)."""
    est = wall * every
    st.device_s.inc(est)
    st.syncs.inc()
    with _dev_lock:   # percentile reads copy under it
        st.ring.append(wall)
    _note_device_time(est, st.tenant)
    if span is not None:
        span.attrs["deviceMs"] = round(wall * 1000.0, 3)
        span.attrs["deviceSampled"] = every


def _harvest(wait: bool = False) -> None:
    """Book every pending sample whose work has passed (all of them,
    waiting, with `wait`)."""
    if not _pending:
        return
    with _dev_lock:
        todo = list(_pending)
    for poll in todo:
        with _dev_lock:       # claimed by one thread only
            if poll not in _pending:
                continue
            _pending.remove(poll)
        if not poll(wait):
            with _dev_lock:
                _pending.append(poll)


def _event_pair_poll(st: _DeviceState, every: int, start, end, span):
    def poll(wait: bool) -> bool:
        if not wait and not end.query():
            return False
        end.synchronize()
        _book(st, start.elapsed_time(end) / 1e3, every, span)
        return True
    return poll


def harvest() -> None:
    """Book the sampled dispatches whose work has passed (no wait)."""
    _harvest()


def flush() -> None:
    """Wait for every sampled dispatch in flight and book it."""
    _harvest(wait=True)


def _on_card(args) -> bool:
    import torch
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


def device_timed(label: str, fn, *args):
    """Dispatch `fn(*args)` under device-time attribution for `label`.
    The unsampled path costs two perf_counter reads, a dict get, an
    atomic tick and a counter increment. Every `PIO_DEVICE_SYNC_EVERY`-th
    dispatch per label (the first included) also records a CUDA event
    before and after the work when an argument lies on the card; its
    elapsed time, multiplied by the sampling factor, is booked as device
    time once the end event has passed (no dispatch waits for it). On
    CPU tensors the work is synchronous and the sampled wall is booked
    at once. A callable with `records_events` (a captured graph) stamps
    its own work with the timing events it captured, and takes the
    booking as `sample=`: a pair recorded from the host around a launch
    would also time the gap while the launching thread waits for the
    interpreter lock. A sampled dispatch that paid a build or a capture
    on this thread books nothing: its time is compile, not steady
    state. Inside a trace, the span open at a sampled dispatch gains
    `deviceMs` when its sample is booked (no wait is added for it)."""
    _harvest()
    st = _device_state(label, metric_tenant_label())
    every = st.every
    sampled = bool(every) and next(st.tick) % every == 0
    span = TRACER.current_span() if sampled else None
    t0 = time.perf_counter()
    if sampled and getattr(fn, "records_events", False):
        # a captured graph stamps its own work on every replay
        out = fn(*args, sample=lambda s: _book(st, s, every, span))
        st.dispatch_s.inc(time.perf_counter() - t0)
        with _dev_lock:
            _pending.append(fn.poll)
        return out
    events = None
    if sampled and _on_card(args):
        import torch
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    compile_before = getattr(_tls, "compile_s", 0.0)
    out = fn(*args)
    if events is not None:
        events[1].record()
    st.dispatch_s.inc(time.perf_counter() - t0)
    if not sampled:
        return out
    if getattr(_tls, "compile_s", 0.0) > compile_before:
        return out
    if events is not None:
        with _dev_lock:
            _pending.append(_event_pair_poll(st, every, *events, span))
    else:
        _book(st, time.perf_counter() - t0, every, span)
    return out


def occupancy() -> float:
    """The current `pio_device_occupancy` EWMA (0..1), the adaptive
    micro-batch sizer's device-pressure signal."""
    _harvest()
    return _occ_ewma


def tenant_occupancy_shares() -> Dict[str, float]:
    """{tenant: EWMA occupancy share}."""
    _harvest()
    with _dev_lock:
        return {t: round(v, 4) for t, v in _occ_share_ewma.items()}


def device_time_by_tenant() -> Dict[str, float]:
    """{tenant label value: cumulative estimated device seconds} summed
    across executables (`""` = untenanted dispatches)."""
    _harvest()
    out: Dict[str, float] = {}
    if _c_device_s is None:
        return out
    for labels, v in _c_device_s.samples():
        if not labels:
            continue
        t = labels.get("tenant", "")
        out[t] = out.get(t, 0.0) + v
    return {t: round(v, 4) for t, v in out.items()}


def tenant_device_time_share() -> Dict[str, float]:
    """{tenant: fraction of all attributed device seconds}, the `""`
    untenanted share included (the values sum to 1 once any device time
    was booked): the serving host's `deviceTimeShare`."""
    by_tenant = device_time_by_tenant()
    total = sum(by_tenant.values())
    if total <= 0:
        return {}
    return {t: round(v / total, 4) for t, v in by_tenant.items()}


def device_time_by_executable() -> Dict[str, float]:
    """{label: estimated device seconds}."""
    _harvest()
    return {k: round(v, 4)
            for k, v in _labeled_values(_c_device_s).items()}


def dispatch_seconds_by_executable() -> Dict[str, float]:
    return {k: round(v, 4)
            for k, v in _labeled_values(_c_dispatch_s).items()}


def device_samples_by_executable() -> Dict[str, float]:
    """{label: sampled dispatches booked}."""
    _harvest()
    return _labeled_values(_c_device_syncs)


def device_time_percentiles(label: str) -> Optional[Dict[str, float]]:
    """p50/p99 of the sampled per-dispatch device times (ms) for one
    label (merged across tenants); None before the first sample."""
    _harvest()
    states = [st for (lab, _t), st in list(_dev_state.items())
              if lab == label]
    if not states:
        return None
    with _dev_lock:
        walls = sorted(w for st in states for w in st.ring)
    if not walls:
        return None

    def pick(q):
        return walls[min(len(walls) - 1, int(q / 100.0 * len(walls)))]
    return {"p50_ms": round(pick(50) * 1000.0, 4),
            "p99_ms": round(pick(99) * 1000.0, 4),
            "samples": len(walls)}


def device_snapshot() -> Dict[str, object]:
    """The /stats.json `deviceTime` block: estimated device seconds per
    executable, the occupancy EWMA and the sampling factor."""
    _harvest()
    out = {
        "secondsByExecutable": device_time_by_executable(),
        "dispatchSecondsByExecutable":
            dispatch_seconds_by_executable(),
        "occupancy": round(_occ_ewma, 4),
        "syncEvery": _sync_every_default(),
    }
    by_tenant = device_time_by_tenant()
    if any(t for t in by_tenant):
        out["secondsByTenant"] = by_tenant
        out["tenantOccupancyShare"] = tenant_occupancy_shares()
    labels = {lab for (lab, _t) in list(_dev_state)}
    pct = {label: device_time_percentiles(label) for label in labels}
    out["sampledWallMs"] = {k: v for k, v in pct.items()
                            if v is not None}
    return out


# -- cost analysis ----------------------------------------------------------

class CostAnalysis:
    """One counted run's cost, read as the reference reads a compiled
    program's: `cost_analysis()` -> {"flops", "bytes accessed"}."""

    __slots__ = ("flops", "bytes_accessed")

    def __init__(self, flops: float, bytes_accessed: float):
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)

    def cost_analysis(self) -> dict:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}


def _tensor_bytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _byte_counter():
    """A dispatch mode that sums each non-view aten op's input and output
    tensor bytes into `.nbytes`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ByteCounter(TorchDispatchMode):
        nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.nbytes += _tensor_bytes((args, kwargs)) \
                    + _tensor_bytes(out)
            return out
    return ByteCounter()


def record_cost_analysis(label: str, compiled) -> Optional[dict]:
    """Bank `compiled.cost_analysis()` FLOPs and bytes under `label`.
    Accepts anything exposing `cost_analysis` (a `CostAnalysis`); returns
    the extracted {"flops", "bytes_accessed"}, or None when it has
    none."""
    if not _installed:
        install()
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0] if cost else {}
        flops = float(cost.get("flops", 0.0))
        nbytes = float(cost.get("bytes accessed", 0.0))
    except Exception as e:
        logger.debug("cost_analysis unavailable for %s: %s", label, e)
        return None
    _g_flops.labels(executable=label).set(flops)
    _g_bytes.labels(executable=label).set(nbytes)
    return {"flops": flops, "bytes_accessed": nbytes}


def analyze_jit(label: str, fn, *args, **kwargs) -> Optional[dict]:
    """Run `fn(*args, **kwargs)` once under `executable(label)`, count
    its FLOPs and bytes, and bank them (`record_cost_analysis`). The run
    is on the arguments' own device (a CUDA tensor stays on the card);
    an error of `fn` raises. Pays one run: bench and smoke only, never a
    serving path."""
    from torch.utils.flop_counter import FlopCounterMode
    with executable(label):
        with FlopCounterMode(display=False) as flops, \
                _byte_counter() as nbytes:
            fn(*args, **kwargs)
    return record_cost_analysis(
        label, CostAnalysis(flops.get_total_flops(), nbytes.nbytes))


# -- bench/JSON views -------------------------------------------------------
def _labeled_values(counter) -> Dict[str, float]:
    """Sum per executable label (families that also carry a tenant label
    collapse across tenants here)."""
    if counter is None:
        return {}
    out: Dict[str, float] = {}
    for labels, v in counter.samples():
        if not labels:
            continue
        k = labels["executable"]
        out[k] = out.get(k, 0.0) + v
    return out


def compile_seconds_by_executable() -> Dict[str, float]:
    return {k: round(v, 4)
            for k, v in _labeled_values(_c_seconds).items()}


def cache_counts() -> Dict[str, Dict[str, float]]:
    """{"hits": {label: n}, "misses": {label: n}}."""
    return {"hits": _labeled_values(_c_hits),
            "misses": _labeled_values(_c_misses)}


def pcache_counts() -> Dict[str, Dict[str, float]]:
    """Build-directory {"hits": {label: n}, "misses": {label: n}}."""
    return {"hits": _labeled_values(_c_pc_hits),
            "misses": _labeled_values(_c_pc_misses)}


def pcache_totals() -> Dict[str, float]:
    """Process-wide build-directory hit/miss totals (all labels)."""
    c = pcache_counts()
    return {"hits": sum(c["hits"].values()),
            "misses": sum(c["misses"].values())}
