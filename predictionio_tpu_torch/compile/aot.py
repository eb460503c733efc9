"""The executable registry: CUDA graphs captured at deploy time,
replayed at serve time.

The port's counterpart of `predictionio_tpu/compile/aot.py`, whose
registry lowers and compiles a jitted program once per shape bucket and
dispatches the held `jax.Compiled`. Here the held executable is a
`torch.cuda.CUDAGraph` captured for one (label, bucket, owner), with
static input and output buffers:

- **Spec.** `register(label, builder)`; `builder(bound, **dims)` returns
  `(fn, example_args)`: `fn(*args)` runs the program eagerly on device
  tensors shaped like `example_args`. `bound` is a tuple of owner
  objects (a model) whose device tables `fn` reads: a graph bakes in the
  addresses of what it read, so each executable is keyed on its owners
  as well as its bucket, holds the tables it captured, and is dropped
  when an owner is garbage-collected (a weak reference's callback). A
  new model's executables are captured before the swap
  (`warm_models`); the retired model's go with it, and no replay ever
  reads freed tables.
- **Capture.** On the card, the example arguments are cloned into static
  inputs, `fn` runs twice on the device's capture stream (the warm-up
  that lets libraries set up their handles), and is captured with
  `capture_error_mode="thread_local"`, so a capture in a background
  thread (`ensure(background=True)`) does not stop the serving threads'
  work; that thread runs in the caller's context, so what it uploads
  carries the caller's tenant tag. A capture counts as a compile
  (`obs/torchmon`) under its label. Since a graph holds what it
  captured, its tables are freed only with it: `drop_owners` drops the
  executables of given owners (a serving host's eviction; the
  reference's tenants share one executable per shape, the port's keep
  their own). `capture_quiesced()` waits for the captures in flight and
  holds new ones off (a device trace's start and stop,
  `obs/profiler.py`: a device-wide synchronize would invalidate a
  capture in flight).
- **One capture stream a device.** Every warm-up and capture of the
  process runs on one side stream per device (`capture_stream`), never
  on a fresh pool stream: cuBLAS keeps a workspace (32 MiB on Hopper)
  for each stream it has run on, so a fresh stream a capture would
  leave up to one workspace a pool stream (32 of them) outside any
  tenant's budget. Because the stream is shared, captures never
  interleave on it:
  `capture_slot()` admits one thread at a time (re-entrant within that
  thread), through the same `_capture_cv` accounting that
  `capture_quiesced()` reads, so `_captures_inflight` is 0 or 1.
- **Dispatch.** `dispatch(label, dims, fallback, *args, bound=)` copies
  the arguments (device tensors: a host copy cannot be captured, so the
  caller stages them) into the static inputs, replays the graph and
  clones the outputs on the stream, so two windows in flight each read
  their own. A bucket without an executable runs `fallback(*args)`, the
  same ops and kernels eagerly, counts a miss and schedules a background
  capture. Every dispatch runs under `obs/costmon.device_timed`.
- **On the CPU** (the tests) the held executable is `fn` itself, so the
  keys, hits and misses, the failed-bucket memo, the waits on in-flight
  captures, background adoption and the snapshot behave as on the card.

The counters are the reference's: `pio_aot_compile_seconds_total
{executable,bucket}` (capture seconds), `pio_aot_dispatch_{hits,misses,
fallbacks}_total{executable}` and `pio_aot_executables_resident`.

`shared_jit(key, impl)` is the reference's memoized `jax.jit` table;
torch has no jit to cache, so it is a table of callables: the first
registered `impl` for a key is the one every caller gets.

`PIO_AOT=off` turns every dispatch into the fallback call;
`PIO_AOT_WARM=off` stops `warm_models` from capturing at deploy and
swap. Unlike the reference's fail-soft warm, a capture that fails during
`warm_models` raises, so a deploy's `load()` fails as the port's
warm-up always has.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional

from predictionio_tpu_torch.compile.buckets import bucket_key, bucket_label
from predictionio_tpu_torch.obs import costmon, torchmon
from predictionio_tpu_torch.obs.costmon import device_timed

logger = logging.getLogger(__name__)

#: eager runs on the side stream before a capture
WARMUP_RUNS = 2


def aot_enabled() -> bool:
    return os.environ.get("PIO_AOT", "").lower() not in (
        "off", "0", "false", "no")


def warm_enabled() -> bool:
    """Deploy and swap-time capture, which can be turned off apart from
    dispatch (`PIO_AOT_WARM=off`): dispatch and background adoption keep
    working, but a model change no longer captures its ladder."""
    return os.environ.get("PIO_AOT_WARM", "").lower() not in (
        "off", "0", "false", "no")


# captures in flight (at most one: `capture_slot`), and callers holding
# new ones off
_capture_cv = threading.Condition()
_captures_inflight = 0
_capture_holds = 0
_slot_owner = threading.local()
_capture_streams: Dict[Any, Any] = {}


@contextlib.contextmanager
def capture_quiesced():
    """Wait until no CUDA-graph capture is in flight and start none
    while the block runs."""
    global _capture_holds
    with _capture_cv:
        _capture_holds += 1
        while _captures_inflight:
            _capture_cv.wait()
    try:
        yield
    finally:
        with _capture_cv:
            _capture_holds -= 1
            _capture_cv.notify_all()


def capture_stream(device):
    """The process's one capture stream for `device` (created at first
    use and kept): every warm-up and capture runs on it, so cuBLAS sets
    up one workspace for captures, not one per pool stream."""
    import torch
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    with _capture_cv:
        stream = _capture_streams.get(dev)
        if stream is None:
            stream = _capture_streams[dev] = torch.cuda.Stream(dev)
        return stream


def capture_streams() -> int:
    """How many capture streams the process has made (one a device)."""
    with _capture_cv:
        return len(_capture_streams)


@contextlib.contextmanager
def capture_slot():
    """Hold the process's capture slot: one thread at a time warms up
    and captures on the shared capture streams. Re-entrant in the
    holding thread (a fused train captures several graphs in one slot);
    waits while `capture_quiesced()` holds captures off."""
    global _captures_inflight
    if getattr(_slot_owner, "depth", 0):
        _slot_owner.depth += 1
        try:
            yield
        finally:
            _slot_owner.depth -= 1
        return
    with _capture_cv:
        while _capture_holds or _captures_inflight:
            _capture_cv.wait()
        _captures_inflight += 1
    _slot_owner.depth = 1
    try:
        yield
    finally:
        _slot_owner.depth = 0
        with _capture_cv:
            _captures_inflight -= 1
            _capture_cv.notify_all()


def capture(graph, fn: Callable, device, pool=None):
    """Capture `fn()` into `graph` on the device's capture stream with
    `capture_error_mode="thread_local"`, inside the capture slot, and
    return what `fn` returned. Unlike `torch.cuda.graph` it neither
    synchronizes the device nor empties the allocator's cache: a
    capture in one thread must not stop another thread's work, and a
    device-wide synchronize while another thread captures would
    invalidate that capture (so the port synchronizes streams,
    `device.synchronize`, never the device). `pool` shares a memory
    pool between graphs."""
    import torch
    with capture_slot():
        side = capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
    return out


def _tree(fn, out):
    """`fn` applied to every tensor of a tensor or a tuple of them."""
    if isinstance(out, tuple):
        return tuple(fn(t) for t in out)
    return fn(out)


class GraphExecutable:
    """One captured graph: static inputs, the graph, static outputs and
    the device tables the program reads (kept alive while it is held).

    The graph begins and ends with a timing event of its own (`external`
    events become record nodes of the graph), so every replay stamps the
    device time of its own work, with no host launch gap inside it. A
    sampled dispatch (`costmon.device_timed`) hands in `sample`, a
    callback; the stamps are read for it once the replay has finished
    (`poll`), or, at the latest, before the next replay writes them
    again."""

    #: `costmon.device_timed` hands a sampled dispatch's callback in
    records_events = True

    def __init__(self, fn: Callable, example_args: tuple):
        import torch
        dev = example_args[0].device
        self.static_in = tuple(a.clone() for a in example_args)
        self.fn = fn              # holds the tables the graph reads
        self._marks = (torch.cuda.Event(enable_timing=True, external=True),
                       torch.cuda.Event(enable_timing=True, external=True))
        self._sample: Optional[Callable[[float], None]] = None

        def stamped():
            self._marks[0].record()
            out = fn(*self.static_in)
            self._marks[1].record()
            return out
        self.graph = torch.cuda.CUDAGraph()
        with capture_slot():
            side = capture_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_RUNS):
                    fn(*self.static_in)
            self.static_out = capture(self.graph, stamped, dev)
        self._lock = threading.Lock()

    def _read_sample(self) -> None:
        """Book the last replay's stamps (the lock is held)."""
        book, self._sample = self._sample, None
        self._marks[1].synchronize()
        book(self._marks[0].elapsed_time(self._marks[1]) / 1e3)

    def poll(self, wait: bool = False) -> bool:
        """Read a sampled replay's stamps once its work has passed (all
        at once with `wait`); True when nothing is left to read."""
        with self._lock:
            if self._sample is None:
                return True
            if not wait and not self._marks[1].query():
                return False
            self._read_sample()
            return True

    def __call__(self, *args, sample=None):
        """Stage `args` into the static inputs, replay, and return a copy
        of the outputs; `sample(seconds)` receives this replay's device
        time."""
        if len(args) != len(self.static_in) or any(
                a.shape != s.shape or a.dtype != s.dtype
                or a.device != s.device
                for a, s in zip(args, self.static_in)):
            raise TypeError("arguments do not match the captured shapes")
        with self._lock:
            if self._sample is not None:
                self._read_sample()
            for s, a in zip(self.static_in, args):
                s.copy_(a, non_blocking=True)
            self.graph.replay()
            self._sample = sample
            # the next replay overwrites the static outputs: each window
            # reads its own copy, made on the stream behind the replay
            return _tree(lambda t: t.clone(), self.static_out)


def _make_executable(fn: Callable, example_args: tuple):
    """A graph on the card; `fn` itself on the CPU."""
    if example_args and getattr(example_args[0], "is_cuda", False):
        return GraphExecutable(fn, example_args)
    return fn


class AOTRegistry:
    """Process-wide registry of captured executables, keyed by (label,
    bucket, owners). Thread-safe; captures happen outside the lock."""

    def __init__(self, registry=None):
        self._lock = threading.RLock()
        self._builders: Dict[str, Callable] = {}
        self._compiled: Dict[tuple, Any] = {}
        #: key -> (label, bucket label, version tag)
        self._meta: Dict[tuple, tuple] = {}
        #: key -> weak refs to its owners, whose callbacks drop the key
        self._refs: Dict[tuple, tuple] = {}
        #: key -> Event set when that key's capture finishes
        self._inflight: Dict[tuple, threading.Event] = {}
        #: key -> the exception its capture raised; never retried
        self._failed: Dict[tuple, BaseException] = {}
        self._threads: set = set()
        self._jits: Dict[str, Any] = {}
        self.compile_seconds = 0.0
        self.compile_count = 0
        if registry is None:
            from predictionio_tpu_torch.obs import get_registry
            registry = get_registry()
        self._c_compile_s = registry.counter(
            "pio_aot_compile_seconds_total",
            "CUDA-graph capture wall time (warm-up runs included) by "
            "executable and shape bucket",
            labelnames=("executable", "bucket"))
        self._c_hits = registry.counter(
            "pio_aot_dispatch_hits_total",
            "dispatches answered by replaying a held graph",
            labelnames=("executable",))
        self._c_misses = registry.counter(
            "pio_aot_dispatch_misses_total",
            "dispatches for a bucket with no held graph (run eagerly; "
            "background capture scheduled)", labelnames=("executable",))
        self._c_fallbacks = registry.counter(
            "pio_aot_dispatch_fallbacks_total",
            "held-graph calls rejected on argument shapes and re-served "
            "eagerly", labelnames=("executable",))

    # -- specs --------------------------------------------------------------
    def register(self, label: str, builder: Callable) -> None:
        """`builder(bound, **dims) -> (fn, example_args)`."""
        with self._lock:
            self._builders[label] = builder

    def has_spec(self, label: str) -> bool:
        with self._lock:
            return label in self._builders

    def _key(self, label: str, dims: Dict[str, int], bound: tuple):
        return (label, bucket_key(dims), tuple(id(o) for o in bound))

    def _evict(self, key) -> None:
        # weak-reference callback: lock-free pops (the collector may run
        # it while this thread holds the lock)
        self._compiled.pop(key, None)
        self._meta.pop(key, None)
        self._failed.pop(key, None)
        self._refs.pop(key, None)

    # -- capture ------------------------------------------------------------
    def ensure(self, label: str, dims: Dict[str, int], bound: tuple = (),
               background: bool = False, tag: Optional[str] = None
               ) -> Optional[Any]:
        """Capture (label, bucket, owners) if absent. Blocking by default
        (a deploy wants the executable held before traffic);
        `background=True` returns at once and adopts the executable when
        the daemon thread finishes."""
        if not aot_enabled():
            return None
        key = self._key(label, dims, bound)
        with self._lock:
            if key in self._compiled:
                if tag is not None:
                    self._meta[key] = self._meta[key][:2] + (tag,)
                return self._compiled[key]
            if key in self._failed:
                return None
            if label not in self._builders:
                return None
            pending = self._inflight.get(key)
            if pending is None:
                self._inflight[key] = threading.Event()
        if pending is not None:
            # another thread is capturing this key: a blocking caller
            # waits for it rather than skip the bucket
            if not background:
                pending.wait(timeout=600.0)
                return self._compiled.get(key)
            return None
        if background:
            # the capture thread enters the caller's context: its uploads
            # carry the caller's tenant tag (utils/device_cache)
            ctx = contextvars.copy_context()
            t = threading.Thread(
                target=ctx.run,
                args=(self._compile_one, label, dims, bound, key, tag),
                name=f"pio-aot-{label}", daemon=True)
            with self._lock:
                self._threads.add(t)
            t.start()
            return None
        return self._compile_one(label, dims, bound, key, tag)

    def _compile_one(self, label, dims, bound, key, tag):
        # weak references first: a failure is memoized for these owners
        # only, and forgotten with them as a held executable is
        refs = tuple(weakref.ref(o, lambda r, k=key: self._evict(k))
                     for o in bound)
        with self._lock:
            self._refs[key] = refs
        try:
            builder = self._builders[label]
            with costmon.executable(label):
                t0 = time.perf_counter()
                fn, args = builder(bound, **dims)
                exe = _make_executable(fn, tuple(args))
                dt = time.perf_counter() - t0
                if exe is not fn:
                    torchmon.record_compile(dt)
            self._c_compile_s.labels(
                executable=label, bucket=bucket_label(dims)).inc(dt)
            with self._lock:
                if all(r() is not None for r in refs):
                    self._compiled[key] = exe
                    self._meta[key] = (label, bucket_label(dims), tag)
                self.compile_seconds += dt
                self.compile_count += 1
            return exe
        except Exception as e:
            logger.warning("capture of %s %s failed; the bucket is "
                           "memoized as failed and dispatches run eagerly",
                           label, dims, exc_info=True)
            # the traceback's frames hold the owners: drop it, or the
            # memoized failure would keep a retired model alive
            e.__traceback__ = None
            with self._lock:
                self._failed[key] = e
            return None
        finally:
            with self._lock:
                ev = self._inflight.pop(key, None)
                self._threads.discard(threading.current_thread())
            if ev is not None:
                ev.set()

    def drop_owners(self, owners: Iterable[Any]) -> int:
        """Drop every executable (and memoized failure) keyed on one of
        `owners`, after waiting out their captures in flight (another
        owner's are not waited for), so the graphs release the tables
        they captured: the serving host's evictor. Returns the
        executables dropped."""
        owners = [o for o in owners if o is not None]
        ids = {id(o) for o in owners}
        with self._lock:
            pending = [ev for key, ev in self._inflight.items()
                       if ids.intersection(key[2])]
        for ev in pending:
            ev.wait(timeout=30.0)
        dropped = 0
        with self._lock:
            for key, refs in list(self._refs.items()):
                held = [r() for r in refs]
                if any(h is o for h in held for o in owners):
                    dropped += key in self._compiled
                    self._evict(key)
        return dropped

    def failure(self, label: str, dims: Dict[str, int], bound: tuple = ()
                ) -> Optional[BaseException]:
        """What the capture of this key raised, or None."""
        return self._failed.get(self._key(label, dims, bound))

    # -- dispatch -----------------------------------------------------------
    def lookup(self, label: str, dims: Dict[str, int], bound: tuple = ()
               ) -> Optional[Any]:
        return self._compiled.get(self._key(label, dims, bound))

    def dispatch(self, label: str, dims: Dict[str, int],
                 fallback: Callable, *args, bound: tuple = ()):
        """The held executable when the bucket is captured for these
        owners, else `fallback(*args)` (the same ops, eagerly) plus a
        background capture so the next window in the bucket replays.
        Every dispatch runs under `costmon.device_timed`."""
        if not aot_enabled():
            return device_timed(label, fallback, *args)
        exe = self._compiled.get(self._key(label, dims, bound))
        if exe is not None:
            try:
                out = device_timed(label, exe, *args)
                self._c_hits.labels(executable=label).inc()
                return out
            except TypeError:
                self._c_fallbacks.labels(executable=label).inc()
                logger.debug("executable %s %s rejected its arguments",
                             label, dims, exc_info=True)
        else:
            self._c_misses.labels(executable=label).inc()
            self.ensure(label, dims, bound, background=True)
        return device_timed(label, fallback, *args)

    # -- the table of shared callables ---------------------------------------
    def shared_jit(self, key: str, impl: Callable, **_kwargs):
        """The process-wide callable for `key`: the first `impl` given
        for it."""
        with self._lock:
            return self._jits.setdefault(key, impl)

    # -- warming ------------------------------------------------------------
    def warm(self, specs: Iterable[tuple], background: bool = False,
             tag: Optional[str] = None, strict: bool = False
             ) -> Dict[str, Any]:
        """Capture every `(label, dims)` or `(label, dims, bound)` row of
        `specs`; `strict` raises the first failed capture. Returns the
        summary the caller records."""
        t0 = time.perf_counter()
        compiled = skipped = 0
        for spec in specs:
            label, dims = spec[0], spec[1]
            bound = tuple(spec[2]) if len(spec) > 2 else ()
            if not self.has_spec(label):
                skipped += 1
                continue
            before = self.lookup(label, dims, bound) is not None
            self.ensure(label, dims, bound, background=background, tag=tag)
            if strict and not background:
                err = self.failure(label, dims, bound)
                if err is not None:
                    raise RuntimeError(
                        f"capture of {label} {bucket_label(dims)} failed: "
                        f"{err}") from err
            if not before and self.lookup(label, dims, bound) is not None:
                compiled += 1
        return {"compiled": compiled, "skipped": skipped,
                "wallS": round(time.perf_counter() - t0, 4)}

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Registry state for /stats.json: executables resident, buckets
        captured per label (and per version tag a warm named), shared
        callables, capture seconds, dispatch hits and misses."""
        def _vals(counter):
            return {labels["executable"]: v
                    for labels, v in counter.samples() if labels}

        with self._lock:
            by_label: Dict[str, set] = {}
            by_tag: Dict[str, Dict[str, set]] = {}
            for key in self._compiled:
                label, bucket, tag = self._meta[key][:3]
                by_label.setdefault(label, set()).add(bucket)
                if tag is not None:
                    by_tag.setdefault(tag, {}).setdefault(
                        label, set()).add(bucket)
            out = {
                "enabled": aot_enabled(),
                "executablesResident": len(self._compiled),
                "bucketsCompiled": {k: sorted(v)
                                    for k, v in sorted(by_label.items())},
                "versions": {t: {k: sorted(v) for k, v in sorted(d.items())}
                             for t, d in sorted(by_tag.items())},
                "sharedJits": sorted(self._jits),
                "compileCount": self.compile_count,
                "compileSeconds": round(self.compile_seconds, 4),
                "inflight": len(self._inflight),
                "failedBuckets": len(self._failed),
            }
        hits, misses = _vals(self._c_hits), _vals(self._c_misses)
        out["dispatchHits"] = hits
        out["dispatchMisses"] = misses
        out["dispatchFallbacks"] = _vals(self._c_fallbacks)
        total = sum(hits.values()) + sum(misses.values())
        out["hitRate"] = (round(sum(hits.values()) / total, 4)
                          if total else None)
        out["pcache"] = costmon.pcache_totals()
        return out

    def clear(self) -> None:
        with self._lock:
            self._compiled.clear()
            self._meta.clear()
            self._refs.clear()
            self._jits.clear()
            self._failed.clear()

    def shutdown(self, join_timeout_s: float = 15.0) -> None:
        """Wait out background captures, then drop the held graphs."""
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=join_timeout_s)
        self.clear()


_registry_lock = threading.Lock()
_registry: Optional[AOTRegistry] = None


def _drop_executables_at_exit():
    # join background captures and release the graphs before the CUDA
    # context tears down at interpreter exit
    if _registry is not None:
        _registry.shutdown()


def get_aot() -> AOTRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = AOTRegistry()
                from predictionio_tpu_torch.obs import get_registry
                get_registry().gauge_func(
                    "pio_aot_executables_resident",
                    "captured executables currently held by the process "
                    "registry",
                    lambda: float(len(_registry._compiled))
                    if _registry is not None else 0.0)
                import atexit
                atexit.register(_drop_executables_at_exit)
    return _registry


def shared_jit(key: str, impl: Callable, **kwargs):
    """Module-level convenience for `AOTRegistry.shared_jit`."""
    return get_aot().shared_jit(key, impl, **kwargs)


def sharded_aval(shape, dtype, *axes, mesh=None):
    """An example argument of `shape` and `dtype` (zeros) on `mesh`'s
    device, split as `axes` names per dim (`parallel/mesh.put`): a
    tensor when no dim is split, else the `DeviceShards` a sharded
    program takes. A builder's example arguments are the static inputs
    of the graph captured from them, so a model-sharded executable is
    captured for its shard layout and keyed on it (the `s` dim)."""
    import numpy as np
    from predictionio_tpu_torch.parallel.mesh import current_mesh
    ctx = mesh or current_mesh()
    return ctx.put(np.zeros(shape, dtype=dtype), ctx.sharding(*axes))


def warm_models(algorithms, models, batch_hint: int = 16,
                background: bool = False, version: Optional[str] = None
                ) -> Dict[str, Any]:
    """Capture the serving executables of an (algorithms, models) pair:
    the deploy, hot-swap and canary hook. Each algorithm with
    `aot_warm_specs(model, batch_hint)` contributes its rows; one without
    stays unwarmed. A failed capture raises (the caller's load or swap
    fails and the old models keep serving)."""
    if not aot_enabled() or not warm_enabled():
        return {"compiled": 0, "skipped": 0, "wallS": 0.0,
                "disabled": True}
    specs: List[tuple] = []
    for algo, model in zip(algorithms, models):
        hook = getattr(algo, "aot_warm_specs", None)
        if hook is not None:
            specs.extend(hook(model, batch_hint))
    out = get_aot().warm(specs, background=background, tag=version,
                         strict=True)
    out["specs"] = len(specs)
    return out
