"""Runtime telemetry of the card: builds and captures, host<->device
bytes, device memory.

The port's counterpart of `predictionio_tpu/obs/jaxmon.py`. Three
instruments on the process-wide registry, so both HTTP servers'
`/metrics` carry them, under the reference's family names:

- **compile counters** (`pio_jax_compiles_total`,
  `pio_jax_compile_seconds_total`): the port has no XLA; what it
  compiles are the `nvcc` builds of its kernels (`ops/_build.py`) and
  the CUDA graphs it captures (`compile/aot.py`, the fused ALS
  iteration). Each calls `record_compile`, which also tells the
  listeners (`obs/costmon.py` attributes the seconds to the executable
  label whose scope paid them). `record_pcache` does the same for a
  build found on disk (a hit) or run by `nvcc` (a miss);
- **transfer byte counters** incremented by the code paths that move
  data (`utils/device_cache.cached_put*`, the fold's uploads, the serve
  readback), with a per-thread total so a caller can price its own
  uploads (`thread_h2d_total`, `h2d_delta`) without counting another
  thread's;
- **device memory gauges** read from `torch.cuda.memory_stats()` at
  scrape time (`kind=bytes_in_use|bytes_limit|peak_bytes_in_use`); a
  process that has not initialized CUDA renders no sample, as the
  reference's CPU devices render none.

`install()` is idempotent.
"""

from __future__ import annotations

import threading
from typing import Callable, List

from predictionio_tpu_torch.obs.metrics import get_registry

_lock = threading.Lock()
_installed = False
_m_compiles = None
_m_compile_s = None
_m_h2d = None
_m_d2h = None
# per-thread transfer accounting: a fold tick prices its own uploads
# without counting a concurrent /reload's on another thread
_tls = threading.local()
# called as fn(seconds) on the compiling thread / fn(hit) on the loading
# thread (obs/costmon.install adds its attribution here)
_compile_listeners: List[Callable[[float], None]] = []
_pcache_listeners: List[Callable[[bool], None]] = []


def _register_metrics(reg):
    global _m_compiles, _m_compile_s, _m_h2d, _m_d2h
    _m_compiles = reg.counter(
        "pio_jax_compiles_total",
        "Compile events: nvcc builds of the kernels and CUDA-graph "
        "captures")
    _m_compile_s = reg.counter(
        "pio_jax_compile_seconds_total",
        "Cumulative wall seconds of the nvcc builds and graph captures")
    _m_h2d = reg.counter(
        "pio_jax_host_to_device_bytes_total",
        "Bytes uploaded host->device by instrumented paths "
        "(model tables, fold-in uploads)")
    _m_d2h = reg.counter(
        "pio_jax_device_to_host_bytes_total",
        "Bytes fetched device->host by instrumented paths "
        "(serve readback)")
    reg.gauge_func(
        "pio_jax_device_memory_bytes",
        "Per-device memory from torch.cuda.memory_stats() "
        "(kind=bytes_in_use|bytes_limit|peak_bytes_in_use; absent "
        "before CUDA is initialized)",
        _device_memory_samples)


def install(registry=None):
    """Register the families on the process registry (or `registry`).
    Idempotent."""
    global _installed
    with _lock:
        if _installed:
            return
        _installed = True
        _register_metrics(registry or get_registry())


def _device_memory_samples():
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        dev = f"cuda:{d}"
        out.append(({"device": dev, "kind": "bytes_in_use"},
                    float(stats.get("allocated_bytes.all.current", 0))))
        out.append(({"device": dev, "kind": "bytes_limit"},
                    float(torch.cuda.get_device_properties(d).total_memory)))
        out.append(({"device": dev, "kind": "peak_bytes_in_use"},
                    float(stats.get("allocated_bytes.all.peak", 0))))
    return out


def _ensure():
    if not _installed:
        install()


def add_compile_listener(fn: Callable[[float], None]) -> None:
    with _lock:
        _compile_listeners.append(fn)


def add_pcache_listener(fn: Callable[[bool], None]) -> None:
    with _lock:
        _pcache_listeners.append(fn)


def record_compile(seconds: float) -> None:
    """Count one compile (an `nvcc` build or a graph capture) of
    `seconds`, on the thread that paid it."""
    _ensure()
    _m_compiles.inc()
    _m_compile_s.inc(max(float(seconds), 0.0))
    for fn in list(_compile_listeners):
        fn(float(seconds))


def record_pcache(hit: bool) -> None:
    """Count a kernel library found already built on disk (`hit`) or
    built by `nvcc` (a miss), on the loading thread."""
    _ensure()
    for fn in list(_pcache_listeners):
        fn(bool(hit))


def record_h2d(nbytes: int):
    """Count an instrumented host->device upload."""
    if nbytes:
        _ensure()
        _m_h2d.inc(float(nbytes))
        _tls.h2d = getattr(_tls, "h2d", 0.0) + float(nbytes)


def record_d2h(nbytes: int):
    """Count an instrumented device->host fetch (the serve readback
    counts every window here)."""
    if nbytes:
        _ensure()
        _m_d2h.inc(float(nbytes))
        _tls.d2h = getattr(_tls, "d2h", 0.0) + float(nbytes)


def h2d_total() -> float:
    _ensure()
    return _m_h2d.value


def thread_d2h_total() -> float:
    """Bytes fetched device->host by the calling thread."""
    return getattr(_tls, "d2h", 0.0)


def thread_h2d_total() -> float:
    """Bytes uploaded by the calling thread: the scheduler snapshots it
    around a fold, so the tick's upload cost leaves out other threads'."""
    return getattr(_tls, "h2d", 0.0)


def h2d_delta(before: float) -> float:
    """The calling thread's bytes uploaded since a prior
    `thread_h2d_total()` snapshot."""
    return thread_h2d_total() - before

