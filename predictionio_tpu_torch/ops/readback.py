"""Serve readback: one packed payload per window, copied to the host
behind the device's work.

The port's counterpart of `predictionio_tpu/ops/readback.py`
(`pack_flag`, `pack_device`, `unpack_host`, `begin_fetch`,
`begin_fetch_packed`, `thread_wait_s`, `thread_d2h_bytes`,
`stats_snapshot`, `overlap_frac`).

* **One payload.** A serve window's top-k leaves the device as one
  contiguous `[B, K, slot]` uint8 tensor: the int32 ids, then the scores,
  little-endian, `slot` bytes a slot (`pack_device`). The bytes are the
  reference's, byte for byte. `PIO_SERVE_PACK` picks the score width:
  `on` (the default) f16, 6 bytes a slot; `exact` f32, 8 bytes; `off`
  sends the two arrays as they are (still through one `begin_fetch`).
* **An overlapped copy.** `begin_fetch`, called on the thread that
  enqueued the window's work, starts a `copy_(non_blocking=True)` of each
  CUDA tensor into a pinned host buffer that the window owns, and records
  a `torch.cuda.Event` after it. The `wait()` it returns blocks on that
  event alone (`Event.synchronize`), never on the whole device, so the
  windows in flight complete independently. A copy that cannot start
  raises: there is no fallback to a blocking `.cpu()`. A CPU tensor is
  already on the host; its `wait()` hands it over as numpy.

Every wait is counted: process-wide windows, bytes and submit/wait/span
seconds (`stats_snapshot`, `overlap_frac`, and the reference's
`pio_serve_d2h_*` / `pio_serve_readback_windows_total` families on the
process registry), the bytes in `obs/torchmon.record_d2h`, and per
thread the seconds spent waiting and the bytes fetched (`thread_wait_s`,
`thread_d2h_bytes`); the micro-batcher samples the first around a
window's `finish()`. `pio_tenant_serve_d2h_bytes_total` books a window
fetched under a registered tenant's scope (`obs/tenantctx`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

#: the two result arrays as they are (scores f32, ids i32)
PACK_OFF = 0
#: one uint8 payload a window: i32 ids + f16 scores = 6 bytes a slot
PACK_F16 = 1
#: one uint8 payload a window: i32 ids + f32 scores = 8 bytes a slot
PACK_EXACT = 2

#: bytes per (id, score) slot by pack mode
SLOT_BYTES = {PACK_F16: 6, PACK_EXACT: 8}


def pack_flag() -> int:
    """The pack mode `PIO_SERVE_PACK` names, read at each dispatch (the
    reference's spellings: off/0/false/no, exact, anything else = f16)."""
    v = os.environ.get("PIO_SERVE_PACK", "on").strip().lower()
    if v in ("off", "0", "false", "no"):
        return PACK_OFF
    if v == "exact":
        return PACK_EXACT
    return PACK_F16


def pack_device(scores: torch.Tensor, idx: torch.Tensor,
                p: int) -> torch.Tensor:
    """`(scores [B,K] f32, idx [B,K])` -> one contiguous `[B, K, slot]`
    uint8 tensor on their device: 4 id bytes, then 2 (f16, `PACK_F16`) or
    4 (f32, `PACK_EXACT`) score bytes a slot. The f16 cast rounds to
    nearest even: -inf stays -inf, a finite |score| above 65504 becomes
    +-inf, as in the reference."""
    ids8 = idx.to(torch.int32).contiguous().unsqueeze(-1).view(torch.uint8)
    dtype = torch.float32 if p == PACK_EXACT else torch.float16
    sc8 = scores.to(dtype).contiguous().unsqueeze(-1).view(torch.uint8)
    return torch.cat([ids8, sc8], dim=-1)


def unpack_host(buf: np.ndarray, p: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host inverse of `pack_device`: `[B, K, slot]` uint8 ->
    `(scores f32 [B,K], idx i32 [B,K])`; f16 scores come back as f32."""
    b = np.asarray(buf)
    ids = np.ascontiguousarray(b[..., :4]).view(np.int32)[..., 0]
    if p == PACK_EXACT:
        sc = np.ascontiguousarray(b[..., 4:8]).view(np.float32)[..., 0]
    else:
        sc = np.ascontiguousarray(
            b[..., 4:6]).view(np.float16)[..., 0].astype(np.float32)
    return sc, ids


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device` without waiting for the device: on the
    card through a pinned staging copy and `non_blocking=True` (a pageable
    copy would wait for every window already enqueued on the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Stats:
    """Cumulative readback accounting. `span_s` is the wall time from
    each copy's start to its fetch's end; `submit_s + wait_s` the part a
    thread was blocked for. Their ratio is the overlap fraction."""

    def __init__(self):
        self.lock = threading.Lock()
        self.windows = 0
        self.bytes = 0
        self.submit_s = 0.0
        self.wait_s = 0.0
        self.span_s = 0.0


_STATS = _Stats()
_TLS = threading.local()
_metrics_lock = threading.Lock()
_metrics: dict = {}


def _get_metrics() -> dict:
    with _metrics_lock:
        if not _metrics:
            from predictionio_tpu_torch.obs import get_registry
            reg = get_registry()
            _metrics["seconds"] = reg.counter(
                "pio_serve_d2h_seconds_total",
                "Serve readback device->host seconds by phase (submit = "
                "copy initiation, wait = blocked completion wait)",
                labelnames=("phase",))
            _metrics["bytes"] = reg.counter(
                "pio_serve_d2h_bytes_total",
                "Serve readback bytes fetched device->host")
            _metrics["windows"] = reg.counter(
                "pio_serve_readback_windows_total",
                "Serve windows fetched through the readback plane")
            _metrics["tenant_bytes"] = reg.counter(
                "pio_tenant_serve_d2h_bytes_total",
                "Serve readback bytes by tenant", labelnames=("tenant",))
        return _metrics


def thread_wait_s() -> float:
    """Seconds this thread has spent blocked in `begin_fetch` waits."""
    return getattr(_TLS, "wait_s", 0.0)


def thread_d2h_bytes() -> int:
    """Bytes this thread has fetched through the readback plane."""
    return getattr(_TLS, "bytes", 0)


def begin_fetch(*tensors: torch.Tensor
                ) -> Callable[[], Tuple[np.ndarray, ...]]:
    """Start the device -> host copy of `tensors` now and return
    `wait() -> numpy arrays`. Call it right after enqueueing the work
    that produces them, on the same thread (the copy is enqueued on that
    thread's current stream behind the work). Each pinned buffer belongs
    to this window until its `wait()`; `wait()` may run on another
    thread."""
    from predictionio_tpu_torch.obs import tenantctx, torchmon
    tenant = tenantctx.metric_tenant_label()
    t0 = time.perf_counter()
    hosts, event = [], None
    for t in tensors:
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        else:
            hosts.append(t)
    if any(t.device.type == "cuda" for t in tensors):
        event = torch.cuda.Event()
        event.record()
    submit_s = time.perf_counter() - t0

    def wait() -> Tuple[np.ndarray, ...]:
        t1 = time.perf_counter()
        if event is not None:
            event.synchronize()
        out = tuple(h.numpy() for h in hosts)
        t2 = time.perf_counter()
        nbytes = sum(int(a.nbytes) for a in out)
        _TLS.wait_s = thread_wait_s() + (t2 - t1)
        _TLS.bytes = thread_d2h_bytes() + nbytes
        torchmon.record_d2h(nbytes)
        m = _get_metrics()
        m["seconds"].labels(phase="submit").inc(submit_s)
        m["seconds"].labels(phase="wait").inc(t2 - t1)
        m["bytes"].inc(nbytes)
        m["windows"].inc()
        if tenant:
            m["tenant_bytes"].labels(tenant=tenant).inc(nbytes)
        with _STATS.lock:
            _STATS.windows += 1
            _STATS.bytes += nbytes
            _STATS.submit_s += submit_s
            _STATS.wait_s += t2 - t1
            _STATS.span_s += t2 - t0
        return out
    return wait


def begin_fetch_packed(packed: torch.Tensor, p: int
                       ) -> Callable[[], Tuple[np.ndarray, np.ndarray]]:
    """`begin_fetch` + `unpack_host`: `wait() -> (scores, idx)`."""
    fetch = begin_fetch(packed)

    def wait() -> Tuple[np.ndarray, np.ndarray]:
        (buf,) = fetch()
        return unpack_host(buf, p)
    return wait


def stats_snapshot() -> dict:
    """Cumulative readback counters and the derived overlap fraction;
    diff two snapshots around a run to read that run."""
    with _STATS.lock:
        s = {"windows": _STATS.windows, "bytes": _STATS.bytes,
             "submit_s": _STATS.submit_s, "wait_s": _STATS.wait_s,
             "span_s": _STATS.span_s}
    s["overlap_frac"] = overlap_frac(s)
    return s


def overlap_frac(snap: dict, base: Optional[dict] = None) -> float:
    """Share of the readback span hidden behind other work,
    `1 - (submit + wait) / span` over `snap` (less `base`); 1.0 when
    nothing was fetched."""
    keys = ("submit_s", "wait_s", "span_s")
    d = {k: snap[k] - (base[k] if base else 0.0) for k in keys}
    if d["span_s"] <= 0.0:
        return 1.0
    return max(0.0, min(1.0, 1.0 - (d["submit_s"] + d["wait_s"])
                        / d["span_s"]))
