"""Device staging for the bulk data plane: the plane's only device touches.

The port's counterpart of `predictionio_tpu/ops/staging.py`. The data
plane (`predictionio_tpu_torch/dataplane`) overlaps the store read, the
decode and the upload; the operations that touch the device, submitting a
chunk's copy and waiting for it, live here so that no stray wait in the
plane can serialize the stream again:

* `device_stage` pads each of a chunk's numeric columns to one
  power-of-two row bucket (`compile.buckets.bucket_rows` of the longest
  column), so ragged chunk sizes land as a short ladder of shapes. On the
  card each column is padded into a pinned host buffer and copied with
  `non_blocking=True` on the stager's copy stream, and one CUDA event is
  recorded behind the segment's copies: a copy from pageable memory
  would stage through a bounce buffer and return only when the bytes
  had crossed, so the submit would absorb the transfer. On the CPU the
  copy is plain.
* `wait_ready` blocks until a segment's copies have landed (the event's
  `synchronize()`), and returns the seconds it waited: 0 on the CPU.

`COUNTS` counts the column copies by path (pinned to the card, plain on
the CPU), so a run can show which path its stream took.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.compile.buckets import bucket_rows


@dataclass
class StageCounts:
    """Column copies made by `device_stage`, by path."""
    pinned: int = 0   # from a pinned buffer to the card, non-blocking
    plain: int = 0    # a plain copy on the CPU

    def reset(self) -> None:
        self.pinned = self.plain = 0


COUNTS = StageCounts()


def pad_to_bucket(arr: np.ndarray, rows: int,
                  out: Optional[np.ndarray] = None) -> np.ndarray:
    """Zero-pad a 1-D column to `rows` (a power-of-two bucket), into
    `out` when given, so staged shapes come from the bucket ladder and
    not from chunk sizes."""
    n = len(arr)
    if out is None:
        if n == rows:
            return np.ascontiguousarray(arr)
        out = np.empty(rows, dtype=arr.dtype)
    out[:n] = arr
    out[n:] = 0
    return out


def copy_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """A dedicated stream for a stager's host-to-device copies on the
    card; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.Stream(device)


def device_stage(arrays: Mapping[str, np.ndarray], device: torch.device,
                 stream: Optional[torch.cuda.Stream] = None
                 ) -> Tuple[Dict[str, torch.Tensor], int, int, float,
                            Optional[torch.cuda.Event], list]:
    """Submit one chunk's numeric columns to `device`.

    Every column is padded to the same bucket and copied. On the card the
    copies are enqueued on `stream` from pinned buffers, the tensors are
    marked as used by the caller's current stream (`record_stream`), so
    their memory outlives the work the consumer queues on them, and an
    event is recorded on `stream` behind them. Returns `(tensors,
    valid_rows, padded_rows, submit_s, event, host_buffers)`: the event
    is None on the CPU, and the pinned buffers are the copies' sources,
    kept by the caller until `wait_ready`."""
    rows = max((len(a) for a in arrays.values()), default=0)
    padded = bucket_rows(rows) if rows else 0
    on_card = device.type == "cuda"
    if on_card and stream is None:
        raise ValueError("staging to the card needs the stager's copy "
                         "stream")
    t0 = time.perf_counter()
    out: Dict[str, torch.Tensor] = {}
    hosts = []
    event = None
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        host = torch.empty(padded, dtype=torch.from_numpy(arr[:0]).dtype,
                           pin_memory=on_card)
        pad_to_bucket(arr, padded, out=host.numpy())
        hosts.append(host)
        if not on_card:
            out[name] = host
            COUNTS.plain += 1
            continue
        consumer = torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            dev = host.to(device, non_blocking=True)
        dev.record_stream(consumer)
        out[name] = dev
        COUNTS.pinned += 1
    if on_card:
        event = torch.cuda.Event()
        event.record(stream)
    return out, rows, padded, time.perf_counter() - t0, event, hosts


def wait_ready(event: Optional[torch.cuda.Event]) -> float:
    """Block until a staged segment's copies have landed; returns the
    seconds spent blocked (0 on the CPU, where the copy was plain)."""
    if event is None:
        return 0.0
    t0 = time.perf_counter()
    event.synchronize()
    return time.perf_counter() - t0
