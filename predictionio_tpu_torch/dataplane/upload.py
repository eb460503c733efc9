"""The upload stage of the bulk data plane: double-buffered copies of
chunk columns onto the device.

The port's counterpart of `predictionio_tpu/dataplane/upload.py`.
`DeviceStager` keeps a bounded window of copies in flight (two slots by
default): staging chunk N returns once its copies are enqueued on the
stager's copy stream, so the caller decodes chunk N+1 while N's bytes
cross; only a full window makes it wait, and then for the oldest segment
only. That wait is the double buffer's back-pressure. Shapes come from
the power-of-two row buckets (`utils.buckets.bucket_rows`, through
`ops.staging`), so ragged chunks land as a short ladder of shapes. The
device touches themselves (the copy, the wait) live in `ops/staging.py`.

`StreamInterner` maps string ids to dense int32 indices in order of
first appearance while the stream runs, and `remap_to_sorted` turns them
into the sorted vocabulary's numbering (what the batch preparator
builds) in one gather at the end.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Mapping

import numpy as np
import torch

from predictionio_tpu_torch.device import DeviceLike, resolve_device
from predictionio_tpu_torch.ops import staging as ops_staging


@dataclass
class StagedSegment:
    """One uploaded chunk: its columns on the device, padded to a
    power-of-two bucket, and its valid row count (rows past `rows` are
    zero padding)."""
    arrays: Dict[str, torch.Tensor]
    rows: int
    padded_rows: int


@dataclass
class StageStats:
    """Upload-stage accounting for one stream."""
    segments: int = 0
    rows: int = 0
    h2d_bytes: int = 0
    submit_s: float = 0.0   # time enqueueing the copies
    wait_s: float = 0.0     # time blocked on a full window or at finish
    buckets: List[int] = field(default_factory=list)

    @property
    def overlap_frac(self) -> float:
        """Share of the upload stage's busy time that did not block the
        stream: 1.0 when every copy landed behind the next chunk's
        decode, 0.0 when each copy was waited for in full."""
        busy = self.submit_s + self.wait_s
        if busy <= 0.0:
            return 1.0
        return 1.0 - (self.wait_s / busy)


class DeviceStager:
    """Bounded-window copier of chunk column dicts onto `device` (the
    card unless the caller names the CPU)."""

    def __init__(self, slots: int = 2, device: DeviceLike = None):
        self.slots = max(1, int(slots))
        self.device = resolve_device(device)
        self._stream = ops_staging.copy_stream(self.device)
        # (event, pinned sources) of each segment whose copy may still run
        self._inflight: deque = deque()
        self._segments: List[StagedSegment] = []
        self.stats = StageStats()

    def stage(self, arrays: Mapping[str, np.ndarray]) -> None:
        """Submit one chunk's numeric columns; waits only when the window
        is full, and then until the oldest segment has landed."""
        if not arrays:
            return
        dev, rows, padded, submit_s, event, hosts = \
            ops_staging.device_stage(arrays, self.device, self._stream)
        self._inflight.append((event, hosts))
        self._segments.append(StagedSegment(dev, rows, padded))
        st = self.stats
        st.segments += 1
        st.rows += rows
        st.h2d_bytes += sum(int(t.nbytes) for t in dev.values())
        st.submit_s += submit_s
        st.buckets.append(padded)
        while len(self._inflight) > self.slots:
            st.wait_s += ops_staging.wait_ready(self._inflight.popleft()[0])

    def finish(self) -> List[StagedSegment]:
        """Wait for every copy in the window and return every staged
        segment, its copies complete."""
        while self._inflight:
            self.stats.wait_s += ops_staging.wait_ready(
                self._inflight.popleft()[0])
        return list(self._segments)


class StreamInterner:
    """First-appearance string -> dense int32 interning for a streamed
    encode: chunk N's ids are mapped without knowing chunk N+1's, and the
    mapping is fixed by the stream's order. `remap_to_sorted` gives the
    permutation onto the sorted vocabulary (`np.unique` order, what the
    batch preparator builds), so streamed indices reconcile exactly with
    the batch path's in one gather."""

    def __init__(self):
        self._ix: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._ix)

    def encode(self, ids: np.ndarray) -> np.ndarray:
        ix = self._ix
        out = np.empty(len(ids), dtype=np.int32)
        for i, s in enumerate(ids):
            key = str(s)
            v = ix.get(key)
            if v is None:
                v = len(ix)
                ix[key] = v
            out[i] = v
        return out

    def vocabulary(self) -> np.ndarray:
        """The ids in first-appearance (intern) order."""
        return np.array(list(self._ix.keys()), dtype=str)

    def remap_to_sorted(self) -> np.ndarray:
        """`perm` with `perm[intern_ix] == sorted_ix`: applied to streamed
        index columns, it gives the batch path's sorted numbering."""
        vocab = self.vocabulary()
        order = np.argsort(vocab, kind="stable")
        perm = np.empty(len(vocab), dtype=np.int32)
        perm[order] = np.arange(len(vocab), dtype=np.int32)
        return perm
