"""The bulk-load executor: events -> device tensors, read, decode and
upload overlapped.

The port's counterpart of `predictionio_tpu/dataplane/pipeline.py`.
`BulkLoadExecutor.run` wires the three stages into one stream:

* read: a `ChunkReader` thread drains the store's chunk cursor into a
  bounded queue;
* decode: the caller's `decode` turns each wire chunk into model-ready
  host columns (the recommendation data source's ratings conversion),
  accumulated in stream order for the host result;
* upload: the caller's `encode` picks the numeric columns to stage, and a
  `DeviceStager` double-buffers them onto the device behind the next
  chunk's decode.

The run's report counts the `nvcc` builds (`ops._build.BUILDS`) that ran
during the steady streaming phase: the staging path builds nothing, so a
count above 0 is a regression, reported as measured.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from predictionio_tpu_torch.dataplane.reader import ChunkReader
from predictionio_tpu_torch.dataplane.upload import (DeviceStager,
                                                     StagedSegment)
from predictionio_tpu_torch.device import DeviceLike
from predictionio_tpu_torch.ops import _build


@dataclass
class BulkLoadStats:
    """Stage accounting for one bulk load."""
    wall_s: float = 0.0
    read_s: float = 0.0
    decode_s: float = 0.0
    upload_submit_s: float = 0.0
    upload_wait_s: float = 0.0
    rows: int = 0
    chunks: int = 0
    read_bytes: int = 0
    h2d_bytes: int = 0
    h2d_overlap_frac: float = 1.0
    read_mb_s: float = 0.0
    #: kernel builds (`nvcc`) and their seconds during the steady
    #: streaming phase: expected 0
    steady_compiles: int = 0
    steady_compile_s: float = 0.0


@dataclass
class BulkLoadResult:
    """What a bulk load produced: the decoded chunks in stream order (the
    host input of the train path) and the staged segments on the device,
    their copies complete."""
    decoded: List[object] = field(default_factory=list)
    segments: List[StagedSegment] = field(default_factory=list)
    stats: BulkLoadStats = field(default_factory=BulkLoadStats)


#: the stats of the latest bulk load in this process, for callers that
#: start one indirectly (a train whose data source streams its read)
last_stats: Optional[BulkLoadStats] = None


class BulkLoadExecutor:
    """Streaming bulk read over an app-name-keyed event store
    (`PEventStore` by default), staging onto `device` (the card unless
    the caller names the CPU)."""

    def __init__(self, store=None, chunk_rows: Optional[int] = None,
                 queue_depth: int = 2, slots: int = 2,
                 device: DeviceLike = None):
        if store is None:
            from predictionio_tpu_torch.data.store import PEventStore
            store = PEventStore
        self.store = store
        self.chunk_rows = chunk_rows
        self.queue_depth = queue_depth
        self.slots = slots
        self.device = device
        from predictionio_tpu_torch.obs import get_registry
        reg = get_registry()
        self._m_decode_s = reg.counter(
            "pio_dataplane_decode_seconds_total",
            "Seconds the dataplane decode stage spent converting wire "
            "chunks to model-ready columns")
        self._m_loads = reg.counter(
            "pio_dataplane_loads_total", "Completed dataplane bulk-load runs")

    def run(self, app_name: str, channel_name: Optional[str] = None,
            property_field: Optional[str] = None,
            decode: Optional[Callable[[Dict[str, object]], object]] = None,
            encode: Optional[Callable[[object], Optional[
                Dict[str, object]]]] = None,
            stage: bool = True, **filters) -> BulkLoadResult:
        """Stream one bulk load.

        `decode(chunk_cols) -> decoded` runs for each chunk on this
        thread, while the reader thread reads the next; a None result
        skips the chunk. The results accumulate in `result.decoded` in
        stream order (with no `decode`, the wire chunks themselves).
        `encode(decoded) -> {name: numeric array} | None` picks what to
        stage; with no `encode` (and `stage=True`) the numeric wire
        columns `t` and `prop` are staged.
        """
        global last_stats
        result = BulkLoadResult()
        stager = (DeviceStager(slots=self.slots, device=self.device)
                  if stage else None)
        reader = ChunkReader(
            self.store, app_name, channel_name=channel_name,
            property_field=property_field, chunk_rows=self.chunk_rows,
            queue_depth=self.queue_depth, **filters)
        builds0, build_s0 = _build.BUILDS.builds, _build.BUILDS.seconds
        t_start = time.perf_counter()
        with reader:
            for chunk in reader:
                t0 = time.perf_counter()
                decoded = decode(chunk) if decode is not None else chunk
                dt = time.perf_counter() - t0
                result.stats.decode_s += dt
                self._m_decode_s.inc(dt)
                if decoded is None:
                    continue
                result.decoded.append(decoded)
                if stager is not None:
                    if encode is not None:
                        cols = encode(decoded)
                    else:
                        cols = {k: v for k, v in chunk.items()
                                if k in ("t", "prop")}
                    if cols:
                        stager.stage(cols)
        # the steady phase ends here: what follows is the finish
        st = result.stats
        st.steady_compiles = _build.BUILDS.builds - builds0
        st.steady_compile_s = _build.BUILDS.seconds - build_s0
        if stager is not None:
            result.segments = stager.finish()
        st.wall_s = time.perf_counter() - t_start
        st.read_s = reader.read_s
        st.rows = reader.rows
        st.chunks = reader.chunks
        st.read_bytes = reader.bytes
        if stager is not None:
            st.upload_submit_s = stager.stats.submit_s
            st.upload_wait_s = stager.stats.wait_s
            st.h2d_bytes = stager.stats.h2d_bytes
            st.h2d_overlap_frac = stager.stats.overlap_frac
        st.read_mb_s = ((st.read_bytes / 1e6) / st.read_s
                        if st.read_s > 0 else 0.0)
        self._m_loads.inc(1)
        last_stats = st
        return result
