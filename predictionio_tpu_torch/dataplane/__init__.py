"""The bulk data plane: the event store streamed onto the device.

The port's counterpart of `predictionio_tpu/dataplane` (its snapshot
bootstrap comes with the tenancy plane). A training read runs as three
overlapped stages:

* `reader`: the store's `find_columnar_chunked` cursor, drained on a
  background thread into a bounded queue;
* `upload`: double-buffered copies onto the device, from pinned buffers
  on a copy stream, padded to power-of-two row buckets;
* `pipeline`: the executor that overlaps read, decode and upload and
  times each stage.

The plane's device touches (the copy, the wait) live in `ops/staging.py`.
Each stage counts into the reference's `pio_dataplane_*` families on the
process-wide registry; `BulkLoadStats` and `pipeline.last_stats` keep the
same numbers for one run.
"""

from predictionio_tpu_torch.dataplane.pipeline import (BulkLoadExecutor,
                                                       BulkLoadResult,
                                                       BulkLoadStats)
from predictionio_tpu_torch.dataplane.reader import ChunkReader
from predictionio_tpu_torch.dataplane.upload import (DeviceStager,
                                                     StagedSegment,
                                                     StageStats,
                                                     StreamInterner)

__all__ = [
    "BulkLoadExecutor", "BulkLoadResult", "BulkLoadStats",
    "ChunkReader",
    "DeviceStager", "StagedSegment", "StageStats", "StreamInterner",
]
