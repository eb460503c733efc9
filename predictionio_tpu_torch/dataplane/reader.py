"""The read stage of the bulk data plane: the store's chunk cursor,
drained by a background thread into a bounded queue.

The port's counterpart of `predictionio_tpu/dataplane/reader.py`.
`ChunkReader` drains `find_columnar_chunked` (SQLite: keyset SQL over
the time index) on its own thread, so that reading chunk N+1 overlaps the
consumer's decode and upload of chunk N. The queue bound is the
back-pressure: a slow consumer stalls the reader at `queue_depth` chunks,
which caps host memory whatever the store's size. A failure of the reader
is raised at the consumer's next step, never a silently short stream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

_DONE = object()


class ChunkReader:
    """Background producer over `store.find_columnar_chunked`.

    Iterate it to receive chunk column dicts in event-time order. Use it
    as a context manager (or call `close`) to reclaim the thread when the
    consumer stops early. After the stream, `read_s` (seconds producing
    chunks, queue waits excluded), `rows`, `chunks` and `bytes` (host
    bytes of the chunks' columns) describe what was read.
    """

    def __init__(self, store, app_name: str,
                 channel_name: Optional[str] = None,
                 property_field: Optional[str] = None,
                 chunk_rows: Optional[int] = None,
                 queue_depth: int = 2, **filters):
        self._store = store
        self._kw = dict(app_name=app_name, channel_name=channel_name,
                        property_field=property_field,
                        chunk_rows=chunk_rows, **filters)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, queue_depth))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.read_s = 0.0
        self.rows = 0
        self.chunks = 0
        self.bytes = 0

    # -- producer ----------------------------------------------------------
    def _run(self):
        try:
            gen = self._store.find_columnar_chunked(**self._kw)
            t0 = time.perf_counter()
            for chunk in gen:
                self.read_s += time.perf_counter() - t0
                self.rows += len(chunk["t"])
                self.chunks += 1
                self.bytes += sum(int(v.nbytes) for v in chunk.values())
                while not self._stop.is_set():
                    try:
                        self._q.put(chunk, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
        except BaseException as e:  # raised at the consumer's next step
            self._put_final(e)
        else:
            self._put_final(None)

    def _put_final(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(_DONE if item is None else item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="pio-dataplane-read")
            self._thread.start()
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Stop the producer and reclaim its thread (safe on a finished
        or never-started reader)."""
        self._stop.set()
        if self._thread is not None:
            # drain, so that a blocked put sees the stop flag at once
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
