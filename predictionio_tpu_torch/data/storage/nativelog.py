"""Native (C++) append-log event store backend.

The port's copy of `predictionio_tpu/data/storage/nativelog.py`: the
high-throughput durable backend, playing the reference's HBase role
(hbase/HBLEvents/HBPEvents over time-ranged scans). The C++ library
(`csrc/eventlog.cpp`, the port's own copy of the reference's, built by
g++ at first use into the salted build directory by
`ops/_build.load`) owns file IO, the id index and coarse predicate
filtering (time range, entity/name/target hashes); this wrapper
serializes events as JSON blobs and applies the exact residual filters.
The file format is the reference's byte for byte: a log either package
wrote is read by the other. A failed build or load raises
`StorageError` with the compiler's output; nothing falls back to SQLite.

Configure with PIO_STORAGE_SOURCES_<S>_TYPE=nativelog and _PATH=<dir>;
one log file per (app, channel) namespace, like HBase's table-per-channel.

PIO_STORAGE_SOURCES_<S>_PARTITIONS=N (default 1) hash-partitions each
(app, channel) namespace into N shard files by entity key, the analog of
HBase's md5(entity)-prefixed rowkeys spreading one table across regions
(HBEventsUtil.scala:81-129). Entity-scoped reads route to exactly one
shard; full scans fan out across shards in parallel threads (the C
library holds one mutex per handle and ctypes releases the GIL, so
shard scans overlap on real cores). A pre-partitioning (unpartitioned)
legacy log file is transparently included in reads, so partitioning an
existing store loses nothing; the shard count itself is recorded in a
PARTITIONS marker file and a mismatched configuration is refused
(hash % P routing against files written under a different P would
silently miss records).

Writes go through one group committer per sub-log (leader/follower: one
`el_append_batch` per group) and an fsync loop on the
`PIO_INGEST_GROUP_COMMIT_MS` cadence; `pio_ingest_group_size` and
`pio_ingest_commit_seconds` histogram them on the port's registry.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.data.event import (Event, format_event_time,
                                         new_event_id, new_event_ids,
                                         parse_event_time, to_millis,
                                         utcnow)
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import ABSENT
from predictionio_tpu_torch.data.storage.registry import (StorageError,
                                                          base_dir)
from predictionio_tpu_torch.obs.slo import lock_probe, timed_acquire

_LIB_LOCK = threading.Lock()
_LIB = None
#: GIL-HOLDING twin of _LIB (ctypes.PyDLL), used for the SHORT commit-
#: path calls (small group appends, flush). A CDLL call releases the
#: GIL and must re-acquire it on return — under 8 concurrent writers
#: that handoff costs ~1 ms per call (measured), dwarfing the ~90 us
#: of C work and inverting the concurrent-vs-serial ordering.
#: Holding the GIL for a sub-100 us append is cheaper for
#: everyone. Long calls (bulk blocks, scans) stay on _LIB. Safe
#: because the Python wrapper serializes per-handle access with its
#: own locks, so a GIL-holding call never waits on the C mutex.
_PYLIB = None



def _load_lib():
    global _LIB, _PYLIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from predictionio_tpu_torch.ops import _build
        try:
            pylib = _build.load("eventlog", py_api=True)
            lib = _build.load("eventlog")
        except (RuntimeError, OSError) as e:
            raise StorageError(
                f"the nativelog library (csrc/eventlog.cpp) could not be "
                f"built or loaded: {e}") from e
        pylib.el_hash.restype = ctypes.c_uint64
        pylib.el_hash.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        pylib.el_append_batch.restype = ctypes.c_int64
        pylib.el_append_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        pylib.el_flush.argtypes = [ctypes.c_void_p]
        pylib.el_sync.restype = ctypes.c_int
        pylib.el_sync.argtypes = [ctypes.c_void_p]
        # el_exists is a ~1 us in-memory index probe, but the insert
        # path calls it once per OTHER file (the partitions>1
        # caller-supplied-id overwrite check) — through the
        # GIL-releasing binding each probe pays a GIL reacquisition
        # that costs ~1 ms under concurrent request threads
        pylib.el_exists.restype = ctypes.c_int
        pylib.el_exists.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int32]
        # the fsync loop calls el_flush_dup UNDER the per-handle append
        # lock; through the GIL-releasing binding its reacquisition
        # wait (~ms when request threads are busy) extends that lock
        # hold and convoys the group committers behind a us-scale
        # fflush+dup
        pylib.el_flush_dup.restype = ctypes.c_int
        pylib.el_flush_dup.argtypes = [ctypes.c_void_p]
        _PYLIB = pylib
        lib.el_open.restype = ctypes.c_void_p
        lib.el_open.argtypes = [ctypes.c_char_p]
        lib.el_close.argtypes = [ctypes.c_void_p]
        lib.el_hash.restype = ctypes.c_uint64
        lib.el_hash.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.el_append.restype = ctypes.c_int
        lib.el_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64]
        lib.el_get.restype = ctypes.c_int64
        lib.el_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                               ctypes.c_int32]
        lib.el_buf.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.el_buf.argtypes = [ctypes.c_void_p]
        lib.el_delete.restype = ctypes.c_int
        lib.el_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int32]
        lib.el_flush.argtypes = [ctypes.c_void_p]
        lib.el_sync.restype = ctypes.c_int
        lib.el_sync.argtypes = [ctypes.c_void_p]
        lib.el_flush_dup.restype = ctypes.c_int
        lib.el_flush_dup.argtypes = [ctypes.c_void_p]
        lib.el_append_batch.restype = ctypes.c_int64
        lib.el_append_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64)]
        lib.el_exists.restype = ctypes.c_int
        lib.el_exists.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int32]
        lib.el_hash_batch.restype = None
        lib.el_hash_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64)]
        lib.el_scan.restype = ctypes.c_int64
        lib.el_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int32, ctypes.c_uint64]
        lib.el_scan_key.restype = ctypes.c_int64
        lib.el_scan_key.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
        lib.el_count.restype = ctypes.c_int64
        lib.el_count.argtypes = [ctypes.c_void_p]
        lib.el_scan_fetch.restype = ctypes.c_int64
        lib.el_scan_fetch.argtypes = [ctypes.c_void_p]
        lib.el_scan_data.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.el_scan_data.argtypes = [ctypes.c_void_p]
        lib.el_scan_offsets.restype = ctypes.POINTER(ctypes.c_uint64)
        lib.el_scan_offsets.argtypes = [ctypes.c_void_p]
        lib.el_scan_nfetched.restype = ctypes.c_int64
        lib.el_scan_nfetched.argtypes = [ctypes.c_void_p]
        lib.el_scan_ts.restype = ctypes.c_int64
        lib.el_scan_ts.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int32, ctypes.c_uint64]
        lib.el_plan_ts.restype = ctypes.POINTER(ctypes.c_int64)
        lib.el_plan_ts.argtypes = [ctypes.c_void_p]
        lib.el_scan_columnar.restype = ctypes.c_int64
        lib.el_scan_columnar.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.el_col_maxlen.restype = ctypes.c_int64
        lib.el_col_maxlen.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_uint8)]
        lib.el_col_fill.restype = ctypes.c_int64
        lib.el_col_fill.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.POINTER(ctypes.c_uint8),
                                    ctypes.c_int64]
        # (string columns travel through el_col_fill's padded matrix;
        # only the numeric/flag column accessors are called from Python)
        for name, ty in (("el_col_ts", ctypes.POINTER(ctypes.c_int64)),
                         ("el_col_prop", ctypes.POINTER(ctypes.c_double)),
                         ("el_col_fallback",
                          ctypes.POINTER(ctypes.c_uint8))):
            fn = getattr(lib, name)
            fn.restype = ty
            fn.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


_INT64_MIN = -(2 ** 63)

#: distinguishes "shard invalidated mid-read" from "shard empty" in the
#: columnar scan paths: the one-shot read drops stale shards (store
#: removed mid-read, matching the object path), while the chunked reader
#: must STOP the stream — yielding a chunk assembled next to a swapped
#: namespace would hand the consumer a torn prefix.
_STALE = object()


def _hash(lib, s: str) -> int:
    b = s.encode("utf-8")
    # PyDLL when loaded: a ~1 us hash must not release the GIL — the
    # reacquisition under concurrent writers costs ~1000x the hash
    return (_PYLIB or lib).el_hash(b, len(b))


class StorageClient:
    def __init__(self, config):
        self.config = config
        self.path = (config.get("PATH") or config.get("HOSTS")
                     or os.path.join(base_dir(), "eventlog"))
        self.partitions = max(1, int(config.get("PARTITIONS") or 1))
        os.makedirs(self.path, exist_ok=True)
        self.lib = _load_lib()
        self._objects = {}

    def get_data_object(self, kind: str, namespace: str):
        if kind != "events":
            raise ValueError(
                f"nativelog backend only stores events, not {kind}")
        if namespace not in self._objects:
            self._objects[namespace] = NativeLogEvents(
                self.lib, os.path.join(self.path, namespace),
                partitions=self.partitions)
        return self._objects[namespace]

    def close(self):
        for obj in self._objects.values():
            obj.close()
        self._objects.clear()


_LEGACY = -1  # partition index of a pre-partitioning single log file


class _EntityIndex:
    """Persisted per-entity -> event-id sidecar for one (app, channel)
    namespace: the seek+read path behind ``find_columnar_by_entities``
    (an entity-filtered read becomes O(touched) el_get probes instead of
    a full log scan — the HBase-rowkey-locality role for id sets).

    Layout: ``<stem>.entidx`` holds one JSON line
    ``[entity_id, target_id, event_id]`` per append (append-only, torn
    tail skipped on load); ``<stem>.entidx.meta`` records the total log
    bytes at the last clean sync. On open, the index is trusted only
    when the meta matches the current log size — any adoption of logs
    written outside this index's watch (older build, crash before the
    final sync, foreign writer) triggers a full-scan rebuild, after
    which the in-process append path keeps it incremental. Index lines
    are appended BEFORE the log append, so a mid-insert crash leaves a
    dangling id (skipped at read: el_get misses), never a missed one.
    Deletes are not unindexed — a dead id simply fails its el_get probe.
    """

    def __init__(self, path: str):
        self.path = path
        self.meta_path = path + ".meta"
        self.lock = threading.RLock()
        self.loaded = False
        self._ids_by_entity: Dict[str, List[str]] = {}
        self._ids_by_target: Dict[str, List[str]] = {}
        # adds arriving while unloaded (a rebuild may be scanning on
        # another thread): queued and merged by the next load/rebuild,
        # so sidecar-before-log ordering never loses an insert
        self._pending: List[tuple] = []
        self._fh = None

    # -- load / rebuild -----------------------------------------------------
    def try_load(self, log_bytes: int) -> bool:
        """Adopt the persisted sidecar iff its meta proves it covers the
        logs as they stand; returns False when a rebuild is needed."""
        if not (os.path.exists(self.path)
                and os.path.exists(self.meta_path)):
            return False
        try:
            with open(self.meta_path) as f:
                meta = json.load(f)
            if int(meta.get("log_bytes", -1)) != int(log_bytes):
                return False
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ent, tgt, eid = json.loads(line)
                    except ValueError:
                        continue  # torn tail from a crashed append
                    self._remember(ent, tgt, eid)
        except (OSError, ValueError):
            self._ids_by_entity.clear()
            self._ids_by_target.clear()
            return False
        self._drain_pending()
        self.loaded = True
        return True

    def rebuild(self, events, log_bytes: int):
        """Full-scan rebuild (adoption): rewrite both sidecar files from
        the namespace's live events."""
        self._ids_by_entity.clear()
        self._ids_by_target.clear()
        self._close_fh()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for e in events:
                if not e.event_id:
                    continue
                self._remember(e.entity_id, e.target_entity_id or "",
                               e.event_id)
                f.write(json.dumps(
                    [e.entity_id, e.target_entity_id or "", e.event_id],
                    separators=(",", ":")) + "\n")
        os.replace(tmp, self.path)
        self._drain_pending()
        self.mark_clean(log_bytes)
        self.loaded = True

    def _drain_pending(self):
        if not self._pending:
            return
        with open(self.path, "a") as f:
            for ent, tgt, eid in self._pending:
                self._remember(ent, tgt, eid)
                f.write(json.dumps([ent, tgt, eid],
                                   separators=(",", ":")) + "\n")
        self._pending = []

    def _remember(self, ent: str, tgt: str, eid: str):
        if ent:
            self._ids_by_entity.setdefault(ent, []).append(eid)
        if tgt:
            self._ids_by_target.setdefault(tgt, []).append(eid)

    # -- incremental append -------------------------------------------------
    def add(self, ent: str, tgt: str, eid: str):
        self.add_many([(ent, tgt, eid)])

    def add_many(self, entries):
        """Group append: ONE write + ONE flush for the whole group —
        the per-partition committer's sidecar path (a per-event flush
        here would contend with the foreground writers)."""
        with self.lock:
            if not self.loaded:
                self._pending.extend(entries)
                return
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write("".join(
                json.dumps(list(e), separators=(",", ":")) + "\n"
                for e in entries))
            self._fh.flush()
            for ent, tgt, eid in entries:
                self._remember(ent, tgt, eid)

    def candidate_ids(self, entity_ids, target_entity_ids) -> List[str]:
        with self.lock:
            out: Dict[str, None] = {}   # ordered de-dup
            for iid in entity_ids:
                for eid in self._ids_by_entity.get(iid, ()):
                    out[eid] = None
            for iid in target_entity_ids:
                for eid in self._ids_by_target.get(iid, ()):
                    out[eid] = None
            return list(out)

    # -- lifecycle ----------------------------------------------------------
    def mark_clean(self, log_bytes: int):
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "log_bytes": int(log_bytes)}, f)
        os.replace(tmp, self.meta_path)

    def _close_fh(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def close(self, log_bytes: Optional[int] = None):
        with self.lock:
            self._close_fh()
            if self.loaded and log_bytes is not None:
                self.mark_clean(log_bytes)
            self.loaded = False
            self._ids_by_entity.clear()
            self._ids_by_target.clear()

    def drop(self):
        with self.lock:
            self._close_fh()
            self.loaded = False
            self._ids_by_entity.clear()
            self._ids_by_target.clear()
            self._pending = []
            for p in (self.path, self.meta_path):
                if os.path.exists(p):
                    os.remove(p)


#: one framed record on its way into a sub-log: everything the C append
#: needs plus the entity-index sidecar line (ent, tgt, eid)
_Record = collections.namedtuple(
    "_Record", "key payload ts ehash nhash thash ent tgt eid")

#: reused compact-JSON encoder for properties cells: per-call
#: json.dumps(separators=...) constructs a fresh JSONEncoder every
#: time — measured ~40% of the columnar bulk loop
_PROPS_ENCODE = json.JSONEncoder(separators=(",", ":")).encode


def _props_frag(p, _enc=json.encoder.encode_basestring_ascii,
                _dumps=_PROPS_ENCODE) -> str:
    """One properties cell as a compact JSON fragment. The telemetry-
    shaped single-scalar dict ({"rating": 4.0}) formats inline;
    everything else takes the reused encoder. Non-finite floats fall
    through to the encoder so their spelling matches json.dumps."""
    if not p:
        return "{}"
    if len(p) == 1:
        k, v = next(iter(p.items()))
        tv = type(v)
        if tv is int or (tv is float and -1e308 < v < 1e308):
            return f"{{{_enc(k)}:{v!r}}}"
        if tv is str:
            return f"{{{_enc(k)}:{_enc(v)}}}"
    return _dumps(p)


def _props_col(props) -> List[str]:
    """The properties column as JSON fragments, memoized per batch:
    telemetry-shaped loads draw single-scalar dicts from a tiny
    vocabulary ({"rating": 1.0..5.0}), so the (key, value) pair is a
    hashable cache key and repeated cells skip the format entirely.
    Multi-key / non-scalar cells fall through to _props_frag."""
    cache: dict = {}
    get = cache.get
    out = []
    ap = out.append
    for p in props:
        if not p:
            ap("{}")
            continue
        if len(p) == 1:
            kv = next(iter(p.items()))
            vt = type(kv[1])
            if vt in (int, float, str):
                # the type joins the key: 1 == 1.0 (same hash), and a
                # plain (key, value) memo would hand the float row the
                # int row's fragment, silently retyping the stored
                # value
                ck = (kv[0], kv[1], vt)
                f = get(ck)
                if f is None:
                    cache[ck] = f = _props_frag(p)
                ap(f)
                continue
        ap(_props_frag(p))
    return out


#: a PRE-FRAMED group from the columnar bulk path: the ctypes-ready
#: arrays el_append_batch consumes, built vectorized OUTSIDE any lock
#: (numpy int arrays, one hash-batch FFI call, joined byte runs), so
#: the committer only passes pointers. ents/tgts/eids are the raw id
#: columns — sidecar lines materialize only when the shard actually
#: carries a loaded entity index.
_Block = collections.namedtuple(
    "_Block", "n keys keylens datas datalens ts eh nh th ents tgts eids")

_INGEST_GROUP_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                         2048, 4096)
_INGEST_COMMIT_BUCKETS = (1e-5, 5e-5, 2.5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                          2.5e-2, 0.1, 0.5, 2.0)
_ingest_metrics_cache = None


def _ingest_metrics():
    """(group_size, commit_seconds) histograms on the process registry
    (the port's registry): how many records each group commit absorbs,
    and what
    one commit costs wall-clock."""
    global _ingest_metrics_cache
    if _ingest_metrics_cache is None:
        from predictionio_tpu_torch.obs.metrics import get_registry
        reg = get_registry()
        _ingest_metrics_cache = (
            reg.histogram(
                "pio_ingest_group_size",
                "Records per nativelog group commit",
                buckets=_INGEST_GROUP_BUCKETS),
            reg.histogram(
                "pio_ingest_commit_seconds",
                "Wall time of one nativelog group commit (sidecar + "
                "batch append + flush)",
                buckets=_INGEST_COMMIT_BUCKETS))
    return _ingest_metrics_cache


def _group_commit_ms() -> float:
    """PIO_INGEST_GROUP_COMMIT_MS: the async-fsync cadence — how far
    durability-to-disk may lag an ack. Acks always wait for the group's
    flush-to-OS (a SIGKILL cannot lose an acked event); fsync covers
    power loss/host crash. ``0`` = fsync synchronously inside every
    group commit (strict); ``<0`` = never fsync; default 2 ms."""
    try:
        return float(os.environ.get("PIO_INGEST_GROUP_COMMIT_MS", "2"))
    except (TypeError, ValueError):
        return 2.0


def _gc_nap_budget_s(fsync_ms: float) -> float:
    """Upper bound on the leader's group-formation wait: half the
    PIO_INGEST_GROUP_COMMIT_MS ack-latency knob, clamped to [0.2, 2]
    ms. Strict-sync (0) and never-fsync (<0) stores still benefit from
    grouping, so they get the default 1 ms."""
    if fsync_ms <= 0:
        return 0.001
    return min(max(fsync_ms / 2000.0, 0.0002), 0.002)


class _Submission:
    """One writer's stake in a group commit: the records (or one
    pre-framed columnar block) it enqueued, an event its committer
    completes, and the error slot."""

    __slots__ = ("records", "block", "done", "error")

    def __init__(self, records, block: Optional[_Block] = None):
        self.records = records
        self.block = block
        self.done = threading.Event()
        self.error: Optional[BaseException] = None

    def wait(self):
        self.done.wait()
        if self.error is not None:
            raise self.error


class _GroupCommitter:
    """One write queue + at-most-one committer per sub-log,
    leader/follower style: writers enqueue framed records,
    then whichever writer wins the commit lock becomes the group's
    committer — it drains EVERYTHING queued into one
    ``el_append_batch`` call (one handle-lock acquisition, one FFI
    crossing, one contiguous write), appends the group's entity-index
    sidecar lines in one shot (sidecar BEFORE log, preserving the crash
    ordering), flushes to the OS once, and completes all waiters.
    Followers sleep on their submission until a leader lands it.

    Group formation is natural: records accumulate while the current
    leader commits, so a lone writer commits inline at single-insert
    latency (no thread handoff) while concurrent writers batch
    automatically instead of convoying on the append lock (which made
    8 concurrent writers slower than one serial writer). fsync rides the
    PIO_INGEST_GROUP_COMMIT_MS cadence (see _group_commit_ms); the ack
    itself only ever waits for the group's flush."""

    def __init__(self, store: "NativeLogEvents", app_id: int,
                 channel_id: Optional[int], part: int):
        self.store = store
        self.app_id = app_id
        self.channel_id = channel_id
        self.part = part
        self._qlock = threading.Lock()
        self._queue: List[_Submission] = []
        # signaled by submit(): wakes a leader blocked in its group-
        # formation wait the moment a record joins the queue
        self._qcv = threading.Condition(self._qlock)
        self._commit_lock = threading.Lock()
        # leadership-handoff signal: set by a retiring leader that
        # leaves work queued, cleared by the follower that takes over.
        # Followers themselves wait on their OWN submission's done
        # event: a shared condition's notify_all would wake EVERY
        # waiting follower on EVERY group completion (at concurrency
        # >= 16, 16 GIL wakeups per group just to re-check state), a
        # thundering herd the per-submission events avoid (a group
        # completion wakes exactly the completed group's members).
        self._handoff = threading.Event()
        self.stopped = False
        # single-event writers routed to THIS sub-log and currently
        # between routing and ack: the leader's group-formation wait
        # compares the queue against this, not the store-wide writer
        # count — on a partitioned store a store-wide count is never
        # covered by one partition's queue and every group would stall
        # the full nap budget
        self.writers = 0

    def writer_enter(self):
        with self._qlock:
            self.writers += 1

    def writer_exit(self):
        with self._qlock:
            self.writers -= 1

    def submit(self, records: List[_Record],
               block: Optional[_Block] = None) -> _Submission:
        sub = _Submission(records, block)
        with self._qlock:
            if self.stopped:
                raise IOError("event store is closed")
            self._queue.append(sub)
            self._qcv.notify_all()
        return sub

    #: groups a leader may commit for OTHERS after its own submission
    #: landed. Handing leadership to a sleeping follower costs that
    #: follower a GIL wakeup (~ms when the server's request threads
    #: are busy) before it can commit — a per-group tax that serializes
    #: ingest into a convoy of wakeups. A warm leader instead keeps
    #: draining: records that arrived during each commit become the
    #: next natural group. The cap bounds how long one unlucky
    #: caller's ack is delayed by strangers' work.
    MAX_EXTRA_DRAINS = 8

    def help_until(self, sub: _Submission):
        """Drive group commits until ``sub`` completes. Every submitter
        calls this after submit(): it either becomes the leader (drains
        the queue, commits the group — which includes its own records)
        or finds a leader already at work and sleeps on ITS OWN
        submission's done event — a group completion wakes exactly that
        group's members, never the other followers (the notify_all
        thundering herd this replaces cost one GIL wakeup per follower
        per group at concurrency >= 16). After its own submission
        lands, a leader keeps draining up to MAX_EXTRA_DRAINS queued
        groups — staying warm beats waking a follower — then retires,
        raising the handoff flag when work remains queued so exactly
        the followers whose submissions are still pending re-contend
        for leadership. The bounded wait is only a backstop for the
        narrow race where a leader exits exactly as we enqueue."""
        while not sub.done.is_set():
            if self._commit_lock.acquire(blocking=False):
                self._handoff.clear()
                extra = 0
                try:
                    if not sub.done.is_set() and self.writers > 1:
                        # group-commit delay (PostgreSQL commit_delay
                        # idea): other writers are mid-frame in
                        # insert() — wait for them to enqueue so their
                        # records join THIS group instead of each
                        # paying a commit. The wait MUST truly block
                        # (cv signaled per submit): timed sleeps have
                        # a ~1.2 ms floor on HZ=250 kernels, and
                        # sleep(0) yields lose the GIL race back to
                        # this thread until the 5 ms switch-interval
                        # forces a handoff — both measured as ~1.6 ms
                        # of dead air per group. Blocking hands the
                        # GIL to a framing follower and the enqueue
                        # notify wakes us in microseconds. The wait
                        # exits the moment every in-flight writer has
                        # enqueued; the budget keeps added ack latency
                        # inside the PIO_INGEST_GROUP_COMMIT_MS
                        # envelope. A lone writer never waits.
                        deadline = (time.perf_counter()
                                    + self.store._nap_budget_s)
                        with self._qcv:
                            while (len(self._queue)
                                   < self.writers):
                                left = deadline - time.perf_counter()
                                if left <= 0:
                                    break
                                self._qcv.wait(left)
                    while self._drain_once():
                        if sub.done.is_set():
                            extra += 1
                            if extra > self.MAX_EXTRA_DRAINS:
                                break
                finally:
                    self._commit_lock.release()
                    # retiring with work still queued: flag the
                    # handoff so a pending follower claims leadership
                    # without waiting out its backstop timeout — ONE
                    # flag read, not a broadcast to every waiter
                    with self._qlock:
                        pending = bool(self._queue)
                    if pending:
                        self._handoff.set()
                if sub.done.is_set():
                    break
            else:
                if self._handoff.is_set():
                    # a leader retired leaving queued work (possibly
                    # ours): CONSUME the flag and re-contend for the
                    # commit lock. Clearing here is what keeps this a
                    # wakeup, not a busy-spin — a stale flag (another
                    # follower already took leadership, or the retiring
                    # leader re-set it after the taker cleared) would
                    # otherwise make every waiter loop hot through the
                    # new leader's whole commit
                    self._handoff.clear()
                    continue
                # wait on OUR OWN completion event: the leader landing
                # our group sets exactly it (done.set() in
                # _drain_once) — no herd. The timeout is the backstop
                # for leader-exit races; MAX_EXTRA_DRAINS makes a
                # retirement-with-backlog rare, so it is a bound, not
                # the mechanism.
                sub.done.wait(timeout=0.005)
        if sub.error is not None:
            raise sub.error

    def _drain_once(self) -> bool:
        """Commit one group: everything queued right now (caller holds
        the commit lock). Returns False when the queue was empty."""
        with self._qlock:
            subs, self._queue = self._queue, []
        if not subs:
            return False
        err = None
        try:
            self._commit(subs)
        except BaseException as e:          # waiters must never hang
            err = e
        for s in subs:
            s.error = err
            s.done.set()   # wakes exactly this group's waiters
        return True

    @staticmethod
    def _records_arrays(records: List[_Record]):
        """One el_append_batch argument set from a list of framed
        records (the single/small-writer group shape)."""
        n = len(records)
        keys = b"".join(r.key for r in records)
        datas = b"".join(r.payload for r in records)
        keylens = (ctypes.c_int32 * n)(*[len(r.key) for r in records])
        datalens = (ctypes.c_int64 * n)(*[len(r.payload)
                                         for r in records])
        ts = (ctypes.c_int64 * n)(*[r.ts for r in records])
        eh = (ctypes.c_uint64 * n)(*[r.ehash for r in records])
        nh = (ctypes.c_uint64 * n)(*[r.nhash for r in records])
        th = (ctypes.c_uint64 * n)(*[r.thash for r in records])
        return (n, keys, keylens, datas, datalens, ts, eh, nh, th)

    @staticmethod
    def _block_arrays(b: _Block):
        """el_append_batch arguments from a pre-framed columnar block:
        the numpy arrays were built vectorized by insert_columnar, so
        this only reinterprets pointers."""
        p32 = ctypes.POINTER(ctypes.c_int32)
        p64 = ctypes.POINTER(ctypes.c_int64)
        pu64 = ctypes.POINTER(ctypes.c_uint64)
        return (b.n, b.keys, b.keylens.ctypes.data_as(p32),
                b.datas, b.datalens.ctypes.data_as(p64),
                b.ts.ctypes.data_as(p64), b.eh.ctypes.data_as(pu64),
                b.nh.ctypes.data_as(pu64), b.th.ctypes.data_as(pu64))

    def _commit(self, subs: List[_Submission]):
        store, lib = self.store, self.store.lib
        t0 = time.perf_counter()
        records = [r for s in subs if s.block is None
                   for r in s.records]
        blocks = [s.block for s in subs if s.block is not None]
        total = len(records) + sum(b.n for b in blocks)
        if not total:
            return
        # sidecar lines for the whole group BEFORE the log append (a
        # dangling indexed id is skipped at read; a missing one would be
        # a wrong filtered result) — one write+flush instead of n.
        # Block sidecar tuples materialize HERE, only when the shard
        # actually carries an index (the common unindexed ingest skips
        # the per-row tuple build entirely).
        idx = store._entidx.get((self.app_id, self.channel_id, self.part))
        if idx is not None:
            entries = [(r.ent, r.tgt, r.eid) for r in records]
            for b in blocks:
                tgts = b.tgts or ("",) * b.n
                entries.extend((e, t or "", i) for e, t, i
                               in zip(b.ents, tgts, b.eids))
            idx.add_many(entries)
        groups = [self._block_arrays(b) for b in blocks]
        if records:
            groups.append(self._records_arrays(records))
        hkey = (self.app_id, self.channel_id, self.part)
        fsync_ms = store._fsync_ms
        # short calls go through the GIL-holding binding: a CDLL call's
        # GIL reacquisition costs ~1 ms under concurrent writers, 10x
        # the C work itself (see _PYLIB). Bulk blocks stay GIL-releasing
        # so the pipelined framing overlaps with them.
        fast = _PYLIB or lib
        while True:
            h, lk = store._handle_of(self.app_id, self.channel_id,
                                     self.part)
            with timed_acquire(lk, store._append_lock_wait):
                if store._stale(hkey, h):
                    continue           # lost a race with remove(): reopen
                for (n, keys, keylens, datas, datalens, ts, eh, nh,
                     th) in groups:
                    clib = fast if n <= 4096 else lib
                    rc = clib.el_append_batch(h, n, keys, keylens, datas,
                                              datalens, ts, eh, nh, th)
                    if rc != n:
                        raise IOError("batch append failed")
                # the ack barrier: flushed to the OS — a process kill
                # cannot lose an acked event; disk durability rides the
                # fsync cadence below. A flush FAILURE (ENOSPC/EIO
                # after fwrite buffered the group) must raise, not
                # ack: the IOError reaches every waiter and the event
                # server's transient-error classification spills the
                # group to the WAL instead of acking it into the void.
                if fast.el_flush(h) != 0:
                    raise IOError("event log flush failed")
                if fsync_ms == 0:
                    # strict mode pays a real disk sync per group: go
                    # through the GIL-RELEASING binding — the PyDLL
                    # fast path would freeze every Python thread
                    # (request handlers, the serving plane) for the
                    # sync's duration
                    if lib.el_sync(h) != 0:
                        raise IOError("fsync failed")
            break
        if fsync_ms > 0:
            store._mark_dirty(hkey)
        gs, cs = _ingest_metrics()
        gs.observe(total)
        cs.observe(time.perf_counter() - t0)

    def stop(self):
        """Refuse new submissions and land whatever is queued on the
        calling thread (blocking on an in-flight leader first).
        Submissions that raced the flag re-resolve a fresh committer."""
        with self._qlock:
            self.stopped = True
        with self._commit_lock:
            self._drain_once()


class _FsyncLoop:
    """The async half of the durability knob: committers mark handles
    dirty, this thread el_syncs them every ``interval_ms``. One per
    store; started on the first dirty mark, stopped (with a final sync
    pass) at close."""

    def __init__(self, store: "NativeLogEvents", interval_ms: float):
        self.store = store
        self.interval_s = max(interval_ms, 0.5) / 1000.0
        self._dirty: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="nativelog-fsync")
        self._thread.start()

    def mark(self, hkey):
        with self._lock:
            self._dirty.add(hkey)

    def _sync_pass(self):
        with self._lock:
            dirty, self._dirty = self._dirty, set()
        for app_id, channel_id, part in dirty:
            h, lk = self.store._handle_of(app_id, channel_id, part,
                                          create=False)
            if h is None:
                continue
            # flush under the append lock (microseconds), fsync OUTSIDE
            # it on a dup'd fd: an fsync held under this lock convoys
            # every group committer behind the disk (measured ~2x bulk
            # ingest). The dup keeps the file description alive even if
            # remove() closes the handle mid-sync.
            fd = -1
            fast = _PYLIB or self.store.lib   # us-scale: hold the GIL
            with lk:
                if not self.store._stale((app_id, channel_id, part), h):
                    fd = fast.el_flush_dup(h)
            if fd >= 0:
                try:
                    os.fsync(fd)
                except OSError:
                    # re-mark: the dirty flag was popped up front, so a
                    # failed sync must re-queue itself for the next pass
                    self.mark((app_id, channel_id, part))
                finally:
                    os.close(fd)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self._sync_pass()
            except Exception:
                pass                       # a sync failure must not kill
            #                                the cadence; the next pass
            #                                (or close) retries

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
        try:
            self._sync_pass()              # land what the loop missed
        except Exception:
            pass


class NativeLogEvents(base.Events):
    def __init__(self, lib, root: str, partitions: int = 1):
        self.lib = lib
        self.root = root
        self.partitions = max(1, partitions)
        os.makedirs(root, exist_ok=True)
        # The shard layout is a property of the data on disk: record it in
        # a marker file and refuse a mismatched configuration (hash % P
        # routing against files written under a different P would silently
        # miss records). Unmarked (pre-partitioning) stores may be
        # upgraded to any P — the legacy file stays in every read path.
        marker = os.path.join(root, "PARTITIONS")
        if os.path.exists(marker):
            with open(marker) as f:
                disk = int(f.read().strip() or 1)
            if disk != self.partitions:
                raise ValueError(
                    f"event log at {root} was written with "
                    f"PARTITIONS={disk} but is configured with "
                    f"{self.partitions}; set "
                    f"PIO_STORAGE_SOURCES_<S>_PARTITIONS={disk} or "
                    f"re-shard via pio export/import")
        elif self.partitions > 1:
            with open(marker, "w") as f:
                f.write(str(self.partitions))
        # key = (app_id, channel_id, partition); one C handle + one Python
        # lock per partition file — scans on different partitions overlap
        # (the C mutex is per handle; ctypes drops the GIL during calls).
        # Lock discipline: self._lock (handle-map mutation) may be held
        # while acquiring a per-handle lock, never the reverse; every C
        # call happens under the handle's lock, and close/remove take that
        # lock before el_close, so a handle is never freed mid-call. Ops
        # re-check the map after acquiring the lock (`_handles.get(key) is
        # h`) to catch a close/remove that won the race.
        self._handles: Dict[Tuple[int, Optional[int], int], int] = {}
        self._hlocks: Dict[Tuple[int, Optional[int], int],
                           threading.RLock] = {}
        # negative handle cache (see _handle_of): keys whose log file
        # does not exist on disk — probed O(partitions) times per
        # pre-assigned-id insert, so a stat() each would be a hot-path
        # syscall storm. Entries clear when a handle is created.
        self._absent: set = set()
        self._lock = threading.RLock()
        # serializes cross-shard overwrite-by-id inserts of the SAME id
        # (two racers otherwise each delete the other's freshly-appended
        # copy). Striped by id so concurrent inserts of distinct ids —
        # the common ingest path when clients assign ids, as RemoteEvents
        # and pio import do — never contend on a global lock.
        self._overwrite_locks = [threading.Lock() for _ in range(64)]
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False
        # per-SUB-LOG persisted entity->ids sidecars, keyed (app, chan,
        # part) — sharding the sidecar alongside the log lets each
        # partition's committer append its own index lines without
        # contending on a namespace-wide sidecar lock. Created lazily
        # on the first entity-filtered read; kept
        # incremental by the committers.
        self._entidx: Dict[Tuple[int, Optional[int], int],
                           _EntityIndex] = {}
        self._entidx_lock = threading.RLock()
        # group-commit plane: one write queue +
        # committer per sub-log; writers enqueue and wait instead of
        # convoying on the per-handle append lock
        self._committers: Dict[Tuple[int, Optional[int], int],
                               _GroupCommitter] = {}
        self._fsync_ms = _group_commit_ms()
        self._nap_budget_s = _gc_nap_budget_s(self._fsync_ms)
        self._fsync_loop: Optional[_FsyncLoop] = None
        # contention probe: writer wait on the per-handle
        # lock, as pio_lock_wait_seconds{lock=nativelog_append} — the
        # instrument that tells whether slow concurrent ingest waits on
        # this lock or below it
        self._append_lock_wait = lock_probe("nativelog_append")
        # (in-flight single-event writers are counted PER COMMITTER —
        # _GroupCommitter.writers — so a partitioned store's formation
        # waits compare each sub-log's queue against that sub-log's
        # own writers, not a store-wide count one partition's queue
        # could never cover)

    def _path_of(self, app_id: int, channel_id: Optional[int],
                 part: int) -> str:
        stem = f"events_{app_id}_{channel_id or 0}"
        if part == _LEGACY or self.partitions == 1:
            return os.path.join(self.root, f"{stem}.log")
        return os.path.join(self.root, f"{stem}_p{part}.log")

    def _handle_of(self, app_id: int, channel_id: Optional[int], part: int,
                   create: bool = True):
        key = (app_id, channel_id, part)
        # Lock-free fast path: CPython dict reads are atomic, and every
        # operation re-checks ``_stale`` under the per-handle lock, so a
        # lookup that races close/remove resolves there. Taking the
        # store lock here put a GLOBAL convoy on every read AND every
        # cross-file id probe (O(partitions) lookups per pre-assigned-id
        # insert) — measured as the top server-side stack under
        # concurrent ingest. ``_absent`` is the negative cache for files
        # that don't exist (the legacy part on never-upgraded stores):
        # without it each probe pays O(partitions) stat() calls.
        h = self._handles.get(key)
        if h is not None:
            lk = self._hlocks.get(key)
            if lk is not None:
                return h, lk
        elif not create and key in self._absent:
            return None, None
        with self._lock:
            if key not in self._handles:
                path = self._path_of(app_id, channel_id, part)
                if not create and not os.path.exists(path):
                    self._absent.add(key)
                    return None, None
                h = self.lib.el_open(path.encode())
                if not h:
                    raise IOError(f"cannot open event log {path}")
                self._handles[key] = h
                self._hlocks[key] = threading.RLock()
                self._absent.discard(key)
            return self._handles[key], self._hlocks[key]

    def _write_part(self, event: Event) -> int:
        if self.partitions == 1:
            return 0
        return _hash(self.lib, self._entity_key(event)) % self.partitions

    def _read_handles(self, app_id, channel_id, entity_type=None,
                      entity_id=None) -> List[tuple]:
        """(key, handle, lock) triples a read must consult. A fully-
        specified entity routes to its hash shard (HBase rowkey-prefix
        locality); otherwise every shard. A legacy unpartitioned file, if
        present, is always included so raising PARTITIONS is lossless."""
        if self.partitions == 1:
            parts = [0]
        elif entity_type is not None and entity_id is not None:
            parts = [_hash(self.lib, f"{entity_type}\x00{entity_id}")
                     % self.partitions, _LEGACY]
        else:
            parts = list(range(self.partitions)) + [_LEGACY]
        out = []
        for p in parts:
            h, lk = self._handle_of(app_id, channel_id, p, create=False)
            if h is not None:
                out.append(((app_id, channel_id, p), h, lk))
        return out

    def _index_parts(self, app_id, channel_id) -> List[int]:
        """Partition indexes that carry an entity-index sidecar: every
        shard, plus the legacy unpartitioned file when one exists."""
        if self.partitions == 1:
            return [0]
        parts = list(range(self.partitions))
        if os.path.exists(self._path_of(app_id, channel_id, _LEGACY)):
            parts.append(_LEGACY)
        return parts

    def _entidx_path(self, app_id, channel_id, part) -> str:
        stem = f"events_{app_id}_{channel_id or 0}"
        if part == _LEGACY or self.partitions == 1:
            # the pre-sharding sidecar name: a store upgraded from
            # PARTITIONS=1 adopts its old sidecar as the legacy part's
            # (its meta covered exactly the legacy file's bytes)
            return os.path.join(self.root, stem + ".entidx")
        return os.path.join(self.root, f"{stem}_p{part}.entidx")

    def _shard_bytes(self, app_id, channel_id, part) -> int:
        path = self._path_of(app_id, channel_id, part)
        return os.path.getsize(path) if os.path.exists(path) else 0

    def _flush_part(self, app_id, channel_id, part):
        h, lk = self._handle_of(app_id, channel_id, part, create=False)
        if h is not None:
            with lk:
                if not self._stale((app_id, channel_id, part), h):
                    self.lib.el_flush(h)

    def _shard_events(self, app_id, channel_id, part) -> List[Event]:
        """Every live event in ONE sub-log — the per-shard sidecar
        rebuild scan (sharded sidecars rebuild shard-by-shard instead of
        one namespace-wide scan)."""
        h, lk = self._handle_of(app_id, channel_id, part, create=False)
        if h is None:
            return []
        return [Event.from_dict(json.loads(raw.decode("utf-8")))
                for raw in self._scan_one((app_id, channel_id, part),
                                          h, lk)]

    def _index_of_part(self, app_id, channel_id, part) -> _EntityIndex:
        """One sub-log's entity index, loading the persisted sidecar
        when its meta matches the shard and rebuilding (one shard scan —
        the adoption cost) otherwise."""
        key = (app_id, channel_id, part)
        with self._entidx_lock:
            idx = self._entidx.get(key)
            if idx is None:
                idx = _EntityIndex(
                    self._entidx_path(app_id, channel_id, part))
                self._entidx[key] = idx
        with idx.lock:
            if not idx.loaded:
                self._flush_part(app_id, channel_id, part)  # size settles
                nbytes = self._shard_bytes(app_id, channel_id, part)
                if not idx.try_load(nbytes):
                    idx.rebuild(
                        self._shard_events(app_id, channel_id, part),
                        nbytes)
        return idx

    def _index_of(self, app_id, channel_id) -> List[_EntityIndex]:
        """The namespace's entity indexes, one per sub-log, each loaded
        or rebuilt on first use."""
        return [self._index_of_part(app_id, channel_id, p)
                for p in self._index_parts(app_id, channel_id)]

    def _stale(self, key, h) -> bool:
        """True when a concurrent close()/remove() freed this handle
        between our map lookup and lock acquisition (caller holds the
        handle lock, so a non-stale handle cannot be freed under us)."""
        return self._handles.get(key) is not h

    def _parallel(self, fns):
        """Run one scan callable per partition, in parallel when >1.
        Degrades to serial execution when close() races the pool away —
        the per-callable stale-handle checks then return empty results,
        matching the other op paths' behavior on a closed store."""
        if len(fns) <= 1:
            return [f() for f in fns]
        with self._lock:
            if self._pool is None and not self._closed:
                self._pool = ThreadPoolExecutor(
                    max_workers=min(16, os.cpu_count() or 4),
                    thread_name_prefix="nativelog-scan")
            pool = self._pool
        if pool is None:
            return [f() for f in fns]
        try:
            return list(pool.map(lambda f: f(), fns))
        except RuntimeError:           # pool shut down between grab and map
            return [f() for f in fns]

    def close(self):
        # committers drain first (queued groups still commit, waiters
        # complete), then the fsync loop lands its final pass, THEN the
        # handles close — so el_close never races an in-flight commit
        with self._lock:
            self._closed = True
            committers = list(self._committers.values())
            self._committers.clear()
            fsync_loop, self._fsync_loop = self._fsync_loop, None
        for c in committers:
            c.stop()
        if fsync_loop is not None:
            fsync_loop.stop()
        with self._lock:
            pool, self._pool = self._pool, None
            items = [(k, h, self._hlocks[k])
                     for k, h in self._handles.items()]
            self._handles.clear()
            self._hlocks.clear()
        if pool is not None:
            pool.shutdown(wait=True)   # drain in-flight shard scans
        for _, h, lk in items:
            with lk:                   # in-flight C calls finish first
                self.lib.el_close(h)
        with self._entidx_lock:
            indexes = list(self._entidx.items())
            self._entidx.clear()
        for (app_id, channel_id, part), idx in indexes:
            # clean close stamps the meta fingerprint: the next open
            # adopts the sidecar instead of rebuilding
            idx.close(self._shard_bytes(app_id, channel_id, part))

    # -- Events interface ---------------------------------------------------
    def init(self, app_id, channel_id=None) -> bool:
        for p in range(self.partitions):
            self._handle_of(app_id, channel_id, p)
        return True

    def remove(self, app_id, channel_id=None) -> bool:
        removed = False
        # this namespace's committers drain and stop before the files
        # go away (a queued group must not resurrect a removed log)
        with self._lock:
            committers = [(k, c) for k, c in self._committers.items()
                          if k[0] == app_id and k[1] == channel_id]
            for k, _ in committers:
                self._committers.pop(k)
        for _, c in committers:
            c.stop()
        parts = list(range(self.partitions)) + [_LEGACY]
        for p in parts:
            with self._entidx_lock:
                idx = self._entidx.pop((app_id, channel_id, p), None)
            if idx is None:   # sidecar may exist from a prior process
                idx = _EntityIndex(
                    self._entidx_path(app_id, channel_id, p))
            idx.drop()
        with self._lock:
            for p in parts:
                key = (app_id, channel_id, p)
                if key in self._handles:
                    h = self._handles.pop(key)
                    lk = self._hlocks.pop(key)
                    with lk:           # in-flight C calls finish first
                        self.lib.el_close(h)
                path = self._path_of(app_id, channel_id, p)
                if os.path.exists(path):
                    os.remove(path)
                    removed = True
        return removed

    def invalidate_namespace(self, app_id, channel_id=None):
        """Forget every cached view of a namespace whose on-disk files
        were replaced OUTSIDE this DAO (snapshot restore): cached
        handles close, the negative-existence cache (``_absent`` — a
        restored shard would otherwise stay invisible forever) and
        in-memory entity indexes drop. The next operation re-opens
        from disk."""
        parts = list(range(self.partitions)) + [_LEGACY]
        with self._lock:
            for p in parts:
                key = (app_id, channel_id, p)
                self._absent.discard(key)
                h = self._handles.pop(key, None)
                if h is not None:
                    lk = self._hlocks.pop(key, None)
                    if lk is not None:
                        with lk:
                            self.lib.el_close(h)
        with self._entidx_lock:
            idxs = [self._entidx.pop((app_id, channel_id, p), None)
                    for p in parts]
        for idx in idxs:
            if idx is not None:
                idx._close_fh()   # drop, never stamp: the sidecar no
                #                   longer describes the on-disk log

    def snapshot_files(self, app_id, channel_id=None):
        """Flush every shard and return ``[(file_name, abs_path)]`` for
        the namespace's live log files — safe to copy while writes
        continue: the format is append-only (deletes are appended
        tombstone records), so any byte-prefix of a flushed file is a
        valid log whose torn tail, if the copy races an append, is
        repaired on open. The consistency unit is the shard file; the
        snapshot as a whole is crash-consistent, not point-in-time."""
        out = []
        parts = ([0] if self.partitions == 1
                 else list(range(self.partitions)) + [_LEGACY])
        for p in parts:
            key = (app_id, channel_id, p)
            h, lk = self._handle_of(app_id, channel_id, p, create=False)
            if h is not None:
                with lk:
                    if not self._stale(key, h):
                        self.lib.el_flush(h)
            path = self._path_of(app_id, channel_id, p)
            if os.path.exists(path):
                out.append((os.path.basename(path), path))
        return out

    @staticmethod
    def _entity_key(e: Event) -> str:
        return f"{e.entity_type}\x00{e.entity_id}"

    @staticmethod
    def _target_key(e: Event) -> str:
        if e.target_entity_type is None:
            return ""
        return f"{e.target_entity_type}\x00{e.target_entity_id}"

    # -- group-commit write plane ------------------------------------------
    def _record_of(self, event: Event, eid: str) -> _Record:
        payload = json.dumps(
            event.with_id(eid).to_dict(), separators=(",", ":")
        ).encode("utf-8")
        target = self._target_key(event)
        return _Record(
            eid.encode("utf-8"), payload, to_millis(event.event_time),
            _hash(self.lib, self._entity_key(event)),
            _hash(self.lib, event.event),
            _hash(self.lib, target) if target else 0,
            event.entity_id, event.target_entity_id or "", eid)

    def _committer_of(self, app_id, channel_id, part) -> _GroupCommitter:
        key = (app_id, channel_id, part)
        # lock-free fast path (same contract as _handle_of): committers
        # are only replaced when stopped, and submit() re-raises on a
        # stop that races this lookup, which _submit retries
        c = self._committers.get(key)
        if c is not None and not c.stopped:
            return c
        with self._lock:
            c = self._committers.get(key)
            if c is None or c.stopped:
                c = _GroupCommitter(self, app_id, channel_id, part)
                self._committers[key] = c
            return c

    def _submit(self, app_id, channel_id, part, records: List[_Record],
                block: Optional[_Block] = None
                ) -> Tuple[_GroupCommitter, _Submission]:
        while True:
            c = self._committer_of(app_id, channel_id, part)
            try:
                return c, c.submit(records, block)
            except IOError:
                continue   # committer stopped between resolve and submit

    def _mark_dirty(self, hkey):
        """Queue a handle for the async fsync cadence (the durability
        half of PIO_INGEST_GROUP_COMMIT_MS)."""
        loop = self._fsync_loop
        if loop is None:
            with self._lock:
                if self._fsync_loop is None:
                    self._fsync_loop = _FsyncLoop(self, self._fsync_ms)
                loop = self._fsync_loop
        loop.mark(hkey)

    def _id_in_other_file(self, app_id, channel_id, key: bytes,
                          part: int) -> bool:
        """O(1) index probes: does this event id live in any file OTHER
        than its routed shard (another shard after an entity re-route,
        or the pre-partitioning legacy file)? Decides whether a caller-
        supplied id needs the serialized overwrite+sweep path or can
        ride the group committer."""
        fast = _PYLIB or self.lib   # us-scale probe: hold the GIL
        for okey, oh, olk in self._read_handles(app_id, channel_id):
            if okey[2] == part:
                continue
            with olk:
                if self._stale(okey, oh):
                    continue
                if fast.el_exists(oh, key, len(key)):
                    return True
        return False

    def _ids_in_other_files(self, app_id, channel_id,
                            key_id_parts) -> set:
        """Batched ``_id_in_other_file`` over ``(key_bytes, eid, part)``
        triples: which of the batch's caller-supplied ids live in a
        file other than their routed shard — one lock acquisition per
        file for the whole batch."""
        found: set = set()
        fast = _PYLIB or self.lib   # us-scale probes: hold the GIL
        for okey, oh, olk in self._read_handles(app_id, channel_id):
            with olk:
                if self._stale(okey, oh):
                    continue
                for key, eid, part in key_id_parts:
                    if okey[2] == part or eid in found:
                        continue
                    if fast.el_exists(oh, key, len(key)):
                        found.add(eid)
        return found

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        part = self._write_part(event)
        # count on the ROUTED sub-log's committer: its leader's
        # formation wait exits when this partition's queue covers this
        # partition's writers. (A committer swapped out by a racing
        # remove() just sees an advisory count decorate the retiring
        # instance — formation timing, never correctness.)
        c = self._committer_of(app_id, channel_id, part)
        c.writer_enter()
        try:
            return self._insert_one(event, app_id, channel_id, part)
        finally:
            c.writer_exit()

    def _insert_one(self, event: Event, app_id, channel_id,
                    part: int) -> str:
        # a minted id (server pre-assign, Event.id_minted) is fresh
        # random hex that cannot live in another file: skip the
        # O(files) probe and the overwrite stripe lock entirely
        preexisting_id = bool(event.event_id) and not event.id_minted
        eid = event.event_id or new_event_id()
        rec = self._record_of(event, eid)
        # A caller-supplied id may live in a DIFFERENT file: another
        # shard (a re-insert that changed the entity re-routes, since
        # shard routing is by entity hash) or a pre-partitioning legacy
        # file. Probing the other files' in-memory indexes is O(files);
        # only a HIT takes the serialized overwrite+sweep path — the
        # common pre-assigned-id ingest (event server, spill replay,
        # pio import) probes, misses, and rides the group committer.
        # The stripe lock spans probe→ack so racing same-id inserts
        # serialize to last-writer-wins.
        if self.partitions > 1 and preexisting_id:
            with self._overwrite_locks[_hash(self.lib, eid) & 63]:
                if self._id_in_other_file(app_id, channel_id, rec.key,
                                          part):
                    self._insert_overwrite(rec, app_id, channel_id, part)
                else:
                    c, sub = self._submit(app_id, channel_id, part, [rec])
                    c.help_until(sub)
            return eid
        c, sub = self._submit(app_id, channel_id, part, [rec])
        c.help_until(sub)
        return eid

    def _insert_overwrite(self, rec: _Record, app_id, channel_id, part):
        """The cross-file overwrite-by-id path (caller holds the id's
        stripe lock): direct append to the routed shard, then sweep the
        id out of every other file. Appending BEFORE sweeping means an
        append failure or a crash leaves the old copy intact (worst
        outcome is a duplicate repaired on the next overwrite, never
        loss)."""
        idx = self._entidx.get((app_id, channel_id, part))
        if idx is not None:
            # sidecar line BEFORE the log append (crash ordering: a
            # dangling indexed id is skipped at read; a missing one
            # would be a wrong filtered result)
            idx.add(rec.ent, rec.tgt, rec.eid)
        hkey = (app_id, channel_id, part)
        while True:
            h, lk = self._handle_of(app_id, channel_id, part)
            with timed_acquire(lk, self._append_lock_wait):
                if self._stale(hkey, h):
                    continue           # lost a race with remove(): reopen
                rc = self.lib.el_append(
                    h, rec.key, len(rec.key), rec.payload,
                    len(rec.payload), rec.ts, rec.ehash, rec.nhash,
                    rec.thash)
                if rc != 0:
                    raise IOError("append failed")
                if self.lib.el_flush(h) != 0:
                    raise IOError("event log flush failed")
                if self._fsync_ms == 0 and self.lib.el_sync(h) != 0:
                    raise IOError("fsync failed")
            break
        if self._fsync_ms > 0:
            self._mark_dirty(hkey)
        for okey, oh, olk in self._read_handles(app_id, channel_id):
            if okey[2] == part:
                continue
            with olk:
                if not self._stale(okey, oh):
                    self.lib.el_delete(oh, rec.key, len(rec.key))

    def insert_batch(self, events, app_id, channel_id=None):
        """Bulk write as at most one group submission per touched
        sub-log: ids are minted in one pass, in-batch id duplicates
        resolve to the LAST occurrence (what the serial overwrite path
        converged to), and each partition's records commit as one
        ``el_append_batch`` group. The columnar ingest route and the
        spill replayer land here."""
        if not events:
            return []           # nothing to commit — and no meta
        #                         re-anchor (the empty-batch re-anchor
        #                         would move the meta for nothing)
        pairs = [(e, e.event_id or new_event_id()) for e in events]
        last = {eid: i for i, (_, eid) in enumerate(pairs)}
        routed: List[Tuple[_Record, int, bool]] = []
        for i, (event, eid) in enumerate(pairs):
            if last[eid] != i:
                continue        # superseded within the batch: last wins
            routed.append((self._record_of(event, eid),
                           self._write_part(event),
                           bool(event.event_id)
                           and not event.id_minted))
        pre = []
        if self.partitions > 1:
            pre = [(r.key, r.eid, p) for r, p, owns in routed if owns]
        # caller-supplied ids hold their overwrite stripes across
        # probe -> commit, exactly like the single-insert path: a
        # same-id write racing the gap between an unlocked probe and
        # the group commit would leave two live copies of the id in
        # different shards. Stripes acquire in sorted index order (no
        # deadlock against other sorted batches or the single path's
        # one stripe), and progress is self-made — we lead our own
        # group commits — so holding them across help_until cannot
        # wedge. The common minted-id batch (event server, spill
        # replay) takes zero stripes.
        stripes = sorted({_hash(self.lib, eid) & 63
                          for _, eid, _ in pre})
        for s in stripes:
            self._overwrite_locks[s].acquire()
        try:
            overwrite_ids: set = set()
            if pre:
                # one lock acquisition per FILE for the whole batch's
                # caller-supplied ids, instead of per-event probing
                overwrite_ids = self._ids_in_other_files(
                    app_id, channel_id, pre)
            by_part: Dict[int, List[_Record]] = {}
            touched = set()
            for rec, part, _owns in routed:
                if rec.eid in overwrite_ids:
                    # stripe already held (acquired above)
                    self._insert_overwrite(rec, app_id, channel_id,
                                           part)
                    touched.add(part)
                else:
                    by_part.setdefault(part, []).append(rec)
            waits = [self._submit(app_id, channel_id, p, recs)
                     for p, recs in by_part.items()]
            for c, sub in waits:
                c.help_until(sub)
        finally:
            for s in reversed(stripes):
                self._overwrite_locks[s].release()
        self._reanchor(app_id, channel_id, touched | set(by_part))
        return [eid for _, eid in pairs]

    def _reanchor(self, app_id, channel_id, parts):
        """Batch boundaries are cheap sync points: re-anchor each
        touched shard's meta fingerprint so a clean restart adopts the
        sidecar without a rebuild."""
        for p in parts:
            idx = self._entidx.get((app_id, channel_id, p))
            if idx is not None and idx.loaded:
                idx.mark_clean(self._shard_bytes(app_id, channel_id, p))

    def _hash_column(self, strs, prefix: str = "") -> np.ndarray:
        """FNV-1a of n strings (each optionally prefixed) in ONE FFI
        crossing (el_hash_batch vs 3 per-record el_hash round trips — a
        measured ~30% of the Python bulk loop). Zero-length strings
        hash to 0, the record header's 'target absent' convention. The
        all-ASCII column (every id the wire normally carries) encodes
        with ONE str.encode — byte extents equal string lengths —
        instead of n; a scalar entity type rides as ``prefix`` so the
        per-row "type\\x00id" keys are never materialized (prefix +
        prefix.join is one C-level concat)."""
        n = len(strs)
        out = np.empty(n, dtype=np.uint64)
        if n == 0:
            return out
        joined = (prefix + prefix.join(strs)) if prefix else "".join(strs)
        if joined.isascii():
            buf = joined.encode("ascii")
            lens = np.fromiter(map(len, strs), dtype=np.int64, count=n)
            if prefix:
                lens += len(prefix)
        else:
            if prefix:
                strs = [prefix + s for s in strs]
            bufs = [s.encode("utf-8") for s in strs]
            buf = b"".join(bufs)
            lens = np.fromiter(map(len, bufs), dtype=np.int64, count=n)
        offs = np.empty(n + 1, dtype=np.int64)
        offs[0] = 0
        np.cumsum(lens, out=offs[1:])
        self.lib.el_hash_batch(
            buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        return out

    #: rows per pipelined sub-batch (see insert_columnar)
    _COLUMNAR_CHUNK = 16384

    def insert_columnar(self, batch, app_id, channel_id=None):
        """Vectorized columnar bulk write — the ≥10x ingest fast path
        One id-mint pass (a single os.urandom
        call), record JSON built by string templating with the
        broadcast columns' fragments computed once (no Event objects,
        no per-event json.dumps), each hash column in one
        el_hash_batch FFI crossing, and ONE pre-framed _Block
        submission per touched sub-log riding the same group
        committers as every other writer (bulk and single writers
        interleave without convoying). Payloads are ASCII by
        construction (ensure_ascii dumps + escaped ids), so byte
        extents equal string lengths and the column joins to one
        contiguous buffer without a per-row encode.

        Large batches pipeline in _COLUMNAR_CHUNK-row sub-batches: a
        worker thread drives chunk k's group commit (the C append
        releases the GIL) while this thread builds chunk k+1's arrays,
        overlapping string work and fwrite/index work on two cores.
        Requires ids to be distinct batch-wide (minted ids always are;
        the event server pre-mints for spill replay): with an in-batch
        duplicate, last-wins dedup and the cross-file overwrite probe
        need the whole batch at once, so those stay single-shot."""
        n = batch.n
        if n == 0:
            return []
        ck = self._COLUMNAR_CHUNK
        if n > ck + (ck >> 1) and (
                batch.event_id is None or batch.minted
                or (all(batch.event_id)
                    and len(set(batch.event_id)) == n)):
            # whole-column time pre-pass: a malformed cell must raise
            # BEFORE chunk 0 commits — failing mid-pipeline would leave
            # earlier chunks durable under a request that 400s (the
            # server route pre-validates, but direct DAO callers get
            # the same no-partial-commit contract)
            et = batch.event_time
            if isinstance(et, list):
                for x in et:
                    if x:
                        parse_event_time(x)
            ids: List[str] = []
            touched: set = set()
            futures = []
            with ThreadPoolExecutor(1) as pool:
                for lo in range(0, n, ck):
                    cids, waits, t0 = self._columnar_submit(
                        batch.slice_rows(lo, min(lo + ck, n)),
                        app_id, channel_id)
                    ids.extend(cids)
                    touched |= t0
                    futures.append(pool.submit(self._help_all, waits))
                for f in futures:
                    touched |= f.result()
            self._reanchor(app_id, channel_id, touched)
            return ids
        ids, waits, touched = self._columnar_submit(batch, app_id,
                                                    channel_id)
        touched |= self._help_all(waits)
        self._reanchor(app_id, channel_id, touched)
        return ids

    @staticmethod
    def _help_all(waits) -> set:
        touched = set()
        for p, (c, sub) in waits:
            c.help_until(sub)
            touched.add(p)
        return touched

    def _columnar_submit(self, batch, app_id, channel_id):
        """Build one batch's pre-framed blocks and enqueue them on the
        per-partition committers WITHOUT driving the commits; returns
        (ids, waits, touched-parts-so-far) for the caller to help."""
        n = batch.n
        enc = json.encoder.encode_basestring_ascii
        # -- ids: one mint pass. batch.minted ids (server pre-mint for
        # spill replay) are OUR fresh hex — they keep the whole minted
        # fast path: inline-quotable, distinct by construction, cannot
        # pre-exist in another file -----------------------------------------
        ids = batch.event_id
        keep: Optional[List[int]] = None
        supplied = ids is not None and not batch.minted
        if ids is None:
            ids = new_event_ids(n)
            hexes = "".join(ids)
            id_frags = None           # minted hex: inline-quotable
        elif not supplied:
            hexes = "".join(ids)
            id_frags = None
        else:
            ids = [x if x else new_event_id() for x in ids]
            id_frags = [enc(x) for x in ids]
            last = {eid: i for i, eid in enumerate(ids)}
            if len(last) != n:
                # in-batch duplicate ids resolve to the LAST occurrence
                # (what the serial overwrite path converged to)
                keep = [i for i, eid in enumerate(ids) if last[eid] == i]
        # -- hash columns + shard routing -----------------------------------
        ents = batch.entity_id
        etype = batch.entity_type
        if isinstance(etype, str):
            et_frag, et_frags = enc(etype), None
            eh = self._hash_column(ents, prefix=f"{etype}\x00")
        else:
            et_frag, et_frags = None, [enc(t) for t in etype]
            eh = self._hash_column(
                [f"{t}\x00{e}" for t, e in zip(etype, ents)])
        name = batch.event
        if isinstance(name, str):
            ev_frag, ev_frags = enc(name), None
            nh = np.full(n, _hash(self.lib, name), dtype=np.uint64)
        else:
            ev_frag, ev_frags = None, [enc(x) for x in name]
            nh = self._hash_column(name)
        tids = batch.target_entity_id
        tt = batch.target_entity_type
        if tids is None:
            th = np.zeros(n, dtype=np.uint64)
            tgt_frags = None
        else:
            if isinstance(tt, str):
                ttf = enc(tt)
                tkeys = [f"{tt}\x00{t}" if t else "" for t in tids]
                tgt_frags = [
                    f',"targetEntityType":{ttf},"targetEntityId":{enc(t)}'
                    if t else "" for t in tids]
            else:
                tts = tt or (None,) * n
                tkeys = [f"{a}\x00{b}" if b and a else ""
                         for a, b in zip(tts, tids)]
                tgt_frags = [
                    f',"targetEntityType":{enc(a)}'
                    f',"targetEntityId":{enc(b)}' if b and a else ""
                    for a, b in zip(tts, tids)]
            th = self._hash_column(tkeys)
        # -- times ----------------------------------------------------------
        now = utcnow()
        now_s = format_event_time(now)
        et = batch.event_time
        if et is None:
            t_const, t_frags = now_s, None
            ts = np.full(n, to_millis(now), dtype=np.int64)
        elif isinstance(et, str):
            t = parse_event_time(et)
            t_const, t_frags = format_event_time(t), None
            ts = np.full(n, to_millis(t), dtype=np.int64)
        else:
            parsed = [parse_event_time(x) if x else now for x in et]
            t_const, t_frags = None, [format_event_time(x)
                                      for x in parsed]
            ts = np.array([to_millis(x) for x in parsed],
                          dtype=np.int64)
        # -- properties ------------------------------------------------------
        props = batch.properties
        p_frags = None if props is None else _props_col(props)
        # -- payload templating: broadcast columns are inlined into the
        # template as escaped literals, so each row pays ONE %-format
        # over only the per-row columns (the common "all rate events
        # now" shape formats 4 args, not 8) ---------------------------------
        tmpl: List[str] = ['{"eventId":']
        cols: List[list] = []

        def seg(frags, const=""):
            if frags is None:
                tmpl.append(const.replace("%", "%%"))
            else:
                tmpl.append("%s")
                cols.append(frags)

        if id_frags is not None:
            seg(id_frags)
        else:
            tmpl.append('"%s"')       # minted hex: inline-quotable
            cols.append(ids)
        tmpl.append(',"event":')
        seg(ev_frags, ev_frag)
        tmpl.append(',"entityType":')
        seg(et_frags, et_frag)
        tmpl.append(',"entityId":')
        seg([enc(e) for e in ents])
        seg(tgt_frags)
        tmpl.append(',"properties":')
        seg(p_frags, "{}")
        tmpl.append(',"eventTime":"')
        seg(t_frags, t_const)
        tmpl.append(f'","tags":[],"creationTime":"{now_s}"}}')
        fmt = "".join(tmpl)
        payloads = [fmt % tup for tup in zip(*cols)]
        # minted ids skip per-row key encodes entirely: the hex pool IS
        # the concatenated key buffer (32 bytes each, constant extents)
        keys_b = ([s.encode("utf-8") for s in ids] if supplied else None)
        # -- routing: shards, cross-file overwrites -------------------------
        parts = ((eh % np.uint64(self.partitions)).astype(np.int64)
                 if self.partitions > 1 else None)
        rows = keep if keep is not None else range(n)
        overwrite: set = set()
        if supplied and parts is not None:
            # KNOWN WINDOW: this probe runs outside the overwrite
            # stripe locks (holding every supplied id's stripe across
            # a pipelined multi-chunk commit would stall all
            # concurrent supplied-id writers for the import's
            # duration). A same-id write racing the gap can leave a
            # cross-shard duplicate — the same artifact a crash can
            # leave, and repaired the same way: the next overwrite of
            # that id sweeps every other file. insert_batch (the
            # bounded server/replay path) holds its stripes instead.
            found = self._ids_in_other_files(
                app_id, channel_id,
                [(keys_b[i], ids[i], int(parts[i])) for i in rows])
            if found:
                overwrite = {i for i in rows if ids[i] in found}
                for i in sorted(overwrite):
                    rec = self._record_of(batch.row_event(i), ids[i])
                    with self._overwrite_locks[_hash(self.lib,
                                                     ids[i]) & 63]:
                        self._insert_overwrite(rec, app_id, channel_id,
                                               int(parts[i]))

        def block_of(sel: Optional[List[int]]) -> _Block:
            if sel is None:               # the hot path: all rows, no
                #                           gather — arrays used as built
                if keys_b is None:
                    kcat = hexes.encode("ascii")
                    keylens = (np.full(n, 32, dtype=np.int32)
                               if len(hexes) == (n << 5) else
                               np.fromiter(map(len, ids),
                                           dtype=np.int32, count=n))
                else:
                    kcat = b"".join(keys_b)
                    keylens = np.fromiter(map(len, keys_b),
                                          dtype=np.int32, count=n)
                datalens = np.fromiter(map(len, payloads),
                                       dtype=np.int64, count=n)
                return _Block(n, kcat, keylens,
                              "".join(payloads).encode("ascii"),
                              datalens, ts, eh, nh, th, ents, tids, ids)
            kb = ([keys_b[i] for i in sel] if keys_b is not None
                  else [ids[i].encode("ascii") for i in sel])
            pl = [payloads[i] for i in sel]
            m = len(sel)
            return _Block(
                m, b"".join(kb),
                np.fromiter(map(len, kb), dtype=np.int32, count=m),
                "".join(pl).encode("ascii"),
                np.fromiter(map(len, pl), dtype=np.int64, count=m),
                ts[sel], eh[sel], nh[sel], th[sel],
                [ents[i] for i in sel],
                None if tids is None else [tids[i] for i in sel],
                [ids[i] for i in sel])

        waits = []
        touched = set(int(parts[i]) for i in overwrite) if overwrite \
            else set()
        if parts is None and keep is None:
            waits.append((0, self._submit(app_id, channel_id, 0, [],
                                          block_of(None))))
        else:
            by_part: Dict[int, List[int]] = {}
            for i in rows:
                if i in overwrite:
                    continue
                by_part.setdefault(
                    0 if parts is None else int(parts[i]), []).append(i)
            for p, sel in by_part.items():
                waits.append((p, self._submit(app_id, channel_id, p, [],
                                              block_of(sel))))
        return ids, waits, touched

    def _decode(self, h, eid_bytes: bytes) -> Optional[Event]:
        n = self.lib.el_get(h, eid_bytes, len(eid_bytes))
        if n < 0:
            return None
        buf = ctypes.string_at(self.lib.el_buf(h), n)
        return Event.from_dict(json.loads(buf.decode("utf-8")))

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        # event ids carry no partition information: probe each shard
        # (P is small; the id index makes each probe O(1))
        for hkey, h, lk in self._read_handles(app_id, channel_id):
            with lk:
                if self._stale(hkey, h):
                    continue
                e = self._decode(h, event_id.encode("utf-8"))
            if e is not None:
                return e
        return None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        # delete from EVERY file holding the id (a shard copy and a
        # stale legacy copy must both go, or the legacy one resurrects)
        key = event_id.encode()
        any_deleted = False
        for hkey, h, lk in self._read_handles(app_id, channel_id):
            with lk:
                if self._stale(hkey, h):
                    continue
                if self.lib.el_delete(h, key, len(key)) == 0:
                    any_deleted = True
        return any_deleted

    def _scan_hashes(self, entity_type, entity_id, event_names,
                     target_entity_type, target_entity_id):
        """Coarse-predicate hash arguments shared by every C scan entry
        point (el_scan / el_scan_ts): 0 means no filter."""
        entity_hash = 0
        if entity_type is not None and entity_id is not None:
            entity_hash = _hash(self.lib, f"{entity_type}\x00{entity_id}")
        target_hash = 0
        if (target_entity_type not in (None, ABSENT)
                and target_entity_id not in (None, ABSENT)):
            target_hash = _hash(
                self.lib, f"{target_entity_type}\x00{target_entity_id}")
        if event_names:
            arr = (ctypes.c_uint64 * len(event_names))(
                *[_hash(self.lib, n) for n in event_names])
            n_names = len(event_names)
        else:
            arr = None
            n_names = 0
        return entity_hash, arr, n_names, target_hash

    def _coarse_scan_ms(self, h, start_ms, until_ms, entity_type,
                        entity_id, event_names, target_entity_type,
                        target_entity_id) -> int:
        """Millisecond-window coarse scan (caller holds the handle's
        per-handle lock — NOT self._lock; scan state is per-handle and
        concurrent scans on other handles may run). ``_INT64_MIN``
        means unbounded on that side."""
        entity_hash, arr, n_names, target_hash = self._scan_hashes(
            entity_type, entity_id, event_names, target_entity_type,
            target_entity_id)
        return self.lib.el_scan(h, start_ms, until_ms, entity_hash, arr,
                                n_names, target_hash)

    def _coarse_scan(self, h, start_time, until_time, entity_type,
                     entity_id, event_names, target_entity_type,
                     target_entity_id) -> int:
        """Push the coarse predicates down to C (datetime-flavored
        wrapper over ``_coarse_scan_ms``)."""
        return self._coarse_scan_ms(
            h,
            to_millis(start_time) if start_time else _INT64_MIN,
            to_millis(until_time) if until_time else _INT64_MIN,
            entity_type, entity_id, event_names, target_entity_type,
            target_entity_id)

    def _scan_one(self, hkey, h, lk, start_time=None, until_time=None,
                  entity_type=None, entity_id=None, event_names=None,
                  target_entity_type=None, target_entity_id=None):
        """Coarse-filtered scan + ONE bulk payload fetch of a single
        sub-log through the FFI (el_scan_fetch); returns raw JSON
        payload bytes per record."""
        with lk:
            if self._stale(hkey, h):
                return []          # store removed mid-read
            self._coarse_scan(h, start_time, until_time, entity_type,
                              entity_id, event_names,
                              target_entity_type, target_entity_id)
            total = self.lib.el_scan_fetch(h)
            if total < 0:
                raise IOError("bulk scan fetch failed")
            n = self.lib.el_scan_nfetched(h)
            data = ctypes.string_at(self.lib.el_scan_data(h), total)
            offs = self.lib.el_scan_offsets(h)
            return [data[offs[i]:offs[i + 1]] for i in range(n)]

    def _bulk_scan_payloads(self, app_id, channel_id, start_time,
                            until_time, entity_type, entity_id,
                            event_names, target_entity_type,
                            target_entity_id):
        """_scan_one over every file a read must consult, shards scanned
        in parallel."""
        handles = self._read_handles(app_id, channel_id, entity_type,
                                     entity_id)
        payloads = []
        for chunk in self._parallel(
                [lambda k=k, h=h, lk=lk: self._scan_one(
                    k, h, lk, start_time, until_time, entity_type,
                    entity_id, event_names, target_entity_type,
                    target_entity_id)
                 for k, h, lk in handles]):
            payloads.extend(chunk)
        return payloads

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None, limit=None,
             reversed_order=False):
        payloads = self._bulk_scan_payloads(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id)
        events = []
        for raw in payloads:
            e = Event.from_dict(json.loads(raw.decode("utf-8")))
            # exact residual filtering (hash false-positives + partial
            # predicates the coarse pass cannot express)
            if base.match_event(e, start_time, until_time, entity_type,
                                entity_id, event_names,
                                target_entity_type, target_entity_id):
                events.append(e)
        events.sort(key=lambda e: e.event_time, reverse=reversed_order)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return iter(events)


    def find_columnar_by_entities(self, app_id, channel_id=None,
                                  entity_ids=None, target_entity_ids=None,
                                  property_field=None, start_time=None,
                                  until_time=None, entity_type=None,
                                  target_entity_type=None, event_names=None,
                                  limit=None):
        """Seek+read through the persisted entity-index sidecar: the
        touched ids' event ids come from the index, each record is an
        O(1) ``el_get`` probe — per-read cost proportional to the
        touched histories, never the log size. The first call on an
        adopted store pays one per-shard rebuild (see _EntityIndex)."""
        indexes = self._index_of(app_id, channel_id)
        eset = {str(x) for x in (entity_ids or ())}
        tset = {str(x) for x in (target_entity_ids or ())}
        candidates: Dict[str, None] = {}   # ordered cross-shard de-dup
        for idx in indexes:
            for eid in idx.candidate_ids(eset, tset):
                candidates[eid] = None
        events = []
        for eid in candidates:
            e = self.get(eid, app_id, channel_id)
            if e is None:
                continue     # deleted (or dangling sidecar line)
            # membership re-check: an overwrite-by-id may have re-routed
            # the event to entities outside the requested sets while the
            # old index line still names it
            if not (e.entity_id in eset
                    or (e.target_entity_id or "") in tset):
                continue
            if not base.match_event(e, start_time, until_time,
                                    entity_type, None, event_names,
                                    target_entity_type, None):
                continue
            events.append(e)
        events.sort(key=lambda e: e.event_time)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return base.events_to_columnar(events, property_field)

    def _columnar_shard(self, hkey, h, lk, property_field, start_ms,
                        until_ms, entity_type, entity_id, event_names,
                        target_entity_type, target_entity_id):
        """Columnar extraction of one shard over a millisecond window
        (own lock: shard scans run concurrently; all scan state is
        per-handle). Returns ``_STALE`` when the handle was invalidated
        mid-read, ``None`` when the window matched nothing, else
        ``(columns, needs_unicode_flags)``."""
        import numpy as np

        with lk:
            if self._stale(hkey, h):
                return _STALE      # namespace removed/restored mid-read
            self._coarse_scan_ms(h, start_ms, until_ms, entity_type,
                                 entity_id, event_names,
                                 target_entity_type, target_entity_id)
            n = self.lib.el_scan_columnar(
                h, (property_field or "").encode("utf-8"))
            if n < 0:
                raise IOError("columnar scan failed")
            if n == 0:
                return None
            ts = np.ctypeslib.as_array(
                self.lib.el_col_ts(h), (n,)).copy()
            prop = np.ctypeslib.as_array(
                self.lib.el_col_prop(h), (n,)).astype(np.float32)
            flags = np.ctypeslib.as_array(
                self.lib.el_col_fallback(h), (n,)).copy()

            def col(cid):
                """[n] fixed-width BYTES array for string column
                `cid` with zero per-record Python work: C fills a
                row-major padded [n, maxlen] byte matrix (GIL
                released, so shard columns fill in parallel) and
                numpy views it as S-dtype — a 5M-row column costs
                two C passes instead of 5M object allocations. The
                unicode cast is deferred to the filtered/ordered
                END of the merge (to_unicode below): filters and
                gathers run on the ~4x narrower bytes arrays."""
                na = ctypes.c_uint8(0)
                m = self.lib.el_col_maxlen(h, cid, ctypes.byref(na))
                if m < 0:
                    raise IOError("columnar state missing")
                if m == 0:
                    return np.zeros(n, dtype="S1"), False
                mat = np.zeros((n, int(m)), dtype=np.uint8)
                if self.lib.el_col_fill(
                        h, cid,
                        mat.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_uint8)),
                        int(m)) != n:
                    raise IOError("columnar fill failed")
                return mat.view(f"S{int(m)}")[:, 0], bool(na.value)

            (ents, na0), (tgts, na1), (names, na2), \
                (etypes, na3), (ttypes, na4) = (
                    col(0), col(1), col(2), col(3), col(4))
            nas = [na0, na1, na2, na3, na4]

            # exact fallback for flagged records (escaped strings
            # etc.): collected as index -> value, applied after the
            # arrays exist (assignment into a fixed-width unicode
            # array would silently truncate longer replacements, so
            # the column is widened first)
            repl = {k: {} for k in range(5)}
            for i in np.nonzero(flags)[0]:
                out = ctypes.POINTER(ctypes.c_uint8)()
                klen = self.lib.el_scan_key(h, int(i),
                                            ctypes.byref(out))
                if klen < 0:
                    continue
                m = self.lib.el_get(h, ctypes.string_at(out, klen),
                                    klen)
                if m < 0:
                    continue
                d = json.loads(ctypes.string_at(
                    self.lib.el_buf(h), m).decode("utf-8"))
                i = int(i)
                repl[0][i] = d.get("entityId", "")
                repl[1][i] = d.get("targetEntityId") or ""
                repl[2][i] = d["event"]
                repl[3][i] = d.get("entityType", "")
                repl[4][i] = d.get("targetEntityType") or ""
                if property_field is not None:
                    v = (d.get("properties") or {}).get(property_field)
                    prop[i] = (np.nan
                               if not isinstance(v, (int, float))
                               or isinstance(v, bool) else float(v))

            def patched(arr, r, ci):
                if not r:
                    return arr
                enc = {i: v.encode("utf-8") for i, v in r.items()}
                if any(len(b) != len(v)
                       for b, v in zip(enc.values(), r.values())):
                    nas[ci] = True
                w = max(arr.dtype.itemsize,
                        max(len(b) for b in enc.values()), 1)
                arr = arr.astype(f"S{w}")
                for i, b in enc.items():
                    arr[i] = b
                return arr

            return ([patched(a, repl[ci], ci) for ci, a in
                     enumerate((ents, tgts, names, etypes, ttypes))]
                    + [ts, prop], nas)


    @staticmethod
    def _empty_columnar(property_field):
        import numpy as np

        empty = {"entity_id": np.array([], dtype=str),
                 "target_entity_id": np.array([], dtype=str),
                 "event": np.array([], dtype=str),
                 "t": np.array([], dtype=np.int64)}
        if property_field is not None:
            empty["prop"] = np.array([], dtype=np.float32)
        return empty

    def _columnar_merge(self, results, property_field, entity_type,
                        entity_id, event_names, target_entity_type,
                        target_entity_id, limit=None,
                        reversed_order=False):
        """Merge per-shard columnar results (shard/handle order is the
        intra-millisecond tiebreak — the chunked reader relies on it
        being identical between a one-shot read and each window) and
        apply the exact residual filters + stable time sort."""
        import numpy as np

        na_any = [any(r[1][i] for r in results) for i in range(5)]
        shards = [r[0] for r in results]
        ents, tgts, names, etypes, ttypes, ts, prop = (
            np.concatenate([s[i] for s in shards]) for i in range(7))
        n = len(ts)
        # residual exact filters, vectorized on the BYTES columns (hash
        # false-positives + predicates the coarse pass cannot express;
        # b'' == absent; predicates are utf-8 encoded to match)
        keep = np.ones(n, dtype=bool)
        if event_names is not None:
            keep &= np.isin(names, [s.encode("utf-8")
                                    for s in event_names])
        if entity_type is not None:
            keep &= etypes == entity_type.encode("utf-8")
        if entity_id is not None:
            keep &= ents == entity_id.encode("utf-8")
        if target_entity_type is not None:
            keep &= ((ttypes == b"") if target_entity_type is ABSENT
                     else (ttypes == target_entity_type.encode("utf-8")))
        if target_entity_id is not None:
            keep &= ((tgts == b"") if target_entity_id is ABSENT
                     else (tgts == target_entity_id.encode("utf-8")))
        order = np.argsort(ts[keep], kind="stable")
        if reversed_order:
            order = order[::-1]
        if limit is not None and limit >= 0:
            order = order[:limit]

        def to_unicode(arr, na):
            # the cast runs on the kept/ordered subset only
            if na and arr.size:
                return np.char.decode(arr, "utf-8")
            return arr.astype(str)

        out = {"entity_id": to_unicode(ents[keep][order], na_any[0]),
               "target_entity_id": to_unicode(tgts[keep][order],
                                              na_any[1]),
               "event": to_unicode(names[keep][order], na_any[2]),
               "t": ts[keep][order]}
        if property_field is not None:
            out["prop"] = prop[keep][order]
        return out

    def find_columnar(self, app_id, channel_id=None, property_field=None,
                      start_time=None, until_time=None, entity_type=None,
                      entity_id=None, event_names=None,
                      target_entity_type=None, target_entity_id=None,
                      limit=None, reversed_order=False):
        """Columnar ingest, C-side extraction: event times come from the
        record headers, string fields and the numeric property from the
        native scanner (el_scan_columnar) — zero JSON parsing on the fast
        path. Records the scanner can't handle exactly (escapes, exotic
        types) are flagged and re-parsed here, so correctness never
        depends on the fast path (the HBPEvents scan-to-RDD role)."""
        start_ms = to_millis(start_time) if start_time else _INT64_MIN
        until_ms = to_millis(until_time) if until_time else _INT64_MIN
        handles = self._read_handles(app_id, channel_id, entity_type,
                                     entity_id)
        results = [s for s in self._parallel(
            [lambda k=k, h=h, lk=lk: self._columnar_shard(
                k, h, lk, property_field, start_ms, until_ms,
                entity_type, entity_id, event_names,
                target_entity_type, target_entity_id)
             for k, h, lk in handles])
            if s is not None and s is not _STALE]
        if not results:
            return self._empty_columnar(property_field)
        return self._columnar_merge(
            results, property_field, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id, limit, reversed_order)

    def find_columnar_chunked(self, app_id, channel_id=None,
                              property_field=None, chunk_rows=None,
                              start_time=None, until_time=None,
                              entity_type=None, entity_id=None,
                              event_names=None, target_entity_type=None,
                              target_entity_id=None):
        """Streaming columnar read with REAL pushdown: one ts-only
        planning scan per shard (el_scan_ts — index walk, zero payload
        IO) sizes complete-millisecond windows to ``chunk_rows`` up
        front, then each window runs the parallel per-shard extraction
        over its [start, until) range so every chunk costs O(window),
        never O(remaining corpus).

        Consistency contract (the prefix-consistent snapshot model):

        * chunk-concatenation is byte-identical to a one-shot
          ``find_columnar`` over the same range — windows only break at
          complete milliseconds and the merge sort is stable by ``t``,
          so intra-millisecond (shard, log) order is preserved;
        * events inserted mid-stream at/after the cursor ARE seen (each
          window re-scans the live index); events landing behind the
          cursor are not — the reader is a forward cursor, not a
          repeatable snapshot;
        * ``invalidate_namespace`` / ``remove`` mid-stream ENDS the
          stream before the next chunk (handle-identity check + the
          per-shard ``_STALE`` signal): an in-flight reader sees a
          consistent prefix of the pre-restore store, never a mix. A
          reader opened after the restore sees the restored store.
        """
        import numpy as np

        chunk_rows = int(chunk_rows or base.DEFAULT_CHUNK_ROWS)
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        start_ms = to_millis(start_time) if start_time else _INT64_MIN
        until_ms = to_millis(until_time) if until_time else _INT64_MIN
        handles = self._read_handles(app_id, channel_id, entity_type,
                                     entity_id)
        if not handles:
            return

        def plan_one(hkey, h, lk):
            with lk:
                if self._stale(hkey, h):
                    return _STALE
                eh, arr, nn, th = self._scan_hashes(
                    entity_type, entity_id, event_names,
                    target_entity_type, target_entity_id)
                n = self.lib.el_scan_ts(h, start_ms, until_ms, eh, arr,
                                        nn, th)
                if n < 0:
                    raise IOError("planning scan failed")
                if n == 0:
                    return np.array([], dtype=np.int64)
                return np.ctypeslib.as_array(
                    self.lib.el_plan_ts(h), (n,)).copy()

        planned = self._parallel(
            [lambda k=k, h=h, lk=lk: plan_one(k, h, lk)
             for k, h, lk in handles])
        if any(p is _STALE for p in planned):
            return
        ts_all = np.sort(np.concatenate(planned))
        # complete-millisecond boundaries targeting chunk_rows per
        # window; a single-millisecond burst larger than the chunk is
        # taken as one whole (oversized) window — a millisecond is
        # never split across chunks
        bounds = []
        i, total = 0, len(ts_all)
        while total - i > chunk_rows:
            b = int(ts_all[i + chunk_rows])
            if b == int(ts_all[i]):
                b += 1
            bounds.append(b)
            i = int(np.searchsorted(ts_all, b, side="left"))
        windows = list(zip([start_ms] + bounds, bounds + [until_ms]))

        for w0, w1 in windows:
            results = self._parallel(
                [lambda k=k, h=h, lk=lk: self._columnar_shard(
                    k, h, lk, property_field, w0, w1, entity_type,
                    entity_id, event_names, target_entity_type,
                    target_entity_id)
                 for k, h, lk in handles])
            if any(r is _STALE for r in results):
                return      # restored mid-stream: stop, never tear
            # handle-identity re-check right before the yield: a restore
            # that landed after the window scans finished must not let
            # this (complete, but pre-restore) chunk imply the stream
            # continued past it
            if any(self._handles.get(k) is not h for k, h, _ in handles):
                return
            results = [r for r in results if r is not None]
            if not results:
                continue
            out = self._columnar_merge(
                results, property_field, entity_type, entity_id,
                event_names, target_entity_type, target_entity_id)
            if len(out["t"]):
                yield out
