"""Shard-snapshot shipping for the nativelog event store.

The port's copy of `predictionio_tpu/data/storage/snapshot.py`. The file
stems (`events_<app>_<channel>`), the `PARTITIONS` check and the
manifest's keys are the reference's, so a snapshot either package took
is restored by the other.

The reference's default event store is a replicated, partitioned cluster
DB — durability comes from HBase's region replication and snapshot/export
tooling (reference: data/src/main/scala/io/prediction/data/storage/hbase/
HBEventsUtil.scala:81-129 rowkey/region design; HBPEvents.scala:42-80
cluster scans). This environment is single-host, so the honest equivalent
is snapshot shipping: copy each shard's append-only log file to a
URI-addressed remote blob store (``remotefs`` scheme registry — file://
works out of the box, hdfs/gs/s3 plug in via ``register_scheme``) with a
checksummed manifest, and restore by fetching the files back into a fresh
store directory, where the normal open path (torn-tail repair,
``native/eventlog.cpp``) takes over.

Because the log format is append-only (deletes are appended tombstones),
a snapshot taken while writes continue is prefix-consistent per shard: it
captures every record flushed before the copy and possibly a torn tail,
which restore-open repairs. Restoring therefore never yields a corrupt
store — at worst it is missing the records appended after the snapshot.

CLI: ``python -m predictionio_tpu_torch snapshot create|restore|list``
(tools/cli.py).
"""

from __future__ import annotations

import hashlib
import json
import logging
import posixpath
from typing import List, Optional

from predictionio_tpu_torch.data.event import format_event_time, utcnow
from predictionio_tpu_torch.data.storage.remotefs import adapter_for

logger = logging.getLogger(__name__)

_MANIFEST = "MANIFEST.json"


class SnapshotError(RuntimeError):
    pass


def _nativelog_events():
    """The active EVENTDATA backend, which must be the nativelog (file-
    level snapshots are shard-file copies; other backends have their own
    durability stories — pgsql replicates server-side, and any backend
    can fall back to the portable `pio export`)."""
    from predictionio_tpu_torch.data.storage.nativelog import NativeLogEvents
    from predictionio_tpu_torch.data.storage.registry import Storage
    ev = Storage.get_events()
    if not isinstance(ev, NativeLogEvents):
        raise SnapshotError(
            f"pio snapshot requires the nativelog event store "
            f"(EVENTDATA backend is {type(ev).__name__}); use pio "
            f"export for a portable JSON dump of other backends")
    return ev


def _snap_dir(root: str, name: str) -> str:
    return posixpath.join(root, "snapshots", name)


def create_snapshot(app_id: int, uri: str, name: Optional[str] = None,
                    channel_id: Optional[int] = None) -> dict:
    """Ship the namespace's shard files to `uri` under a named snapshot
    with a checksummed manifest; returns the manifest. Snapshots are
    immutable-by-convention: re-using a name overwrites it."""
    adapter, root = adapter_for(uri)
    ev = _nativelog_events()
    name = name or utcnow().strftime("%Y%m%dT%H%M%SZ")
    files = ev.snapshot_files(app_id, channel_id)
    if not files:
        raise SnapshotError(
            f"nothing to snapshot: app {app_id} channel {channel_id} "
            f"has no event log files")
    sdir = _snap_dir(root, name)
    entries: List[dict] = []
    for fname, path in files:
        with open(path, "rb") as f:
            data = f.read()
        adapter.write(posixpath.join(sdir, fname), data)
        entries.append({"file": fname, "bytes": len(data),
                        "sha256": hashlib.sha256(data).hexdigest()})
    manifest = {
        "name": name,
        "app_id": app_id,
        "channel_id": channel_id,
        "partitions": ev.partitions,
        "created": format_event_time(utcnow()),
        "files": entries,
    }
    # manifest last: a snapshot is visible only once all blobs landed
    adapter.write(posixpath.join(sdir, _MANIFEST),
                  json.dumps(manifest, indent=2).encode("utf-8"))
    logger.info("snapshot %s: %d file(s), %d bytes shipped to %s", name,
                len(entries), sum(e["bytes"] for e in entries), uri)
    return manifest


def read_manifest(uri: str, name: str) -> dict:
    adapter, root = adapter_for(uri)
    p = posixpath.join(_snap_dir(root, name), _MANIFEST)
    if not adapter.exists(p):
        raise SnapshotError(f"no snapshot {name!r} at {uri}")
    return json.loads(adapter.read(p).decode("utf-8"))


def restore_snapshot(uri: str, name: str,
                     app_id: Optional[int] = None,
                     channel_id: Optional[int] = None,
                     force: bool = False) -> dict:
    """Fetch a snapshot's shard files back into the live nativelog store
    (checksums verified before anything is written). The target
    namespace must be empty unless `force` — restore replaces, it never
    merges. `app_id`/`channel_id` default to the snapshot's own; pass
    them to restore into a different app (file names are rewritten).
    Returns the manifest."""
    adapter, root = adapter_for(uri)
    manifest = read_manifest(uri, name)
    ev = _nativelog_events()
    if manifest["partitions"] != ev.partitions:
        raise SnapshotError(
            f"snapshot {name!r} was taken with PARTITIONS="
            f"{manifest['partitions']} but this store is configured "
            f"with {ev.partitions}; restore into a store with the "
            f"matching setting")
    dst_app = manifest["app_id"] if app_id is None else app_id
    dst_ch = manifest["channel_id"] if channel_id is None else channel_id
    src_stem = f"events_{manifest['app_id']}_{manifest['channel_id'] or 0}"
    dst_stem = f"events_{dst_app}_{dst_ch or 0}"

    # refuse early: restore REPLACES the namespace, and every live file
    # under the dst stem counts — including a pre-partitioning legacy
    # log the snapshot may not name (every read path consults it, so
    # leaving it would merge old events into the restored data)
    import os

    def _namespace_files():
        return [f for f in os.listdir(ev.root)
                if f == f"{dst_stem}.log"
                or (f.startswith(f"{dst_stem}_p") and f.endswith(".log"))]

    if _namespace_files() and not force:
        existing = _namespace_files()
        raise SnapshotError(
            f"target namespace app {dst_app} channel {dst_ch} already "
            f"has {len(existing)} log file(s) (e.g. {existing[0]}); "
            f"restore replaces a namespace — pass --force to overwrite")

    # stage every blob to a .restore temp first, verifying its checksum
    # on THIS read (one shard in memory at a time): nothing live is
    # touched until every file sits verified on local disk, so a failed
    # fetch or a blob mutated since the manifest leaves the original
    # namespace intact
    sdir = _snap_dir(root, name)
    staged = []
    try:
        for e in manifest["files"]:
            if not e["file"].startswith(src_stem):
                raise SnapshotError(
                    f"manifest file {e['file']!r} does not match the "
                    f"snapshot's namespace {src_stem!r}")
            data = adapter.read(posixpath.join(sdir, e["file"]))
            digest = hashlib.sha256(data).hexdigest()
            if digest != e["sha256"]:
                raise SnapshotError(
                    f"checksum mismatch for {e['file']} in snapshot "
                    f"{name!r}: manifest {e['sha256'][:12]}…, blob "
                    f"{digest[:12]}… — refusing to restore")
            fname = dst_stem + e["file"][len(src_stem):]
            tmp = os.path.join(ev.root, fname + ".restore")
            with open(tmp, "wb") as f:
                f.write(data)
            del data
            staged.append((tmp, os.path.join(ev.root, fname)))
    except BaseException:
        for tmp, _ in staged:
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise

    if _namespace_files():
        ev.remove(dst_app, dst_ch)   # close handles + delete files
    for tmp, final in staged:
        os.replace(tmp, final)
    # the files changed under the DAO: drop its cached handles, its
    # negative-existence cache (a shard the store probed as missing
    # before the restore would otherwise stay invisible) and any
    # in-memory entity index for the namespace
    ev.invalidate_namespace(dst_app, dst_ch)
    logger.info("snapshot %s restored into app %s channel %s (%d files)",
                name, dst_app, dst_ch, len(manifest["files"]))
    return manifest


def list_snapshots(uri: str) -> List[dict]:
    """Manifests of every snapshot under `uri`. Listing needs a directory
    scan, which the byte-level SchemeAdapter interface doesn't offer —
    supported for local/mounted file:// roots; remote schemes raise
    rather than silently reporting an empty backup set."""
    import os
    from urllib.parse import urlparse
    adapter, root = adapter_for(uri)
    if urlparse(uri).scheme not in ("file", ""):
        raise SnapshotError(
            f"snapshot listing requires a file:// (or mounted) URI; "
            f"{uri!r} uses a byte-level adapter with no directory "
            f"listing — read a known snapshot name directly instead")
    base = posixpath.join(root, "snapshots")
    if not os.path.isdir(base):
        return []
    out = []
    for name in sorted(os.listdir(base)):
        p = posixpath.join(base, name, _MANIFEST)
        if adapter.exists(p):
            out.append(json.loads(adapter.read(p).decode("utf-8")))
    return out
