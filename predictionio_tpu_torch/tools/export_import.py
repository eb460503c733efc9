"""Event export/import: event store <-> JSON-lines or parquet files.

The port's copy of `predictionio_tpu/tools/export_import.py`, the
reference's export/import tools
(reference: tools/src/main/scala/io/prediction/tools/export/EventsToFile.scala:95
and imprt/FileToEvents.scala:39): one JSON event per line — the same
wire format as /events.json — or columnar parquet (the reference's
DEFAULT --format, EventsToFile.scala:35; here json stays the default
because it is the wire format, parquet is one flag away). The parquet
pair imports `pyarrow` when it is called; without it they raise an
ImportError that names pyarrow.
"""

from __future__ import annotations

import json as _json
from typing import Optional

from predictionio_tpu_torch.data.event import Event, EventValidation
from predictionio_tpu_torch.data.storage.registry import Storage


def export_events(app_id: int, output: str,
                  channel_id: Optional[int] = None) -> int:
    events = Storage.get_events()
    n = 0
    with open(output, "w") as f:
        for e in events.find(app_id=app_id, channel_id=channel_id):
            f.write(e.to_json())
            f.write("\n")
            n += 1
    return n


_PARQUET_COLS = ("eventId", "event", "entityType", "entityId",
                 "targetEntityType", "targetEntityId", "properties",
                 "eventTime", "tags", "prId", "creationTime")


def _pyarrow():
    """pyarrow and its parquet module, imported at the call."""
    try:
        import pyarrow
        import pyarrow.parquet
    except ImportError as e:
        raise ImportError(
            "the parquet format needs the pyarrow package, which is not "
            f"installed ({e}); use the default JSON-lines format") from e
    return pyarrow, pyarrow.parquet


def _parquet_schema():
    pa, _ = _pyarrow()
    return pa.schema([
        ("eventId", pa.string()), ("event", pa.string()),
        ("entityType", pa.string()), ("entityId", pa.string()),
        ("targetEntityType", pa.string()),
        ("targetEntityId", pa.string()),
        ("properties", pa.string()),
        ("eventTime", pa.timestamp("ms", tz="UTC")),
        ("tags", pa.list_(pa.string())), ("prId", pa.string()),
        ("creationTime", pa.timestamp("ms", tz="UTC")),
    ])


def export_events_parquet(app_id: int, output: str,
                          channel_id: Optional[int] = None,
                          batch_size: int = 10000) -> int:
    """Columnar export for analytics pipelines (the role of the
    reference's default parquet format, EventsToFile.scala:35,94).
    Schema mirrors the event wire format; free-form `properties` ride
    as a JSON string column (parquet wants a stable schema, and event
    properties deliberately have none — the reference's SQLContext
    json-infers per export, which bakes one batch's shape into the
    file; a JSON column round-trips losslessly instead). Streams in
    `batch_size` record batches — RAM stays O(batch), not O(events)."""
    pa, pq = _pyarrow()
    schema = _parquet_schema()
    events = Storage.get_events()
    n = 0
    with pq.ParquetWriter(output, schema) as writer:
        cols = {c: [] for c in _PARQUET_COLS}

        def flush():
            nonlocal cols
            if cols["event"]:
                writer.write_batch(pa.record_batch(
                    [cols[c] for c in _PARQUET_COLS], schema=schema))
                cols = {c: [] for c in _PARQUET_COLS}

        for e in events.find(app_id=app_id, channel_id=channel_id):
            cols["eventId"].append(e.event_id)
            cols["event"].append(e.event)
            cols["entityType"].append(e.entity_type)
            cols["entityId"].append(e.entity_id)
            cols["targetEntityType"].append(e.target_entity_type)
            cols["targetEntityId"].append(e.target_entity_id)
            cols["properties"].append(
                _json.dumps(e.properties.fields, sort_keys=True))
            cols["eventTime"].append(e.event_time)
            cols["tags"].append(list(e.tags))
            cols["prId"].append(e.pr_id)
            cols["creationTime"].append(e.creation_time)
            n += 1
            if n % batch_size == 0:
                flush()
        flush()
    return n


def parquet_events(input_path: str, validate: bool = True):
    """Yield Events from a parquet file written by
    `export_events_parquet` (or any file matching its schema), one
    record batch at a time. Rows get the SAME scrutiny the JSON import
    path applies — required fields present, EventValidation rules —
    because foreign files are explicitly invited."""
    _, pq = _pyarrow()
    from predictionio_tpu_torch.data.datamap import DataMap
    from predictionio_tpu_torch.data.event import utcnow

    pf = pq.ParquetFile(input_path)
    for batch in pf.iter_batches():
        for row in batch.to_pylist():
            for req in ("event", "entityType", "entityId"):
                if not row.get(req):
                    raise ValueError(
                        f"parquet event missing required field "
                        f"{req!r}: {row!r}")
            props = _json.loads(row.get("properties") or "{}")
            if not isinstance(props, dict):
                raise ValueError(
                    "parquet event field 'properties' must be a JSON "
                    f"object, got {row.get('properties')!r}")
            e = Event(
                event=row["event"], entity_type=row["entityType"],
                entity_id=row["entityId"],
                target_entity_type=row.get("targetEntityType"),
                target_entity_id=row.get("targetEntityId"),
                properties=DataMap(props),
                event_time=row.get("eventTime") or utcnow(),
                tags=row.get("tags") or (),
                pr_id=row.get("prId"),
                creation_time=row.get("creationTime") or utcnow(),
                event_id=row.get("eventId"))
            if validate:
                EventValidation.validate(e)
            yield e


def _insert_batched(event_iter, app_id: int,
                    channel_id: Optional[int], batch_size: int) -> int:
    """Chunked insert_batch over an event iterator; returns the count."""
    events = Storage.get_events()
    batch = []
    n = 0
    for e in event_iter:
        batch.append(e)
        if len(batch) >= batch_size:
            events.insert_batch(batch, app_id, channel_id)
            n += len(batch)
            batch = []
    if batch:
        events.insert_batch(batch, app_id, channel_id)
        n += len(batch)
    return n


def _movielens_lines(path: str):
    """Resolve `path` to (iterator of text lines, format) for a real
    MovieLens dataset. Accepts the ML-100K `u.data` TSV, the
    ML-20M/ml-latest `ratings.csv`, a directory containing either, or
    the published .zip archive of either — local files only, no network
    assumption. Format is "tsv" (user\\titem\\trating\\tts) or "csv"
    (userId,movieId,rating,timestamp header)."""
    import io
    import os
    import zipfile

    def fmt_of(name: str) -> str:
        return "tsv" if os.path.basename(name) == "u.data" else "csv"

    if path.endswith(".zip"):
        zf = zipfile.ZipFile(path)
        try:
            members = [n for n in zf.namelist()
                       if os.path.basename(n) in ("ratings.csv", "u.data")]
            if not members:
                raise ValueError(
                    f"{path}: no ratings.csv or u.data in the archive")
            member = members[0]
            wrapper = io.TextIOWrapper(zf.open(member), "utf-8")
        except Exception:
            zf.close()
            raise
        # the archive handle must live as long as the member stream and
        # close WITH it (not at GC's leisure)
        orig_close = wrapper.close

        def close_both():
            orig_close()
            zf.close()
        wrapper.close = close_both
        return wrapper, fmt_of(member)
    if os.path.isdir(path):
        for name in ("ratings.csv", "u.data"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                return open(cand, encoding="utf-8"), fmt_of(cand)
        raise ValueError(f"{path}: no ratings.csv or u.data in directory")
    return open(path, encoding="utf-8"), fmt_of(path)


def movielens_events(path: str):
    """Yield `rate` events from a real MovieLens dataset, in the exact
    shape the recommendation template's quickstart ingests — so the day
    real data is on disk, `pio import --format movielens` + `pio train`
    produce RMSE curves comparable to published ALS results with no new
    code. (reference DataSource contract the events feed:
    examples/scala-parallel-recommendation/custom-prepartor/src/main/
    scala/DataSource.scala:20-46)"""
    import datetime as dt

    from predictionio_tpu_torch.data.datamap import DataMap

    f, fmt = _movielens_lines(path)
    with f:
        if fmt == "csv":
            header = f.readline().strip().lower()
            if not header.startswith("userid,movieid,rating"):
                raise ValueError(
                    f"{path}: expected a userId,movieId,rating,timestamp "
                    f"header, got {header[:60]!r}")
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split("\t" if fmt == "tsv" else ",")
            uid, mid, rating, ts = parts[0], parts[1], float(parts[2]), \
                int(parts[3])
            yield Event(
                event="rate", entity_type="user", entity_id=uid,
                target_entity_type="item", target_entity_id=mid,
                properties=DataMap({"rating": rating}),
                event_time=dt.datetime.fromtimestamp(
                    ts, tz=dt.timezone.utc))


def import_movielens(app_id: int, input_path: str,
                     channel_id: Optional[int] = None,
                     batch_size: int = 10000) -> int:
    return _insert_batched(movielens_events(input_path), app_id,
                           channel_id, batch_size)


def import_events_parquet(app_id: int, input_path: str,
                          channel_id: Optional[int] = None,
                          batch_size: int = 10000) -> int:
    return _insert_batched(parquet_events(input_path), app_id,
                           channel_id, batch_size)


def import_events(app_id: int, input_path: str,
                  channel_id: Optional[int] = None,
                  batch_size: int = 10000, validate: bool = True) -> int:
    def parsed():
        with open(input_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                e = Event.from_json(line)
                if validate:
                    EventValidation.validate(e)
                yield e

    return _insert_batched(parsed(), app_id, channel_id, batch_size)


def trim_events(src_app_id: int, dst_app_id: int,
                start_time=None, until_time=None,
                src_channel_id: Optional[int] = None,
                dst_channel_id: Optional[int] = None,
                batch_size: int = 10000) -> int:
    """Copy the [start_time, until_time) window of a source app's events
    into an EMPTY destination app — the trim workflow (keep only a recent
    window under a fresh app id). Both apps must be registered; the
    destination must be empty in EVERY channel, as the reference requires
    (reference: examples/experimental/scala-parallel-trim-app/src/main/
    scala/DataSource.scala:44-47)."""
    apps = Storage.get_meta_data_apps()
    for label, aid in (("source", src_app_id), ("destination", dst_app_id)):
        if apps.get(aid) is None:
            raise ValueError(f"{label} app {aid} does not exist; create "
                             f"it with `pio app new` first")
    events = Storage.get_events()
    dst_channels = [None] + [
        c.id for c in Storage.get_meta_data_channels()
        .get_by_app_id(dst_app_id)]
    for ch in dst_channels:
        if next(iter(events.find(app_id=dst_app_id, channel_id=ch,
                                 limit=1)), None):
            where = "default channel" if ch is None else f"channel {ch}"
            raise ValueError(
                f"destination app {dst_app_id} is not empty ({where}); "
                f"trim writes only into a fresh app")
    events.init(dst_app_id, dst_channel_id)
    return _insert_batched(
        events.find(app_id=src_app_id, channel_id=src_channel_id,
                    start_time=start_time, until_time=until_time),
        dst_app_id, dst_channel_id, batch_size)
