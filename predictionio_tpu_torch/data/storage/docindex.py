"""Embedded document-index metadata backend — the Elasticsearch role.

The port's copy of `predictionio_tpu/data/storage/docindex.py`. The log's
bytes are the reference's (one compact JSON op a line), so an index
either package wrote is read by the other.

The reference's third metadata-backend family stores each metadata record
as a JSON document in an index and answers term-filtered, sorted queries
(reference: data/src/main/scala/io/prediction/data/storage/elasticsearch/
StorageClient.scala:47 and the ES* DAOs beside it, e.g.
ESEngineInstances.scala's filtered status/engineId/engineVersion query).
No cluster exists in this environment, so this backend IS the document
index rather than a client to one: JSON documents in per-index
append-only operation logs (crash recovery = replay; compaction =
atomic rewrite) with an in-memory INVERTED INDEX over top-level scalar
fields answering the same term-intersection queries ES answers for the
reference — a genuinely different storage paradigm from the SQL family,
not another dialect.

Like the sqlite default, this is a single-process embedded store (the
registry caches one client per source; cross-process sharing is what the
SQL/wire backends are for).

Source config:
  PIO_STORAGE_SOURCES_<S>_TYPE=docindex
  PIO_STORAGE_SOURCES_<S>_PATH=/var/pio/docindex   (default under
                                                    PIO_FS_BASEDIR)
  PIO_STORAGE_SOURCES_<S>_FSYNC=true|false          (default true)

Events and models are out of this backend's role (the reference runs
events on HBase and models on HDFS/localfs next to an ES metadata
store); asking for them raises a clear StorageError.
"""

from __future__ import annotations

import datetime as _dt
import json
import os
import secrets
import threading
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (AccessKey, App, Channel,
                                                      EngineInstance,
                                                      EngineManifest,
                                                      EvaluationInstance)


class DocIndex:
    """One named index: {_id -> JSON document} persisted as an
    append-only op log, with posting lists over every top-level scalar
    field for term queries.

    Write path: append one JSON line ({"op","id","doc"}) + optional
    fsync, update the in-memory doc map and posting lists. Read path:
    pure memory. Recovery: replay the log (last op wins). Compaction:
    when dead ops outnumber live docs 4:1 (min 1024), atomically rewrite
    the log as one put per live doc."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._lock = threading.RLock()
        self._docs: Dict[str, dict] = {}
        self._inv: Dict[str, Dict[Any, Set[str]]] = {}
        self._dead_ops = 0
        # highest integer id ever PUT (survives deletes via replay):
        # next_int_id must not reuse a deleted id — references to it may
        # outlive the record, the same reason SQL autoincrement doesn't
        self._max_int_id = 0
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._replay()
        self._f = open(self.path, "ab")

    # -- persistence --------------------------------------------------------
    def _replay(self):
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    op = json.loads(line)
                except ValueError:
                    # torn tail from a crash mid-append: ignore the
                    # partial record (every complete record is one line)
                    continue
                if op.get("op") == "put":
                    self._index(op["id"], op["doc"])
                elif op.get("op") == "del":
                    self._unindex(op["id"])

    def _append(self, op: dict):
        data = json.dumps(op, separators=(",", ":")).encode() + b"\n"
        self._f.write(data)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def _maybe_compact(self):
        if self._dead_ops < max(1024, 4 * len(self._docs)):
            return
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            for _id, doc in self._docs.items():
                f.write(json.dumps({"op": "put", "id": _id, "doc": doc},
                                   separators=(",", ":")).encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._dead_ops = 0

    # -- in-memory index ----------------------------------------------------
    @staticmethod
    def _term_key(v):
        """Posting-list key for a scalar value. bool is an int subclass
        with hash(True) == hash(1), so untagged keys would cross-match
        True and 1; ints and floats deliberately share numeric equality
        (JSON doesn't distinguish 1 from 1.0)."""
        return ("bool", v) if isinstance(v, bool) else v

    @staticmethod
    def _indexable(v) -> bool:
        return isinstance(v, (str, int, float, bool)) or v is None

    @classmethod
    def _terms(cls, doc: dict) -> Iterable[Tuple[str, Any]]:
        for k, v in doc.items():
            if cls._indexable(v):
                yield k, cls._term_key(v)

    def _index(self, _id: str, doc: dict):
        if _id in self._docs:
            self._unindex(_id)   # counts the overwritten put as dead
        if _id.isdigit():
            self._max_int_id = max(self._max_int_id, int(_id))
        self._docs[_id] = doc
        for field, value in self._terms(doc):
            self._inv.setdefault(field, {}).setdefault(value,
                                                       set()).add(_id)

    def _unindex(self, _id: str):
        doc = self._docs.pop(_id, None)
        if doc is None:
            return False
        for field, value in self._terms(doc):
            postings = self._inv.get(field, {})
            ids = postings.get(value)
            if ids:
                ids.discard(_id)
                if not ids:
                    del postings[value]
        self._dead_ops += 1
        return True

    # -- public API ---------------------------------------------------------
    def put(self, _id: str, doc: dict):
        with self._lock:
            self._index(_id, doc)
            self._append({"op": "put", "id": _id, "doc": doc})
            self._maybe_compact()

    def get(self, _id: str) -> Optional[dict]:
        with self._lock:
            return self._docs.get(_id)

    def delete(self, _id: str) -> bool:
        with self._lock:
            if not self._unindex(_id):
                return False
            self._append({"op": "del", "id": _id})
            # the del record itself won't survive compaction either
            self._dead_ops += 1
            self._maybe_compact()
            return True

    def search(self, eq: Optional[Dict[str, Any]] = None,
               sort: Optional[str] = None, reverse: bool = False,
               limit: Optional[int] = None) -> List[dict]:
        """Term-intersection query (the ES bool/term filter shape):
        AND of {field: value} equalities via posting-list intersection,
        optional sort on a field, optional limit."""
        with self._lock:
            if eq:
                ids: Optional[Set[str]] = None
                for field, value in eq.items():
                    if self._indexable(value):
                        postings = self._inv.get(field, {}).get(
                            self._term_key(value), set())
                    else:
                        # non-scalar filter value (list/dict): the index
                        # can't hold it — scan so eq stays correct
                        # instead of silently empty
                        postings = {i for i, d in self._docs.items()
                                    if d.get(field) == value}
                    ids = (set(postings) if ids is None
                           else ids & postings)
                    if not ids:
                        return []
                docs = [self._docs[i] for i in ids]
            else:
                docs = list(self._docs.values())
        if sort is not None:
            # docs missing the sort field go LAST regardless of
            # direction (folding None into the key inverts the bucket
            # under reverse=True); the tagged key keeps mixed-type
            # values comparable (numbers first, then str-rendered)
            def sort_key(d):
                v = d[sort]
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    return (0, v, "")
                return (1, 0.0, str(v))
            present = [d for d in docs if d.get(sort) is not None]
            missing = [d for d in docs if d.get(sort) is None]
            present.sort(key=sort_key, reverse=reverse)
            docs = present + missing
        if limit is not None and limit >= 0:
            docs = docs[:limit]
        return docs

    def count(self) -> int:
        with self._lock:
            return len(self._docs)

    def next_int_id(self) -> int:
        with self._lock:
            return self._max_int_id + 1

    def close(self):
        with self._lock:
            self._f.close()


class StorageClient:
    def __init__(self, config):
        self.config = config
        from predictionio_tpu_torch.data.storage.registry import base_dir
        self.root = config.get("PATH", os.path.join(base_dir(), "docindex"))
        self.fsync = (config.get("FSYNC", "true").lower() != "false")
        self._lock = threading.RLock()
        self._objects: Dict[str, object] = {}

    def _open_index(self, namespace: str, kind: str) -> DocIndex:
        return DocIndex(os.path.join(self.root, namespace, kind + ".log"),
                        fsync=self.fsync)

    def get_data_object(self, kind: str, namespace: str):
        from predictionio_tpu_torch.data.storage.registry import StorageError
        ctors = {
            "apps": DocApps,
            "access_keys": DocAccessKeys,
            "channels": DocChannels,
            "engine_instances": DocEngineInstances,
            "engine_manifests": DocEngineManifests,
            "evaluation_instances": DocEvaluationInstances,
        }
        if kind not in ctors:
            raise StorageError(
                f"docindex is a metadata backend (the Elasticsearch "
                f"role); '{kind}' belongs in an event/model store — "
                f"point that repository at sqlite/nativelog/localfs/... "
                f"instead")
        key = f"{namespace}/{kind}"
        with self._lock:
            if key not in self._objects:
                self._objects[key] = ctors[kind](
                    self._open_index(namespace, kind))
            return self._objects[key]

    def close(self):
        with self._lock:
            for obj in self._objects.values():
                obj.ix.close()
            self._objects.clear()


def _dt_to_s(t: _dt.datetime) -> str:
    return t.isoformat()


def _s_to_dt(s: str) -> _dt.datetime:
    return _dt.datetime.fromisoformat(s)


class DocApps(base.Apps):
    def __init__(self, ix: DocIndex):
        self.ix = ix

    def insert(self, app: App) -> Optional[int]:
        with self.ix._lock:
            app_id = app.id if app.id != 0 else self.ix.next_int_id()
            if self.ix.get(str(app_id)) or self.get_by_name(app.name):
                return None
            self.ix.put(str(app_id), {"id": app_id, "name": app.name,
                                      "description": app.description})
            return app_id

    @staticmethod
    def _of(d: dict) -> App:
        return App(d["id"], d["name"], d.get("description"))

    def get(self, app_id: int) -> Optional[App]:
        d = self.ix.get(str(app_id))
        return self._of(d) if d else None

    def get_by_name(self, name: str) -> Optional[App]:
        hits = self.ix.search(eq={"name": name}, limit=1)
        return self._of(hits[0]) if hits else None

    def get_all(self) -> List[App]:
        return [self._of(d) for d in self.ix.search(sort="id")]

    def update(self, app: App) -> bool:
        with self.ix._lock:
            if self.ix.get(str(app.id)) is None:
                return False
            self.ix.put(str(app.id), {"id": app.id, "name": app.name,
                                      "description": app.description})
            return True

    def delete(self, app_id: int) -> bool:
        return self.ix.delete(str(app_id))


class DocAccessKeys(base.AccessKeys):
    def __init__(self, ix: DocIndex):
        self.ix = ix

    def insert(self, k: AccessKey) -> Optional[str]:
        with self.ix._lock:
            key = k.key or secrets.token_urlsafe(48)
            if self.ix.get(key) is not None:
                return None
            self.ix.put(key, {"key": key, "appid": k.appid,
                              "events": list(k.events)})
            return key

    @staticmethod
    def _of(d: dict) -> AccessKey:
        return AccessKey(d["key"], d["appid"], tuple(d.get("events", ())))

    def get(self, key: str) -> Optional[AccessKey]:
        d = self.ix.get(key)
        return self._of(d) if d else None

    def get_all(self) -> List[AccessKey]:
        return [self._of(d) for d in self.ix.search()]

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [self._of(d) for d in self.ix.search(eq={"appid": app_id})]

    def update(self, k: AccessKey) -> bool:
        with self.ix._lock:
            if self.ix.get(k.key) is None:
                return False
            self.ix.put(k.key, {"key": k.key, "appid": k.appid,
                                "events": list(k.events)})
            return True

    def delete(self, key: str) -> bool:
        return self.ix.delete(key)


class DocChannels(base.Channels):
    def __init__(self, ix: DocIndex):
        self.ix = ix

    def insert(self, channel: Channel) -> Optional[int]:
        with self.ix._lock:
            cid = channel.id if channel.id != 0 else self.ix.next_int_id()
            if self.ix.get(str(cid)) is not None:
                return None
            dup = self.ix.search(eq={"appid": channel.appid,
                                     "name": channel.name}, limit=1)
            if dup:
                return None
            self.ix.put(str(cid), {"id": cid, "name": channel.name,
                                   "appid": channel.appid})
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        d = self.ix.get(str(channel_id))
        return Channel(d["id"], d["name"], d["appid"]) if d else None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [Channel(d["id"], d["name"], d["appid"])
                for d in self.ix.search(eq={"appid": app_id}, sort="id")]

    def delete(self, channel_id: int) -> bool:
        return self.ix.delete(str(channel_id))


class DocEngineInstances(base.EngineInstances):
    def __init__(self, ix: DocIndex):
        self.ix = ix

    @staticmethod
    def _doc(i: EngineInstance) -> dict:
        return {
            "id": i.id, "status": i.status,
            "startTime": _dt_to_s(i.start_time),
            "endTime": _dt_to_s(i.end_time),
            "engineId": i.engine_id, "engineVersion": i.engine_version,
            "engineVariant": i.engine_variant,
            "engineFactory": i.engine_factory, "batch": i.batch,
            "env": dict(i.env), "sparkConf": dict(i.spark_conf),
            "dataSourceParams": i.data_source_params,
            "preparatorParams": i.preparator_params,
            "algorithmsParams": i.algorithms_params,
            "servingParams": i.serving_params,
        }

    @staticmethod
    def _of(d: dict) -> EngineInstance:
        return EngineInstance(
            id=d["id"], status=d["status"],
            start_time=_s_to_dt(d["startTime"]),
            end_time=_s_to_dt(d["endTime"]),
            engine_id=d["engineId"], engine_version=d["engineVersion"],
            engine_variant=d["engineVariant"],
            engine_factory=d["engineFactory"], batch=d.get("batch", ""),
            env=d.get("env", {}), spark_conf=d.get("sparkConf", {}),
            data_source_params=d.get("dataSourceParams", ""),
            preparator_params=d.get("preparatorParams", ""),
            algorithms_params=d.get("algorithmsParams", ""),
            serving_params=d.get("servingParams", ""))

    def insert(self, i: EngineInstance) -> str:
        with self.ix._lock:
            iid = i.id or secrets.token_hex(8)
            self.ix.put(iid, self._doc(i.with_(id=iid)))
            return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        d = self.ix.get(instance_id)
        return self._of(d) if d else None

    def get_all(self) -> List[EngineInstance]:
        return [self._of(d) for d in self.ix.search()]

    def get_completed(self, engine_id, engine_version, engine_variant):
        # the ESEngineInstances filtered query: status+engine coordinates
        # term-intersected on the inverted index, sorted by startTime desc
        hits = self.ix.search(
            eq={"status": "COMPLETED", "engineId": engine_id,
                "engineVersion": engine_version,
                "engineVariant": engine_variant},
            sort="startTime", reverse=True)
        return [self._of(d) for d in hits]

    def get_latest_completed(self, engine_id, engine_version,
                             engine_variant):
        done = self.get_completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def update(self, i: EngineInstance) -> bool:
        with self.ix._lock:
            if self.ix.get(i.id) is None:
                return False
            self.ix.put(i.id, self._doc(i))
            return True

    def delete(self, instance_id: str) -> bool:
        return self.ix.delete(instance_id)


class DocEngineManifests(base.EngineManifests):
    def __init__(self, ix: DocIndex):
        self.ix = ix

    @staticmethod
    def _key(manifest_id: str, version: str) -> str:
        return f"{manifest_id} {version}"

    @staticmethod
    def _of(d: dict) -> EngineManifest:
        return EngineManifest(d["id"], d["version"], d["name"],
                              d.get("description"),
                              tuple(d.get("files", ())),
                              d.get("engineFactory", ""))

    def insert(self, m: EngineManifest) -> None:
        self.ix.put(self._key(m.id, m.version), {
            "id": m.id, "version": m.version, "name": m.name,
            "description": m.description, "files": list(m.files),
            "engineFactory": m.engine_factory})

    def get(self, manifest_id: str, version: str):
        d = self.ix.get(self._key(manifest_id, version))
        return self._of(d) if d else None

    def get_all(self) -> List[EngineManifest]:
        return [self._of(d) for d in self.ix.search()]

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        with self.ix._lock:
            if upsert or self.ix.get(self._key(m.id, m.version)):
                self.insert(m)

    def delete(self, manifest_id: str, version: str) -> bool:
        return self.ix.delete(self._key(manifest_id, version))


class DocEvaluationInstances(base.EvaluationInstances):
    def __init__(self, ix: DocIndex):
        self.ix = ix

    @staticmethod
    def _doc(i: EvaluationInstance) -> dict:
        return {
            "id": i.id, "status": i.status,
            "startTime": _dt_to_s(i.start_time),
            "endTime": _dt_to_s(i.end_time),
            "evaluationClass": i.evaluation_class,
            "engineParamsGeneratorClass": i.engine_params_generator_class,
            "batch": i.batch, "env": dict(i.env),
            "sparkConf": dict(i.spark_conf),
            "evaluatorResults": i.evaluator_results,
            "evaluatorResultsHTML": i.evaluator_results_html,
            "evaluatorResultsJSON": i.evaluator_results_json,
        }

    @staticmethod
    def _of(d: dict) -> EvaluationInstance:
        return EvaluationInstance(
            id=d["id"], status=d["status"],
            start_time=_s_to_dt(d["startTime"]),
            end_time=_s_to_dt(d["endTime"]),
            evaluation_class=d.get("evaluationClass", ""),
            engine_params_generator_class=d.get(
                "engineParamsGeneratorClass", ""),
            batch=d.get("batch", ""), env=d.get("env", {}),
            spark_conf=d.get("sparkConf", {}),
            evaluator_results=d.get("evaluatorResults", ""),
            evaluator_results_html=d.get("evaluatorResultsHTML", ""),
            evaluator_results_json=d.get("evaluatorResultsJSON", ""))

    def insert(self, i: EvaluationInstance) -> str:
        with self.ix._lock:
            iid = i.id or secrets.token_hex(8)
            self.ix.put(iid, self._doc(i.with_(id=iid)))
            return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        d = self.ix.get(instance_id)
        return self._of(d) if d else None

    def get_all(self) -> List[EvaluationInstance]:
        return [self._of(d) for d in self.ix.search()]

    def get_completed(self) -> List[EvaluationInstance]:
        hits = self.ix.search(eq={"status": "EVALCOMPLETED"},
                              sort="startTime", reverse=True)
        return [self._of(d) for d in hits]

    def update(self, i: EvaluationInstance) -> bool:
        with self.ix._lock:
            if self.ix.get(i.id) is None:
                return False
            self.ix.put(i.id, self._doc(i))
            return True

    def delete(self, instance_id: str) -> bool:
        return self.ix.delete(instance_id)
