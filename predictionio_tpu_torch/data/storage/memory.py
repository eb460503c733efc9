"""In-memory storage backend: the test double of every DAO interface.

The port's copy of `predictionio_tpu/data/storage/memory.py`. It plays the
role the reference's hand-written fakes play in its test suite, and serves
ephemeral single-process runs (`PIO_STORAGE_SOURCES_<S>_TYPE=memory`).
The events DAO keeps per-entity and per-target indexes, so the
entity-filtered read (`find_columnar_by_entities`) reads only the touched
histories. Engine manifests are not stored yet: the port's
`data/storage/base.py` has no `EngineManifests`, so asking for them
raises `StorageError`.
"""

from __future__ import annotations

import itertools
import secrets
import threading
from typing import Dict, List, Optional, Tuple

from predictionio_tpu_torch.data.event import Event, new_event_id
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (AccessKey, App,
                                                      Channel,
                                                      EngineInstance,
                                                      EvaluationInstance,
                                                      Model)
from predictionio_tpu_torch.data.storage.registry import StorageError


class StorageClient:
    def __init__(self, config):
        self.config = config
        self._lock = threading.RLock()
        self._objects: Dict[str, object] = {}

    def get_data_object(self, kind: str, namespace: str):
        key = f"{namespace}/{kind}"
        with self._lock:
            if key not in self._objects:
                ctor = {
                    "apps": MemApps,
                    "access_keys": MemAccessKeys,
                    "channels": MemChannels,
                    "engine_instances": MemEngineInstances,
                    "evaluation_instances": MemEvaluationInstances,
                    "models": MemModels,
                    "events": MemEvents,
                }.get(kind)
                if ctor is None:
                    raise StorageError(
                        f"the memory backend does not store {kind!r} in "
                        "this package yet")
                self._objects[key] = ctor()
            return self._objects[key]

    def close(self):
        self._objects.clear()


class MemApps(base.Apps):
    def __init__(self):
        self._d: Dict[int, App] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, app: App) -> Optional[int]:
        with self._lock:
            app_id = app.id if app.id != 0 else next(self._seq)
            if app_id in self._d or self.get_by_name(app.name):
                return None
            self._d[app_id] = App(app_id, app.name, app.description)
            return app_id

    def get(self, app_id: int) -> Optional[App]:
        return self._d.get(app_id)

    def get_by_name(self, name: str) -> Optional[App]:
        return next((a for a in self._d.values() if a.name == name), None)

    def get_all(self) -> List[App]:
        return sorted(self._d.values(), key=lambda a: a.id)

    def update(self, app: App) -> bool:
        with self._lock:
            if app.id not in self._d:
                return False
            self._d[app.id] = app
            return True

    def delete(self, app_id: int) -> bool:
        with self._lock:
            return self._d.pop(app_id, None) is not None


class MemAccessKeys(base.AccessKeys):
    def __init__(self):
        self._d: Dict[str, AccessKey] = {}
        self._lock = threading.RLock()

    def insert(self, k: AccessKey) -> Optional[str]:
        with self._lock:
            key = k.key or secrets.token_urlsafe(48)
            if key in self._d:
                return None
            self._d[key] = AccessKey(key, k.appid, tuple(k.events))
            return key

    def get(self, key: str) -> Optional[AccessKey]:
        return self._d.get(key)

    def get_all(self) -> List[AccessKey]:
        return list(self._d.values())

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [k for k in self._d.values() if k.appid == app_id]

    def update(self, k: AccessKey) -> bool:
        with self._lock:
            if k.key not in self._d:
                return False
            self._d[k.key] = k
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._d.pop(key, None) is not None


class MemChannels(base.Channels):
    def __init__(self):
        self._d: Dict[int, Channel] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, channel: Channel) -> Optional[int]:
        with self._lock:
            cid = channel.id if channel.id != 0 else next(self._seq)
            if cid in self._d:
                return None
            if any(c.appid == channel.appid and c.name == channel.name
                   for c in self._d.values()):
                return None
            self._d[cid] = Channel(cid, channel.name, channel.appid)
            return cid

    def get(self, channel_id: int) -> Optional[Channel]:
        return self._d.get(channel_id)

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [c for c in self._d.values() if c.appid == app_id]

    def delete(self, channel_id: int) -> bool:
        with self._lock:
            return self._d.pop(channel_id, None) is not None


class MemEngineInstances(base.EngineInstances):
    def __init__(self):
        self._d: Dict[str, EngineInstance] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, i: EngineInstance) -> str:
        with self._lock:
            iid = i.id or str(next(self._seq))
            self._d[iid] = i.with_(id=iid)
            return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        return self._d.get(instance_id)

    def get_all(self) -> List[EngineInstance]:
        return list(self._d.values())

    def get_completed(self, engine_id, engine_version, engine_variant):
        out = [i for i in self._d.values()
               if i.status == "COMPLETED" and i.engine_id == engine_id
               and i.engine_version == engine_version
               and i.engine_variant == engine_variant]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, i: EngineInstance) -> bool:
        with self._lock:
            if i.id not in self._d:
                return False
            self._d[i.id] = i
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._d.pop(instance_id, None) is not None


class MemEvaluationInstances(base.EvaluationInstances):
    def __init__(self):
        self._d: Dict[str, EvaluationInstance] = {}
        self._seq = itertools.count(1)
        self._lock = threading.RLock()

    def insert(self, i: EvaluationInstance) -> str:
        with self._lock:
            iid = i.id or str(next(self._seq))
            self._d[iid] = i.with_(id=iid)
            return iid

    def get(self, instance_id: str) -> Optional[EvaluationInstance]:
        return self._d.get(instance_id)

    def get_all(self) -> List[EvaluationInstance]:
        return list(self._d.values())

    def get_completed(self) -> List[EvaluationInstance]:
        out = [i for i in self._d.values() if i.status == "EVALCOMPLETED"]
        return sorted(out, key=lambda i: i.start_time, reverse=True)

    def update(self, i: EvaluationInstance) -> bool:
        with self._lock:
            if i.id not in self._d:
                return False
            self._d[i.id] = i
            return True

    def delete(self, instance_id: str) -> bool:
        with self._lock:
            return self._d.pop(instance_id, None) is not None


class MemModels(base.Models):
    def __init__(self):
        self._d: Dict[str, Model] = {}
        self._lock = threading.RLock()

    def insert(self, model: Model) -> None:
        with self._lock:
            self._d[model.id] = model

    def get(self, model_id: str) -> Optional[Model]:
        return self._d.get(model_id)

    def delete(self, model_id: str) -> bool:
        with self._lock:
            return self._d.pop(model_id, None) is not None


class MemEvents(base.Events):
    def __init__(self):
        # (app_id, channel_id) -> {event_id: Event}
        self._ns: Dict[Tuple[int, Optional[int]], Dict[str, Event]] = {}
        # entity-filtered-read indexes, maintained on every mutation:
        # (app, channel) -> {entity_id -> {event_id}} / {target -> {ids}}
        self._by_entity: Dict[Tuple[int, Optional[int]],
                              Dict[str, set]] = {}
        self._by_target: Dict[Tuple[int, Optional[int]],
                              Dict[str, set]] = {}
        self._lock = threading.RLock()

    def _table(self, app_id, channel_id, create=False):
        key = (app_id, channel_id)
        with self._lock:
            if key not in self._ns and create:
                self._ns[key] = {}
                self._by_entity[key] = {}
                self._by_target[key] = {}
            return self._ns.get(key)

    def init(self, app_id, channel_id=None) -> bool:
        self._table(app_id, channel_id, create=True)
        return True

    def remove(self, app_id, channel_id=None) -> bool:
        with self._lock:
            key = (app_id, channel_id)
            self._by_entity.pop(key, None)
            self._by_target.pop(key, None)
            return self._ns.pop(key, None) is not None

    def _unindex(self, key, eid, old: Event):
        for index, k in ((self._by_entity, old.entity_id),
                         (self._by_target, old.target_entity_id)):
            if k:
                ids = index[key].get(k)
                if ids is not None:
                    ids.discard(eid)
                    if not ids:
                        del index[key][k]

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        table = self._table(app_id, channel_id, create=True)
        eid = event.event_id or new_event_id()
        key = (app_id, channel_id)
        with self._lock:
            old = table.get(eid)
            if old is not None:        # overwrite-by-id re-routes indexes
                self._unindex(key, eid, old)
            table[eid] = event.with_id(eid)
            if event.entity_id:
                self._by_entity[key].setdefault(
                    event.entity_id, set()).add(eid)
            if event.target_entity_id:
                self._by_target[key].setdefault(
                    event.target_entity_id, set()).add(eid)
        return eid

    def insert_batch(self, events, app_id, channel_id=None):
        """One lock acquisition for the whole batch (the base default
        re-enters `insert`, and so the lock, per event)."""
        table = self._table(app_id, channel_id, create=True)
        key = (app_id, channel_id)
        eids = []
        with self._lock:
            by_ent, by_tgt = self._by_entity[key], self._by_target[key]
            for event in events:
                eid = event.event_id or new_event_id()
                eids.append(eid)
                old = table.get(eid)
                if old is not None:
                    self._unindex(key, eid, old)
                table[eid] = event.with_id(eid)
                if event.entity_id:
                    by_ent.setdefault(event.entity_id, set()).add(eid)
                if event.target_entity_id:
                    by_tgt.setdefault(event.target_entity_id,
                                      set()).add(eid)
        return eids

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        table = self._table(app_id, channel_id)
        return table.get(event_id) if table else None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        table = self._table(app_id, channel_id)
        if table is None:
            return False
        with self._lock:
            old = table.pop(event_id, None)
            if old is not None:
                self._unindex((app_id, channel_id), event_id, old)
            return old is not None

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None, limit=None,
             reversed_order=False):
        table = self._table(app_id, channel_id)
        events = list(table.values()) if table else []
        out = [e for e in events if base.match_event(
            e, start_time, until_time, entity_type, entity_id, event_names,
            target_entity_type, target_entity_id)]
        out.sort(key=lambda e: e.event_time, reverse=reversed_order)
        if limit is not None and limit >= 0:
            out = out[:limit]
        return iter(out)

    def find_columnar_by_entities(self, app_id, channel_id=None,
                                  entity_ids=None, target_entity_ids=None,
                                  property_field=None, start_time=None,
                                  until_time=None, entity_type=None,
                                  target_entity_type=None, event_names=None,
                                  limit=None):
        """Index pushdown: candidate event ids come from the per-entity
        index union — O(touched histories), never a table scan."""
        key = (app_id, channel_id)
        with self._lock:
            table = self._ns.get(key)
            if table is None:
                return base.events_to_columnar([], property_field)
            candidates: set = set()
            for iid in (entity_ids or ()):
                candidates |= self._by_entity[key].get(str(iid), set())
            for iid in (target_entity_ids or ()):
                candidates |= self._by_target[key].get(str(iid), set())
            events = [table[eid] for eid in candidates if eid in table]
        events = [e for e in events if base.match_event(
            e, start_time, until_time, entity_type, None, event_names,
            target_entity_type, None)]
        events.sort(key=lambda e: e.event_time)
        if limit is not None and limit >= 0:
            events = events[:limit]
        return base.events_to_columnar(events, property_field)
