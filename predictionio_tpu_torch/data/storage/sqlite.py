"""Embedded SQL storage backend (SQLite): the operator default store.

The port's copy of `predictionio_tpu/data/storage/sqlite.py`: apps,
access keys, channels, engine instances, engine manifests, evaluation
instances, model blobs and events, in one embedded database. The schema is the
reference's, table for table, so a store written by either package reads
back through the other. Tables are created on first access.

Events are stored row-per-event with (app_id, channel_id) columns and
covering indexes; find() pushes every filter down to SQL, and the
projected `find_columnar` extracts the property with `json_extract`.
Equal-eventtime rows come back in rowid (insertion) order, which the
preparator's "latest" dedup relies on. Concurrency: WAL mode and one
connection guarded by an RLock.
"""

from __future__ import annotations

import json
import os
import secrets
import sqlite3
import threading
from itertools import repeat
from typing import List, Optional

import numpy as np

from predictionio_tpu_torch.data.datamap import DataMap
from predictionio_tpu_torch.data.event import (Event, from_millis,
                                               new_event_id, new_event_ids,
                                               parse_event_time, to_millis,
                                               utcnow)
from predictionio_tpu_torch.data.storage import base
from predictionio_tpu_torch.data.storage.base import (ABSENT, AccessKey,
                                                      App, Channel,
                                                      EngineInstance,
                                                      EngineManifest,
                                                      EvaluationInstance,
                                                      Model)


class StorageClient:
    def __init__(self, config):
        self.config = config
        url = config.get("URL") or os.path.join(
            os.path.expanduser("~/.pio_store"), "pio.db")
        if url != ":memory:":
            os.makedirs(os.path.dirname(os.path.abspath(url)), exist_ok=True)
        self._conn = sqlite3.connect(url, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self.lock = threading.RLock()
        self._objects = {}

    def execute(self, sql, params=()):
        with self.lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def query(self, sql, params=()):
        with self.lock:
            return self._conn.execute(sql, params).fetchall()

    def get_data_object(self, kind: str, namespace: str):
        key = f"{namespace}/{kind}"
        with self.lock:
            if key not in self._objects:
                ctor = {
                    "apps": SQLApps,
                    "access_keys": SQLAccessKeys,
                    "channels": SQLChannels,
                    "engine_instances": SQLEngineInstances,
                    "engine_manifests": SQLEngineManifests,
                    "evaluation_instances": SQLEvaluationInstances,
                    "models": SQLModels,
                    "events": SQLEvents,
                }.get(kind)
                if ctor is None:
                    raise ValueError(
                        f"the sqlite backend does not store {kind!r} in "
                        "this package yet")
                self._objects[key] = ctor(self, namespace)
            return self._objects[key]

    def close(self):
        with self.lock:
            self._conn.close()
            self._objects.clear()


class SQLApps(base.Apps):
    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_apps"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            name TEXT NOT NULL UNIQUE,
            description TEXT)""")

    def insert(self, app: App) -> Optional[int]:
        try:
            if app.id != 0:
                self.c.execute(
                    f"INSERT INTO {self.t} (id, name, description) VALUES (?,?,?)",
                    (app.id, app.name, app.description))
                return app.id
            cur = self.c.execute(
                f"INSERT INTO {self.t} (name, description) VALUES (?,?)",
                (app.name, app.description))
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def _row(self, r):
        return App(r[0], r[1], r[2]) if r else None

    def get(self, app_id: int) -> Optional[App]:
        rows = self.c.query(f"SELECT id,name,description FROM {self.t} WHERE id=?",
                            (app_id,))
        return self._row(rows[0]) if rows else None

    def get_by_name(self, name: str) -> Optional[App]:
        rows = self.c.query(
            f"SELECT id,name,description FROM {self.t} WHERE name=?", (name,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> List[App]:
        return [self._row(r) for r in
                self.c.query(f"SELECT id,name,description FROM {self.t} ORDER BY id")]

    def update(self, app: App) -> bool:
        cur = self.c.execute(
            f"UPDATE {self.t} SET name=?, description=? WHERE id=?",
            (app.name, app.description, app.id))
        return cur.rowcount > 0

    def delete(self, app_id: int) -> bool:
        return self.c.execute(f"DELETE FROM {self.t} WHERE id=?",
                              (app_id,)).rowcount > 0


class SQLAccessKeys(base.AccessKeys):
    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_accesskeys"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            accesskey TEXT PRIMARY KEY,
            appid INTEGER NOT NULL,
            events TEXT NOT NULL)""")

    def insert(self, k: AccessKey) -> Optional[str]:
        key = k.key or secrets.token_urlsafe(48)
        try:
            self.c.execute(
                f"INSERT INTO {self.t} (accesskey, appid, events) "
                "VALUES (?,?,?)", (key, k.appid, json.dumps(list(k.events))))
            return key
        except sqlite3.IntegrityError:
            return None

    def _row(self, r):
        return AccessKey(r[0], r[1], tuple(json.loads(r[2])))

    def get(self, key: str) -> Optional[AccessKey]:
        rows = self.c.query(
            f"SELECT accesskey,appid,events FROM {self.t} WHERE accesskey=?",
            (key,))
        return self._row(rows[0]) if rows else None

    def get_all(self) -> List[AccessKey]:
        return [self._row(r) for r in
                self.c.query(f"SELECT accesskey,appid,events FROM {self.t}")]

    def get_by_app_id(self, app_id: int) -> List[AccessKey]:
        return [self._row(r) for r in self.c.query(
            f"SELECT accesskey,appid,events FROM {self.t} WHERE appid=?",
            (app_id,))]

    def update(self, k: AccessKey) -> bool:
        cur = self.c.execute(
            f"UPDATE {self.t} SET appid=?, events=? WHERE accesskey=?",
            (k.appid, json.dumps(list(k.events)), k.key))
        return cur.rowcount > 0

    def delete(self, key: str) -> bool:
        return self.c.execute(f"DELETE FROM {self.t} WHERE accesskey=?",
                              (key,)).rowcount > 0


class SQLChannels(base.Channels):
    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_channels"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id INTEGER PRIMARY KEY AUTOINCREMENT,
            name TEXT NOT NULL,
            appid INTEGER NOT NULL,
            UNIQUE (appid, name))""")

    def insert(self, channel: Channel) -> Optional[int]:
        try:
            if channel.id != 0:
                self.c.execute(
                    f"INSERT INTO {self.t} (id,name,appid) VALUES (?,?,?)",
                    (channel.id, channel.name, channel.appid))
                return channel.id
            cur = self.c.execute(
                f"INSERT INTO {self.t} (name,appid) VALUES (?,?)",
                (channel.name, channel.appid))
            return cur.lastrowid
        except sqlite3.IntegrityError:
            return None

    def get(self, channel_id: int) -> Optional[Channel]:
        rows = self.c.query(f"SELECT id,name,appid FROM {self.t} WHERE id=?",
                            (channel_id,))
        return Channel(*rows[0]) if rows else None

    def get_by_app_id(self, app_id: int) -> List[Channel]:
        return [Channel(*r) for r in self.c.query(
            f"SELECT id,name,appid FROM {self.t} WHERE appid=?", (app_id,))]

    def delete(self, channel_id: int) -> bool:
        return self.c.execute(f"DELETE FROM {self.t} WHERE id=?",
                              (channel_id,)).rowcount > 0


class SQLEngineInstances(base.EngineInstances):
    COLS = ("id,status,starttime,endtime,engineid,engineversion,enginevariant,"
            "enginefactory,batch,env,sparkconf,datasourceparams,"
            "preparatorparams,algorithmsparams,servingparams")

    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_engineinstances"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id TEXT PRIMARY KEY, status TEXT, starttime INTEGER,
            endtime INTEGER, engineid TEXT, engineversion TEXT,
            enginevariant TEXT, enginefactory TEXT, batch TEXT,
            env TEXT, sparkconf TEXT, datasourceparams TEXT,
            preparatorparams TEXT, algorithmsparams TEXT, servingparams TEXT)""")

    def _to_row(self, i: EngineInstance):
        return (i.id, i.status, to_millis(i.start_time), to_millis(i.end_time),
                i.engine_id, i.engine_version, i.engine_variant,
                i.engine_factory, i.batch, json.dumps(i.env),
                json.dumps(i.spark_conf), i.data_source_params,
                i.preparator_params, i.algorithms_params, i.serving_params)

    def _from_row(self, r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=from_millis(r[2]),
            end_time=from_millis(r[3]), engine_id=r[4], engine_version=r[5],
            engine_variant=r[6], engine_factory=r[7], batch=r[8],
            env=json.loads(r[9]), spark_conf=json.loads(r[10]),
            data_source_params=r[11], preparator_params=r[12],
            algorithms_params=r[13], serving_params=r[14])

    def insert(self, i: EngineInstance) -> str:
        iid = i.id or new_event_id()
        self.c.execute(
            f"INSERT INTO {self.t} ({self.COLS}) VALUES "
            f"({','.join('?' * 15)})", self._to_row(i.with_(id=iid)))
        return iid

    def get(self, instance_id: str) -> Optional[EngineInstance]:
        rows = self.c.query(
            f"SELECT {self.COLS} FROM {self.t} WHERE id=?", (instance_id,))
        return self._from_row(rows[0]) if rows else None

    def get_all(self) -> List[EngineInstance]:
        return [self._from_row(r)
                for r in self.c.query(f"SELECT {self.COLS} FROM {self.t}")]

    def get_completed(self, engine_id, engine_version, engine_variant):
        rows = self.c.query(
            f"SELECT {self.COLS} FROM {self.t} WHERE status='COMPLETED' AND "
            "engineid=? AND engineversion=? AND enginevariant=? "
            "ORDER BY starttime DESC",
            (engine_id, engine_version, engine_variant))
        return [self._from_row(r) for r in rows]

    def get_latest_completed(self, engine_id, engine_version, engine_variant):
        completed = self.get_completed(engine_id, engine_version, engine_variant)
        return completed[0] if completed else None

    def update(self, i: EngineInstance) -> bool:
        row = self._to_row(i)
        cur = self.c.execute(
            f"UPDATE {self.t} SET status=?, starttime=?, endtime=?, engineid=?, "
            "engineversion=?, enginevariant=?, enginefactory=?, batch=?, env=?, "
            "sparkconf=?, datasourceparams=?, preparatorparams=?, "
            "algorithmsparams=?, servingparams=? WHERE id=?",
            row[1:] + (i.id,))
        return cur.rowcount > 0

    def delete(self, instance_id: str) -> bool:
        return self.c.execute(f"DELETE FROM {self.t} WHERE id=?",
                              (instance_id,)).rowcount > 0


class SQLEngineManifests(base.EngineManifests):
    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_enginemanifests"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id TEXT, version TEXT, name TEXT, description TEXT,
            files TEXT, enginefactory TEXT, PRIMARY KEY (id, version))""")

    def insert(self, m: EngineManifest) -> None:
        self.c.execute(
            f"INSERT OR REPLACE INTO {self.t} VALUES (?,?,?,?,?,?)",
            (m.id, m.version, m.name, m.description,
             json.dumps(list(m.files)), m.engine_factory))

    def _row(self, r):
        return EngineManifest(r[0], r[1], r[2], r[3],
                              tuple(json.loads(r[4])), r[5])

    def get(self, manifest_id, version):
        rows = self.c.query(
            f"SELECT * FROM {self.t} WHERE id=? AND version=?",
            (manifest_id, version))
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [self._row(r) for r in self.c.query(f"SELECT * FROM {self.t}")]

    def update(self, m: EngineManifest, upsert: bool = False) -> None:
        if upsert or self.get(m.id, m.version):
            self.insert(m)

    def delete(self, manifest_id, version) -> bool:
        return self.c.execute(
            f"DELETE FROM {self.t} WHERE id=? AND version=?",
            (manifest_id, version)).rowcount > 0


class SQLEvaluationInstances(base.EvaluationInstances):
    COLS = ("id,status,starttime,endtime,evaluationclass,"
            "engineparamsgeneratorclass,batch,env,sparkconf,"
            "evaluatorresults,evaluatorresultshtml,evaluatorresultsjson")

    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_evaluationinstances"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id TEXT PRIMARY KEY, status TEXT, starttime INTEGER,
            endtime INTEGER, evaluationclass TEXT,
            engineparamsgeneratorclass TEXT, batch TEXT, env TEXT,
            sparkconf TEXT, evaluatorresults TEXT,
            evaluatorresultshtml TEXT, evaluatorresultsjson TEXT)""")

    def insert(self, i: EvaluationInstance) -> str:
        iid = i.id or new_event_id()
        i = i.with_(id=iid)
        self.c.execute(
            f"INSERT INTO {self.t} ({self.COLS}) VALUES "
            f"({','.join('?' * 12)})",
            (i.id, i.status, to_millis(i.start_time), to_millis(i.end_time),
             i.evaluation_class, i.engine_params_generator_class, i.batch,
             json.dumps(i.env), json.dumps(i.spark_conf), i.evaluator_results,
             i.evaluator_results_html, i.evaluator_results_json))
        return iid

    def _row(self, r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=from_millis(r[2]),
            end_time=from_millis(r[3]), evaluation_class=r[4],
            engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7]), spark_conf=json.loads(r[8]),
            evaluator_results=r[9], evaluator_results_html=r[10],
            evaluator_results_json=r[11])

    def get(self, instance_id):
        rows = self.c.query(
            f"SELECT {self.COLS} FROM {self.t} WHERE id=?", (instance_id,))
        return self._row(rows[0]) if rows else None

    def get_all(self):
        return [self._row(r)
                for r in self.c.query(f"SELECT {self.COLS} FROM {self.t}")]

    def get_completed(self):
        rows = self.c.query(
            f"SELECT {self.COLS} FROM {self.t} WHERE status='EVALCOMPLETED' "
            "ORDER BY starttime DESC")
        return [self._row(r) for r in rows]

    def update(self, i: EvaluationInstance) -> bool:
        cur = self.c.execute(
            f"UPDATE {self.t} SET status=?, starttime=?, endtime=?, "
            "evaluationclass=?, engineparamsgeneratorclass=?, batch=?, env=?, "
            "sparkconf=?, evaluatorresults=?, evaluatorresultshtml=?, "
            "evaluatorresultsjson=? WHERE id=?",
            (i.status, to_millis(i.start_time), to_millis(i.end_time),
             i.evaluation_class, i.engine_params_generator_class, i.batch,
             json.dumps(i.env), json.dumps(i.spark_conf), i.evaluator_results,
             i.evaluator_results_html, i.evaluator_results_json, i.id))
        return cur.rowcount > 0

    def delete(self, instance_id) -> bool:
        return self.c.execute(f"DELETE FROM {self.t} WHERE id=?",
                              (instance_id,)).rowcount > 0


class SQLModels(base.Models):
    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_models"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id TEXT PRIMARY KEY, models BLOB NOT NULL)""")

    def insert(self, model: Model) -> None:
        self.c.execute(f"INSERT OR REPLACE INTO {self.t} VALUES (?,?)",
                       (model.id, model.models))

    def get(self, model_id: str) -> Optional[Model]:
        rows = self.c.query(f"SELECT id, models FROM {self.t} WHERE id=?",
                            (model_id,))
        return Model(rows[0][0], bytes(rows[0][1])) if rows else None

    def delete(self, model_id: str) -> bool:
        return self.c.execute(f"DELETE FROM {self.t} WHERE id=?",
                              (model_id,)).rowcount > 0


class SQLEvents(base.Events):
    def __init__(self, client, ns):
        self.c = client
        self.t = f"{ns}_events"
        client.execute(f"""CREATE TABLE IF NOT EXISTS {self.t} (
            id TEXT NOT NULL,
            appid INTEGER NOT NULL,
            channelid INTEGER NOT NULL DEFAULT 0,
            event TEXT NOT NULL,
            entitytype TEXT NOT NULL,
            entityid TEXT NOT NULL,
            targetentitytype TEXT,
            targetentityid TEXT,
            properties TEXT,
            eventtime INTEGER NOT NULL,
            tags TEXT,
            prid TEXT,
            creationtime INTEGER NOT NULL,
            PRIMARY KEY (appid, channelid, id))""")
        client.execute(
            f"CREATE INDEX IF NOT EXISTS {self.t}_time ON {self.t} "
            "(appid, channelid, eventtime)")
        client.execute(
            f"CREATE INDEX IF NOT EXISTS {self.t}_entity ON {self.t} "
            "(appid, channelid, entitytype, entityid)")
        # the reference's entity-filtered reads probe these two indexes;
        # created here too so the schema stays the same
        client.execute(
            f"CREATE INDEX IF NOT EXISTS {self.t}_entityid ON {self.t} "
            "(appid, channelid, entityid)")
        client.execute(
            f"CREATE INDEX IF NOT EXISTS {self.t}_target ON {self.t} "
            "(appid, channelid, targetentityid)")

    @staticmethod
    def _chan(channel_id) -> int:
        return 0 if channel_id is None else int(channel_id)

    def init(self, app_id, channel_id=None) -> bool:
        return True  # single-table design: nothing to create per namespace

    def remove(self, app_id, channel_id=None) -> bool:
        self.c.execute(f"DELETE FROM {self.t} WHERE appid=? AND channelid=?",
                       (app_id, self._chan(channel_id)))
        return True

    def insert(self, event: Event, app_id, channel_id=None) -> str:
        eid = event.event_id or new_event_id()
        self.c.execute(
            f"INSERT OR REPLACE INTO {self.t} VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (eid, app_id, self._chan(channel_id), event.event,
             event.entity_type, event.entity_id, event.target_entity_type,
             event.target_entity_id, event.properties.to_json(),
             to_millis(event.event_time), json.dumps(list(event.tags)),
             event.pr_id, to_millis(event.creation_time)))
        return eid

    def insert_batch(self, events, app_id, channel_id=None):
        eids = []
        rows = []
        for event in events:
            eid = event.event_id or new_event_id()
            eids.append(eid)
            rows.append(
                (eid, app_id, self._chan(channel_id), event.event,
                 event.entity_type, event.entity_id, event.target_entity_type,
                 event.target_entity_id, event.properties.to_json(),
                 to_millis(event.event_time), json.dumps(list(event.tags)),
                 event.pr_id, to_millis(event.creation_time)))
        self._write_rows(rows)
        return eids

    def _write_rows(self, rows):
        with self.c.lock:
            self.c._conn.executemany(
                f"INSERT OR REPLACE INTO {self.t} VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?,?)", rows)
            self.c._conn.commit()

    def insert_columnar(self, batch, app_id, channel_id=None):
        """Columnar bulk write straight from the parallel arrays: one
        id-mint pass, rows zipped from the columns (broadcast scalars
        ride itertools.repeat), one executemany and one commit, no Event
        objects on the way in."""
        n = batch.n
        if n == 0:
            return []
        ids = batch.event_id
        if ids is None:
            ids = new_event_ids(n)
        else:
            ids = [x if x else new_event_id() for x in ids]
        now = utcnow()
        now_ms = to_millis(now)
        et = batch.event_time
        if et is None:
            t_col = repeat(now_ms)
        elif isinstance(et, str):
            t_col = repeat(to_millis(parse_event_time(et)))
        else:
            t_col = [to_millis(parse_event_time(x)) if x else now_ms
                     for x in et]
        props = batch.properties
        dumps = json.JSONEncoder(separators=(",", ":")).encode
        p_col = (repeat("{}") if props is None
                 else [dumps(p) if p else "{}" for p in props])

        def bcast(c):
            return repeat(c) if isinstance(c, str) else c

        def tgt(c):
            # absent targets store as NULL, matching the object path
            if c is None or isinstance(c, str):
                return repeat(c or None)
            return [x or None for x in c]

        chan = self._chan(channel_id)
        rows = list(zip(ids, repeat(app_id), repeat(chan),
                        bcast(batch.event), bcast(batch.entity_type),
                        batch.entity_id, tgt(batch.target_entity_type),
                        tgt(batch.target_entity_id), p_col, t_col,
                        repeat("[]"), repeat(None), repeat(now_ms)))
        self._write_rows(rows)
        return ids

    def _from_row(self, r) -> Event:
        return Event(
            event_id=r[0], event=r[3], entity_type=r[4], entity_id=r[5],
            target_entity_type=r[6], target_entity_id=r[7],
            properties=DataMap(json.loads(r[8]) if r[8] else {}),
            event_time=from_millis(r[9]),
            tags=tuple(json.loads(r[10]) if r[10] else ()),
            pr_id=r[11], creation_time=from_millis(r[12]))

    def get(self, event_id, app_id, channel_id=None) -> Optional[Event]:
        rows = self.c.query(
            f"SELECT * FROM {self.t} WHERE appid=? AND channelid=? AND id=?",
            (app_id, self._chan(channel_id), event_id))
        return self._from_row(rows[0]) if rows else None

    def delete(self, event_id, app_id, channel_id=None) -> bool:
        return self.c.execute(
            f"DELETE FROM {self.t} WHERE appid=? AND channelid=? AND id=?",
            (app_id, self._chan(channel_id), event_id)).rowcount > 0

    def _where(self, app_id, channel_id, start_time, until_time, entity_type,
               entity_id, event_names, target_entity_type, target_entity_id):
        sql = " WHERE appid=? AND channelid=?"
        params: list = [app_id, self._chan(channel_id)]
        if start_time is not None:
            sql += " AND eventtime>=?"
            params.append(to_millis(start_time))
        if until_time is not None:
            sql += " AND eventtime<?"
            params.append(to_millis(until_time))
        if entity_type is not None:
            sql += " AND entitytype=?"
            params.append(entity_type)
        if entity_id is not None:
            sql += " AND entityid=?"
            params.append(entity_id)
        if event_names is not None:
            sql += f" AND event IN ({','.join('?' * len(event_names))})"
            params.extend(event_names)
        if target_entity_type is not None:
            if target_entity_type is ABSENT:
                sql += " AND targetentitytype IS NULL"
            else:
                sql += " AND targetentitytype=?"
                params.append(target_entity_type)
        if target_entity_id is not None:
            if target_entity_id is ABSENT:
                sql += " AND targetentityid IS NULL"
            else:
                sql += " AND targetentityid=?"
                params.append(target_entity_id)
        return sql, params

    def find(self, app_id, channel_id=None, start_time=None, until_time=None,
             entity_type=None, entity_id=None, event_names=None,
             target_entity_type=None, target_entity_id=None, limit=None,
             reversed_order=False):
        where, params = self._where(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id)
        way = "DESC" if reversed_order else "ASC"
        if entity_id is None:
            order = f"eventtime {way}"
        else:
            # a point read: `+` keeps the planner from walking the whole
            # time index to skip a sort, so it seeks the entity index;
            # rowid keeps equal times in insertion order, as the time
            # index gives them
            order = f"+eventtime {way}, rowid {way}"
        sql = f"SELECT * FROM {self.t}{where} ORDER BY {order}"
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        for r in self.c.query(sql, tuple(params)):
            yield self._from_row(r)

    def find_columnar(self, app_id, channel_id=None, property_field=None,
                      start_time=None, until_time=None, entity_type=None,
                      entity_id=None, event_names=None,
                      target_entity_type=None, target_entity_id=None,
                      limit=None, reversed_order=False):
        """Projected scan: the property value is extracted SQL-side
        (json_extract), rows arrive as flat tuples, and no Event/DataMap
        objects are built (the ML-20M-scale training read). Rows come
        back by eventtime, equal times in rowid (insertion) order."""
        cols = "entityid, targetentityid, event, eventtime"
        params_pre: list = []
        if property_field is not None:
            cols += ", json_extract(properties, ?)"
            params_pre.append(f'$."{property_field}"')
        where, params = self._where(
            app_id, channel_id, start_time, until_time, entity_type,
            entity_id, event_names, target_entity_type, target_entity_id)
        sql = (f"SELECT {cols} FROM {self.t}{where} ORDER BY eventtime "
               f"{'DESC' if reversed_order else 'ASC'}")
        if limit is not None and limit >= 0:
            sql += " LIMIT ?"
            params.append(limit)
        rows = self.c.query(sql, tuple(params_pre) + tuple(params))
        if not rows:
            out = {"entity_id": np.array([], dtype=str),
                   "target_entity_id": np.array([], dtype=str),
                   "event": np.array([], dtype=str),
                   "t": np.array([], dtype=np.int64)}
            if property_field is not None:
                out["prop"] = np.array([], dtype=np.float32)
            return out
        ents, tgts, names, ts, *rest = zip(*rows)
        out = {
            "entity_id": np.array(ents, dtype=str),
            "target_entity_id": np.array(
                [x or "" for x in tgts], dtype=str),
            "event": np.array(names, dtype=str),
            "t": np.array(ts, dtype=np.int64),
        }
        if property_field is not None:
            out["prop"] = np.array(
                [np.nan if v is None else v for v in rest[0]],
                dtype=np.float32)
        return out

    #: ids an IN-list statement (far under SQLite's 999-variable floor
    #: beside the shared filter parameters)
    _IN_CHUNK = 400

    def find_columnar_by_entities(self, app_id, channel_id=None,
                                  entity_ids=None, target_entity_ids=None,
                                  property_field=None, start_time=None,
                                  until_time=None, entity_type=None,
                                  target_entity_type=None, event_names=None,
                                  limit=None):
        """The entity-filtered read as SQL: one indexed `IN (...)` query
        an id chunk a side (entityid through {t}_entity, targetentityid
        through {t}_target), merged on the event id by
        `base.columnar_from_union_rows`; equal event times in insertion
        order, as `find_columnar` gives them."""
        rows_by_id: dict = {}
        for column, ids in (("entityid", entity_ids),
                            ("targetentityid", target_entity_ids)):
            ids = [str(x) for x in (ids or ())]
            for lo in range(0, len(ids), self._IN_CHUNK):
                chunk = ids[lo:lo + self._IN_CHUNK]
                cols = "id, rowid, entityid, targetentityid, event, eventtime"
                params_pre: list = []
                if property_field is not None:
                    cols += ", json_extract(properties, ?)"
                    params_pre.append(f'$."{property_field}"')
                where, params = self._where(
                    app_id, channel_id, start_time, until_time,
                    entity_type, None, event_names, target_entity_type,
                    None)
                where += (f" AND {column} IN "
                          f"({','.join('?' * len(chunk))})")
                params.extend(chunk)
                # named: with an entity type given, the planner would take
                # the entity index's longer equality prefix and scan every
                # row of that type
                indexed = (f" INDEXED BY {self.t}_target"
                           if column == "targetentityid" else "")
                for r in self.c.query(
                        f"SELECT {cols} FROM {self.t}{indexed}{where}",
                        tuple(params_pre) + tuple(params)):
                    rows_by_id[r[0]] = r[1:]
        # insertion (rowid) order before the merge's stable time sort:
        # equal times then come back as a full scan gives them
        return base.columnar_from_union_rows(
            {k: r[1:] for k, r in sorted(rows_by_id.items(),
                                         key=lambda kv: kv[1][0])},
            property_field, limit)
