"""Port parity: the memory, nativelog and remotefs storage backends vs the
JAX package's.

Every case makes the same calls, with the same seeded inputs, on both
packages' backends (each in a directory of its own) and holds the
results equal: events as their wire dicts (ids, times, properties),
column dicts array for array (NaN where a property is missing compares
equal), metadata records field for field. Nothing here has a
tolerance: the backends store and return exact values. The cases are
those of `tests/test_storage.py` (CRUD, the find filters, the columnar
reads with escaped strings, the entity-filtered read, the chunked read,
the property fold, the metadata DAOs), run for `memory`, `nativelog`
with one partition and with four, and `remotefs`; then the nativelog
partition cases (a refused partition change, the legacy-file migration,
scans beside writes, a torn tail), and the cross-read: a log the JAX
nativelog wrote is read by the port, and one the port wrote by the JAX
nativelog.
"""

import datetime as dt
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from predictionio_tpu.data import columnar as JCol
from predictionio_tpu.data import datamap as JDM
from predictionio_tpu.data import event as JE
from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import memory as JMem
from predictionio_tpu.data.storage import nativelog as JNL
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage import remotefs as JRFS
from predictionio_tpu_torch.data import columnar as TCol
from predictionio_tpu_torch.data import datamap as TDM
from predictionio_tpu_torch.data import event as TE
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import memory as TMem
from predictionio_tpu_torch.data.storage import nativelog as TNL
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage import remotefs as TRFS

PKGS = {
    "jax": dict(event=JE, dm=JDM, base=JB, col=JCol, reg=JReg, mem=JMem,
                nl=JNL, rfs=JRFS),
    "port": dict(event=TE, dm=TDM, base=TB, col=TCol, reg=TReg, mem=TMem,
                 nl=TNL, rfs=TRFS),
}
UTC = dt.timezone.utc
CREATED = dt.datetime(2026, 2, 1, tzinfo=UTC)


def t(sec):
    return dt.datetime(2026, 1, 1, 0, 0, sec, tzinfo=UTC)


def mk(pkg, event="rate", eid="u1", sec=1, props=None, **kw):
    """One event of `pkg`, with a fixed creation time so both packages'
    wire dicts compare equal."""
    m = PKGS[pkg]
    return m["event"].Event(
        event=event, entity_type="user", entity_id=eid, event_time=t(sec),
        properties=m["dm"].DataMap(props or {}), creation_time=CREATED,
        **kw)


def wire(events, ids=True, created=True):
    """Events as wire dicts; without the ids a backend minted, or the
    creation times a columnar write stamps."""
    out = [e.to_dict() for e in events]
    for d in out:
        if not ids:
            d.pop("eventId", None)
        if not created:
            d.pop("creationTime", None)
    return out


def cols_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype.kind == b[k].dtype.kind, k
        if a[k].dtype.kind == "f":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k].tolist() == b[k].tolist(), k


def client(pkg, kind, root, partitions=1):
    m = PKGS[pkg]
    if kind == "memory":
        return m["mem"].StorageClient(
            m["reg"].StorageClientConfig("TEST", "memory", {}))
    return m["nl"].StorageClient(m["reg"].StorageClientConfig(
        "TEST", "nativelog", {"PATH": str(root / pkg / "log"),
                              "PARTITIONS": str(partitions)}))


EVENT_BACKENDS = {"memory": ("memory", 1), "nativelog": ("nativelog", 1),
                  "nativelog-p4": ("nativelog", 4)}


@pytest.fixture(params=sorted(EVENT_BACKENDS))
def pair(request, tmp_path):
    """{pkg: events DAO of app 1} over the same backend type."""
    kind, parts = EVENT_BACKENDS[request.param]
    clients = {pkg: client(pkg, kind, tmp_path, parts) for pkg in PKGS}
    daos = {}
    for pkg, c in clients.items():
        daos[pkg] = c.get_data_object("events", "test")
        daos[pkg].init(1)
    yield daos
    for c in clients.values():
        c.close()


def both(daos, fn):
    """fn(pkg, dao) on both packages; returns {pkg: result}."""
    return {pkg: fn(pkg, dao) for pkg, dao in daos.items()}


def same(daos, fn):
    r = both(daos, fn)
    assert r["jax"] == r["port"]
    return r["port"]


def fill(pkg, ev):
    """The find spec's four events (tests/test_storage.py TestEventsFind),
    with supplied ids."""
    ev.insert_batch([
        mk(pkg, "rate", "u1", 1, target_entity_type="item",
           target_entity_id="i1", event_id="e1"),
        mk(pkg, "buy", "u1", 2, target_entity_type="item",
           target_entity_id="i2", event_id="e2"),
        mk(pkg, "rate", "u2", 3, target_entity_type="item",
           target_entity_id="i1", event_id="e3"),
        mk(pkg, "$set", "u1", 4, props={"a": 1}, event_id="e4"),
    ], 1)


# ---------------------------------------------------------------------------
# the events spec, on both packages
# ---------------------------------------------------------------------------

def test_insert_get_delete(pair):
    def run(pkg, ev):
        eid = ev.insert(mk(pkg, props={"rating": 5}), 1)
        got = ev.get(eid, 1)
        out = [wire([got], ids=False), got.event_id == eid]
        out += [ev.delete(eid, 1), ev.get(eid, 1), ev.delete(eid, 1)]
        out.append(ev.get("nope", 1))
        return out
    assert same(pair, run)[1:] == [True, True, None, False, None]


def test_channel_and_app_isolation_and_remove(pair):
    def run(pkg, ev):
        ev.init(1, 5)
        ev.init(2)
        eid = ev.insert(mk(pkg, event_id="c1"), 1, 5)
        ev.insert(mk(pkg, event_id="a1"), 1)
        out = [ev.get(eid, 1) is None, ev.get(eid, 1, 5).event_id,
               wire(ev.find(1)), wire(ev.find(1, 5)), wire(ev.find(2))]
        out.append(ev.remove(1))
        out += [wire(ev.find(1)), wire(ev.find(1, 5))]
        return out
    same(pair, run)


def test_insert_batch_ids_order_and_overwrite(pair):
    def run(pkg, ev):
        minted = ev.insert_batch([mk(pkg, sec=i) for i in range(5)], 1)
        ids = ev.insert_batch(
            [mk(pkg, eid=f"u{i}", sec=10 + i, event_id=f"b{i}")
             for i in range(3)]
            + [mk(pkg, eid="last", sec=20, event_id="b1")], 1)
        assert len(set(minted)) == 5
        # an overwrite by a supplied id keeps one copy, the last
        ev.insert(mk(pkg, eid="again", sec=21, event_id="b2"), 1)
        return [ids, ev.insert_batch([], 1),
                wire(ev.find(1), ids=False), ev.get("b1", 1).entity_id]
    assert same(pair, run)[-1] == "last"


FIND_CASES = [
    dict(start_time=t(2)), dict(until_time=t(2)),
    dict(start_time=t(2), until_time=t(4)),
    dict(entity_id="u1"), dict(entity_type="user"),
    dict(entity_type="nope"), dict(event_names=["rate"]),
    dict(event_names=["rate", "buy"]), dict(target_entity_id="i1"),
    dict(target_entity_type="ABSENT"), dict(target_entity_id="ABSENT"),
    dict(limit=2), dict(limit=-1),
    dict(entity_id="u1", reversed_order=True),
]


@pytest.mark.parametrize("case", range(len(FIND_CASES)))
def test_find_filters(pair, case):
    def run(pkg, ev):
        fill(pkg, ev)
        kw = {k: (PKGS[pkg]["base"].ABSENT if v == "ABSENT" else v)
              for k, v in FIND_CASES[case].items()}
        return wire(ev.find(1, **kw))
    same(pair, run)


def test_find_columnar_and_escaped_strings(pair):
    def run(pkg, ev):
        fill(pkg, ev)
        ev.insert(mk(pkg, "rate", "u3", 5, target_entity_type="item",
                     target_entity_id="i9", props={"rating": 4.5},
                     event_id="e5"), 1)
        ev.insert(mk(pkg, "rate", 'u"q\\uote', 6, target_entity_type="item",
                     target_entity_id="ié中", props={"rating": 2},
                     event_id="e6"), 1)
        return [ev.find_columnar(1, property_field="rating",
                                 entity_type="user",
                                 target_entity_type="item",
                                 event_names=["rate", "buy"]),
                ev.find_columnar(1, entity_type="user"),
                ev.find_columnar(1, property_field="rating",
                                 event_names=["rate"])]
    r = both(pair, run)
    for a, b in zip(r["jax"], r["port"]):
        cols_equal(a, b)
    assert "ié中" in r["port"][2]["target_entity_id"].tolist()


BY_ENTITY_CASES = [
    (["u1"], []), ([], ["i1"]), (["u1"], ["i2"]),
    (["u1", "u2", "u3"], ["i1", "i2"]), (["nope"], ["also-nope"]), ([], []),
]


def test_find_columnar_by_entities(pair):
    def run(pkg, ev):
        fill(pkg, ev)
        ev.insert(mk(pkg, "rate", "u3", 5, target_entity_type="item",
                     target_entity_id="i2", props={"rating": 3.5},
                     event_id="e5"), 1)
        out = [ev.find_columnar_by_entities(1, entity_ids=e,
                                            target_entity_ids=g)
               for e, g in BY_ENTITY_CASES]
        out.append(ev.find_columnar_by_entities(
            1, entity_ids=["u1", "u3"], target_entity_ids=[],
            event_names=["rate"], start_time=t(2)))
        out.append(ev.find_columnar_by_entities(
            1, entity_ids=["u3"], target_entity_ids=[],
            property_field="rating"))
        out.append(ev.find_columnar_by_entities(
            1, entity_ids=["u1"], target_entity_ids=["i1"], limit=2))
        out.append(ev.find_columnar_by_entities(
            1, entity_ids=["u1"], target_entity_ids=["i1"], limit=0))
        # overwrite-by-id re-routes the entity; a delete drops it
        ev.insert(mk(pkg, "rate", "u10", 5, target_entity_type="item",
                     target_entity_id="i2", event_id="e5"), 1)
        out.append(ev.find_columnar_by_entities(1, entity_ids=["u3"]))
        out.append(ev.find_columnar_by_entities(1, entity_ids=["u10"]))
        ev.delete("e5", 1)
        out.append(ev.find_columnar_by_entities(1, entity_ids=["u10"]))
        return out
    r = both(pair, run)
    for a, b in zip(r["jax"], r["port"]):
        cols_equal(a, b)
    assert len(r["port"][-2]["t"]) == 1 and len(r["port"][-1]["t"]) == 0


@pytest.mark.parametrize("chunk_rows", [1, 2, 7, 1000])
def test_find_columnar_chunked(pair, chunk_rows):
    """Chunks concatenate to one `find_columnar`, a millisecond's rows
    never split, on both packages alike."""
    def run(pkg, ev):
        rng = np.random.default_rng(3)
        ev.insert_batch([mk(pkg, "rate", f"u{k % 5}", int(s),
                            target_entity_type="item",
                            target_entity_id=f"i{k % 7}",
                            props={"rating": float(k % 5)},
                            event_id=f"c{k}")
                         for k, s in enumerate(rng.integers(0, 12, 40))], 1)
        chunks = list(ev.find_columnar_chunked(
            1, property_field="rating", chunk_rows=chunk_rows,
            event_names=["rate"]))
        whole = ev.find_columnar(1, property_field="rating",
                                 event_names=["rate"])
        cat = {k: np.concatenate([c[k] for c in chunks]) for k in whole}
        cols_equal(cat, whole)
        for a, b in zip(chunks, chunks[1:]):
            assert a["t"][-1] < b["t"][0]
        return [len(c["t"]) for c in chunks], whole
    r = both(pair, run)
    assert r["jax"][0] == r["port"][0]
    cols_equal(r["jax"][1], r["port"][1])


def test_aggregate_properties(pair):
    def run(pkg, ev):
        fill(pkg, ev)
        ev.insert(mk(pkg, "$unset", "u1", 5, props={"a": None}), 1)
        ev.insert(mk(pkg, "$set", "u3", 5, props={"b": 2}), 1)
        ev.insert(mk(pkg, "$set", "u4", 6, props={"b": 3, "c": [1, 2]}), 1)
        ev.insert(mk(pkg, "$delete", "u4", 7), 1)
        agg = ev.aggregate_properties(1, entity_type="user")
        req = ev.aggregate_properties(1, entity_type="user", required=["b"])
        return ({k: v.fields for k, v in agg.items()}, sorted(req))
    assert same(pair, run) == ({"u1": {}, "u3": {"b": 2}}, ["u3"])


def test_insert_columnar(pair):
    """The bulk write: broadcast columns, per-row names, supplied ids and
    times, numeric property types, a minted-id batch."""
    def run(pkg, ev):
        C = PKGS[pkg]["col"].ColumnarBatch
        ids = ev.insert_columnar(C(
            4, "rate", "user", ["u1", "u2", "u3", "u1"], "item",
            ["i1", "i2", "", "i3"],
            [{"rating": 1}, {"rating": 2.0}, {}, {"rating": 4.5, "x": "y"}],
            "2026-01-01T00:00:01.000Z", ["k1", "k2", "k3", "k4"]), 1)
        ids2 = ev.insert_columnar(C(
            3, ["view", "buy", "view"], "user", ["u9", "u8", "u9"],
            event_time=["2026-01-01T00:00:02.000Z",
                        "2026-01-01T00:00:03.000Z",
                        "2026-01-01T00:00:04.000Z"],
            event_id=["k5", "k6", "k7"]), 1)
        minted = ev.insert_columnar(C(
            2, "rate", "user", ["m1", "m2"],
            event_time="2026-01-01T00:00:05.000Z"), 1)
        assert len(set(minted)) == 2
        return [ids, ids2,
                wire([e for e in ev.find(1) if e.event_id not in minted],
                     created=False),
                wire([ev.get(i, 1) for i in minted], ids=False,
                     created=False),
                ev.find_columnar(1, property_field="rating")]
    r = both(pair, run)
    for a, b in zip(r["jax"][:4], r["port"][:4]):
        assert a == b
    cols_equal(r["jax"][4], r["port"][4])
    (k1,) = [d for d in r["port"][2] if d["eventId"] == "k1"]
    assert type(k1["properties"]["rating"]) is int


def test_concurrent_writers_land_every_event(pair):
    """Eight writers at once through the group committer (nativelog) or
    the lock (memory): every event lands once on both packages."""
    def run(pkg, ev):
        def writer(w):
            for i in range(25):
                ev.insert(mk(pkg, eid=f"w{w}", sec=i % 50,
                             event_id=f"w{w}_{i}"), 1)
        ts = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(60)
        return sorted(e.event_id for e in ev.find(1))
    assert len(same(pair, run)) == 200


# ---------------------------------------------------------------------------
# metadata DAOs (memory)
# ---------------------------------------------------------------------------

@pytest.fixture()
def mem_pair():
    clients = {pkg: PKGS[pkg]["mem"].StorageClient(
        PKGS[pkg]["reg"].StorageClientConfig("TEST", "memory", {}))
        for pkg in PKGS}
    yield clients
    for c in clients.values():
        c.close()


def test_metadata_daos(mem_pair):
    def run(pkg, c):
        B = PKGS[pkg]["base"]
        apps = c.get_data_object("apps", "m")
        out = [apps.insert(B.App(0, "a1")), apps.insert(B.App(0, "a1")),
               apps.insert(B.App(7, "a7", "desc")), apps.get(7),
               apps.get_by_name("a1"), apps.get_all(),
               apps.update(B.App(7, "a7b")), apps.get(7), apps.delete(1),
               apps.delete(1), apps.get_all()]
        keys = c.get_data_object("access_keys", "m")
        out += [keys.insert(B.AccessKey("k1", 7, ("rate",))),
                keys.insert(B.AccessKey("k1", 7, ())), keys.get("k1"),
                keys.get_by_app_id(7), keys.update(B.AccessKey("k1", 7, ())),
                keys.get("k1"), keys.delete("k1"), keys.get_all()]
        minted = keys.insert(B.AccessKey("", 7, ()))
        out.append(len(minted) > 20)
        ch = c.get_data_object("channels", "m")
        out += [ch.insert(B.Channel(0, "c1", 7)),
                ch.insert(B.Channel(0, "c1", 7)),
                ch.insert(B.Channel(0, "c1", 8)), ch.get_by_app_id(7),
                ch.get(2), ch.delete(1), ch.get(1)]
        with pytest.raises(ValueError):
            B.Channel(0, "bad name!", 7)
        ins = c.get_data_object("engine_instances", "m")
        i1 = B.EngineInstance(
            id="", status="INIT", start_time=t(1), end_time=t(1),
            engine_id="e", engine_version="v", engine_variant="x",
            engine_factory="f")
        iid = ins.insert(i1)
        ins.insert(i1.with_(status="COMPLETED", start_time=t(3)))
        ins.insert(i1.with_(status="COMPLETED", start_time=t(2)))
        out += [iid, ins.get(iid), len(ins.get_all()),
                [i.id for i in ins.get_completed("e", "v", "x")],
                ins.get_latest_completed("e", "v", "x").id,
                ins.update(ins.get(iid).with_(status="COMPLETED")),
                ins.delete("2"), [i.id for i in ins.get_all()]]
        ev_ins = c.get_data_object("evaluation_instances", "m")
        e1 = B.EvaluationInstance(id="", status="EVALCOMPLETED",
                                  start_time=t(1), end_time=t(2),
                                  evaluation_class="MyEval")
        eid = ev_ins.insert(e1)
        out += [eid, ev_ins.get(eid).evaluation_class,
                len(ev_ins.get_completed()), ev_ins.delete(eid),
                ev_ins.get_all()]
        models = c.get_data_object("models", "m")
        models.insert(B.Model("m1", b"\x00blob"))
        out += [models.get("m1"), models.delete("m1"), models.get("m1")]
        return out
    r = both(mem_pair, run)
    assert [repr(x) for x in r["jax"]] == [repr(x) for x in r["port"]]


def test_memory_engine_manifests_wait_for_their_plane(mem_pair):
    """`MemEngineManifests` answers every call as the reference's."""
    def run(pkg, c):
        B = PKGS[pkg]["base"]
        dao = c.get_data_object("engine_manifests", "m")
        m1 = B.EngineManifest("e", "1", "n1", "d", ("a.json",), "f")
        m2 = B.EngineManifest("e", "2", "n2")
        out = [dao.insert(m1), dao.insert(m2), dao.get("e", "1"),
               dao.get("e", "3"), dao.get_all(),
               dao.update(B.EngineManifest("x", "1", "x")), dao.get("x", "1"),
               dao.update(B.EngineManifest("x", "1", "x"), upsert=True),
               dao.get("x", "1"), dao.update(B.EngineManifest("e", "2", "r")),
               dao.get("e", "2"), dao.delete("e", "1"), dao.delete("e", "1"),
               dao.get_all()]
        return [repr(x) for x in out]
    r = both(mem_pair, run)
    assert r["jax"] == r["port"]


# ---------------------------------------------------------------------------
# remotefs
# ---------------------------------------------------------------------------

def test_remotefs_models_and_scheme_registry(tmp_path):
    for pkg, m in PKGS.items():
        root = tmp_path / pkg
        c = m["rfs"].StorageClient(m["reg"].StorageClientConfig(
            "R", "remotefs", {"URL": f"file://{root}/models"}))
        dao = c.get_data_object("models", "pio_model")
        dao.insert(m["base"].Model("a/b", b"\x01\x02"))
        assert dao.get("a/b").models == b"\x01\x02"
        assert dao.get("none") is None
        assert sorted(os.listdir(root / "models" / "pio_model")) == ["a_b"]
        assert dao.delete("a/b") and not dao.delete("a/b")
        with pytest.raises(m["reg"].StorageError):
            c.get_data_object("events", "pio_event")
        with pytest.raises(m["reg"].StorageError, match="gs"):
            m["rfs"].adapter_for("gs://bucket/models")

        blobs = {}

        class Mem(m["rfs"].SchemeAdapter):
            def read(self, path):
                return blobs[path]

            def write(self, path, data):
                blobs[path] = data

            def delete(self, path):
                return blobs.pop(path, None) is not None

            def exists(self, path):
                return path in blobs

        m["rfs"].register_scheme("memtest", Mem())
        try:
            c2 = m["rfs"].StorageClient(m["reg"].StorageClientConfig(
                "R", "hdfs", {"URL": "memtest://host/root"}))
            d2 = c2.get_data_object("models", "ns")
            d2.insert(m["base"].Model("x", b"y"))
            assert blobs == {"host/root/ns/x": b"y"}
            assert d2.get("x").models == b"y"
        finally:
            m["rfs"]._SCHEMES.pop("memtest", None)


def test_every_type_of_the_jax_registry_resolves():
    """The port's registry refuses no source type the JAX registry knows
    (the known types as its refusal lists them), and maps each to the
    port's module of the same name."""
    import ast
    with pytest.raises(JReg.StorageError) as e:
        JReg._backend_module("no-such-type")
    known = ast.literal_eval(str(e.value).split("Known types: ", 1)[1])
    assert {"docindex", "pgsql", "mysql", "nativelog"} <= set(known)
    assert sorted(TReg.BACKENDS) == sorted(known)
    for type_ in known:
        want = JReg._backend_module(type_).__name__.replace(
            "predictionio_tpu.", "predictionio_tpu_torch.")
        assert TReg._backend_module(type_).__name__ == want, type_
    with pytest.raises(TReg.StorageError, match="Unknown storage source"):
        TReg._backend_module("no-such-type")


def test_registry_serves_the_new_types(tmp_path, monkeypatch):
    """The port's registry hands out each new type as the JAX one does;
    `clear_cache` stops nativelog's committers; `PIO_FAULTS` wraps its
    events DAO."""
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "base"))
    for k in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "NL")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NL_TYPE", "nativelog")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NL_PATH", str(tmp_path / "nl"))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NL_PARTITIONS", "2")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE", "RF")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_RF_TYPE", "hdfs")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_RF_URL",
                       f"file://{tmp_path}/rf")
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "MEM")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_MEM_TYPE", "memory")
    TReg.clear_cache()
    try:
        S = TReg.Storage
        assert S.config_summary() == {"METADATA": "memory",
                                      "EVENTDATA": "nativelog",
                                      "MODELDATA": "hdfs"}
        ev = S.get_events()
        assert isinstance(ev, TNL.NativeLogEvents) and ev.partitions == 2
        ev.init(1)
        ev.insert(mk("port", event_id="r1"), 1)
        S.get_model_data_models().insert(TB.Model("m", b"z"))
        assert (tmp_path / "rf" / "pio_model" / "m").read_bytes() == b"z"
        assert S.get_meta_data_apps().insert(TB.App(0, "x")) == 1
        committers = list(ev._committers.values())
        assert committers and not any(c.stopped for c in committers)
        TReg.clear_cache()
        assert all(c.stopped for c in committers) and ev._closed
        monkeypatch.setenv("PIO_FAULTS", "storage.write:error=1.0,seed=1")
        TReg.clear_cache()
        faulty = S.get_events()
        assert type(faulty).__name__ == "FaultyEvents"
        with pytest.raises(Exception):
            faulty.insert(mk("port"), 1)
        monkeypatch.delenv("PIO_FAULTS")
        TReg.clear_cache()
        assert [e.event_id for e in S.get_events().find(1)] == ["r1"]
        monkeypatch.setenv("PIO_STORAGE_SOURCES_NL_TYPE", "cassandra")
        TReg.clear_cache()
        with pytest.raises(TReg.StorageError,
                           match="Unknown storage source type"):
            S.get_events()
    finally:
        TReg.clear_cache()


def test_a_failed_build_raises_a_storage_error(tmp_path, monkeypatch):
    """No fallback: a library that does not build raises StorageError
    carrying the compiler's output."""
    from predictionio_tpu_torch.compile import cache
    from predictionio_tpu_torch.ops import _build
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "eventlog.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(cache, "_salt_memo", None)
    monkeypatch.setattr(cache, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("PIO_BUILD_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(TNL, "_LIB", None)
    monkeypatch.setattr(TNL, "_PYLIB", None)
    try:
        with pytest.raises(TReg.StorageError, match="g\\+\\+ failed"):
            TNL.StorageClient(TReg.StorageClientConfig(
                "T", "nativelog", {"PATH": str(tmp_path / "log")}))
        assert not list((tmp_path / "build").rglob("*.so"))
    finally:
        cache._salt_memo = None


def test_concurrent_builds_load_one_library(tmp_path, monkeypatch):
    """Many threads asking for the library at once: one g++ run, a
    library every loader finds whole."""
    from predictionio_tpu_torch.compile import cache
    from predictionio_tpu_torch.ops import _build
    monkeypatch.setenv("PIO_BUILD_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    runs = []
    real = _build.subprocess.Popen

    def counted(cmd, *a, **kw):
        if "-o" in cmd:           # a build, not the salt's `--version`
            runs.append(cmd)
        return real(cmd, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "Popen", counted)
    libs, errors = [], []

    def go():
        try:
            libs.append(_build.load("eventlog"))
        except Exception as e:    # surfaced below
            errors.append(e)

    ts = [threading.Thread(target=go) for _ in range(6)]
    for th in ts:
        th.start()
    for th in ts:
        th.join(120)
    assert errors == [] and len(libs) == 6 and len(set(map(id, libs))) == 1
    assert len(runs) == 1 and runs[0][0] == "g++"
    path = _build.library_path("eventlog")
    assert path.parent.name == cache.cache_salt()
    assert sorted(p.name for p in path.parent.iterdir()) == [
        "eventlog.log", "eventlog.so", "eventlog.so.lock"]


def test_processes_racing_to_build_run_one_compiler(tmp_path):
    """Four processes asking for the library at once (the test workers,
    an event server beside a trainer): the lock file lets one build it;
    the others wait and load that library, and all of them read it."""
    code = ("import sys; from predictionio_tpu_torch.ops import _build; "
            "lib = _build.load('eventlog', py_api=True); "
            "lib.el_hash.restype = __import__('ctypes').c_uint64; "
            "print(_build.BUILDS.builds, lib.el_hash(b'u1', 2))")
    env = dict(os.environ, PIO_BUILD_CACHE_DIR=str(tmp_path / "build"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    builds = [int(o.split()[0]) for o, _ in outs]
    hashes = {o.split()[1] for o, _ in outs}
    assert sorted(builds) == [0, 0, 0, 1] and len(hashes) == 1
    assert len(list((tmp_path / "build").rglob("*.so"))) == 1
    assert not list((tmp_path / "build").rglob("*.tmp"))


# ---------------------------------------------------------------------------
# nativelog partitions, and the cross-read
# ---------------------------------------------------------------------------

def nl(pkg, root, partitions):
    m = PKGS[pkg]
    return m["nl"].StorageClient(m["reg"].StorageClientConfig(
        "TEST", "nativelog", {"PATH": str(root), "PARTITIONS":
                              str(partitions)}))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_partition_count_change_is_refused(tmp_path, pkg):
    c = nl(pkg, tmp_path / "plog", 4)
    ev = c.get_data_object("events", "test")
    ev.init(1)
    ev.insert(mk(pkg), 1)
    c.close()
    c2 = nl(pkg, tmp_path / "plog", 2)
    with pytest.raises(ValueError, match="PARTITIONS=4"):
        c2.get_data_object("events", "test")
    c2.close()


def legacy_then_partitioned(pkg, root):
    c1 = nl(pkg, root, 1)
    ev1 = c1.get_data_object("events", "test")
    ev1.init(1)
    ev1.insert_batch([mk(pkg, eid=f"old{i}", sec=i + 1, event_id=f"o{i}")
                      for i in range(5)], 1)
    ev1.insert(mk(pkg, eid="uX", sec=9, props={"v": 1}, event_id="x"), 1)
    c1.close()
    c4 = nl(pkg, root, 4)
    ev4 = c4.get_data_object("events", "test")
    ev4.init(1)
    ev4.insert_batch([mk(pkg, eid=f"new{i}", sec=i + 10, event_id=f"n{i}")
                      for i in range(5)], 1)
    # a legacy id re-inserted supersedes its legacy copy
    ev4.insert(mk(pkg, eid="uX", sec=20, props={"v": 2}, event_id="x"), 1)
    out = [wire(ev4.find(1)), ev4.get("o0", 1).entity_id,
           wire(ev4.find(1, entity_type="user", entity_id="old2")),
           ev4.find_columnar(1),
           ev4.find_columnar_by_entities(1, entity_ids=["old3", "new1"])]
    out += [ev4.delete("x", 1), ev4.get("x", 1), ev4.remove(1),
            wire(ev4.find(1))]
    c4.close()
    return out


def test_legacy_file_migration(tmp_path):
    r = {pkg: legacy_then_partitioned(pkg, tmp_path / pkg)
         for pkg in PKGS}
    for k, (a, b) in enumerate(zip(r["jax"], r["port"])):
        if isinstance(a, dict):
            cols_equal(a, b)
        else:
            assert a == b, k
    assert len(r["port"][0]) == 11 and r["port"][-1] == []


@pytest.mark.parametrize("pkg", ["port"])
def test_concurrent_scans_and_writes(tmp_path, pkg):
    """Parallel full scans beside inserts on a partitioned log: no error,
    every write lands, and the JAX nativelog reads the result alike."""
    c = nl(pkg, tmp_path / "plog", 4)
    ev = c.get_data_object("events", "test")
    ev.init(1)
    ev.insert_batch([mk(pkg, eid=f"u{i}", sec=i % 50, event_id=f"s{i}")
                     for i in range(100)], 1)
    errors, stop = [], threading.Event()

    def scanner():
        try:
            while not stop.is_set():
                assert len(list(ev.find(1))) >= 100
                assert len(ev.find_columnar(1)["entity_id"]) >= 100
        except Exception as e:   # surfaced below
            errors.append(e)

    def writer(base):
        try:
            for i in range(50):
                ev.insert(mk(pkg, eid=f"w{base}_{i}", sec=i % 50,
                             event_id=f"w{base}_{i}"), 1)
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = ([threading.Thread(target=scanner) for _ in range(3)]
               + [threading.Thread(target=writer, args=(b,))
                  for b in range(3)])
    for th in threads:
        th.start()
    for th in threads[3:]:
        th.join(60)
    stop.set()
    for th in threads[:3]:
        th.join(60)
    assert errors == []
    mine = wire(ev.find(1))
    assert len(mine) == 250
    c.close()
    j = nl("jax", tmp_path / "plog", 4)
    theirs = wire(j.get_data_object("events", "test").find(1))
    j.close()
    assert theirs == mine


def test_torn_tail_recovery(tmp_path):
    r = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        c = nl(pkg, root, 1)
        ev = c.get_data_object("events", "test")
        ev.init(1)
        ev.insert_batch([mk(pkg, eid=f"u{i}", sec=i + 1, event_id=f"t{i}")
                         for i in range(10)], 1)
        c.close()
        path = root / "test" / "events_1_0.log"
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)   # tear the last record
        c2 = nl(pkg, root, 1)
        ev2 = c2.get_data_object("events", "test")
        got = [wire(ev2.find(1)), ev2.get("t0", 1) is not None]
        ev2.insert(mk(pkg, eid="post", sec=59, event_id="p"), 1)
        got += [wire(ev2.find(1)), ev2.find_columnar(1)]
        c2.close()
        r[pkg] = got
    assert r["jax"][:3] == r["port"][:3]
    cols_equal(r["jax"][3], r["port"][3])
    assert len(r["port"][0]) == 9 and len(r["port"][2]) == 10


def write_log(pkg, root, partitions):
    """A log with every write path: single inserts, a batch, a columnar
    batch (supplied and minted ids), an overwrite and a delete."""
    m = PKGS[pkg]
    c = nl(pkg, root, partitions)
    ev = c.get_data_object("events", "test")
    ev.init(1)
    ev.init(1, 3)
    rng = np.random.default_rng(11)
    ev.insert_batch([mk(pkg, "rate", f"u{int(u)}", int(s),
                        target_entity_type="item",
                        target_entity_id=f"i{int(i)}",
                        props={"rating": float(r)}, event_id=f"b{k}")
                     for k, (u, i, s, r) in enumerate(zip(
                         rng.integers(0, 20, 60), rng.integers(0, 9, 60),
                         rng.integers(0, 50, 60), rng.integers(1, 6, 60)))],
                    1)
    ev.insert_columnar(m["col"].ColumnarBatch(
        3, "view", "user", ["v1", "v2", 'v"3'], "item", ["i1", "i2", "ié"],
        [{"n": 1}, {}, {"s": "x"}], "2026-01-01T00:00:30.500Z",
        ["c1", "c2", "c3"]), 1)
    ev.insert_columnar(m["col"].ColumnarBatch(
        2, "$set", "item", ["i1", "i2"], None, None,
        [{"cat": ["a"]}, {"cat": ["b"]}], "2026-01-01T00:00:40.000Z"), 1)
    ev.insert(mk(pkg, "buy", "u1", 51, event_id="b3",
                 target_entity_type="item", target_entity_id="i8"), 1)
    ev.delete("b4", 1)
    ev.insert(mk(pkg, "rate", "chan", 5, event_id="ch"), 1, 3)
    c.close()


def read_log(pkg, root, partitions):
    c = nl(pkg, root, partitions)
    ev = c.get_data_object("events", "test")
    out = [wire(ev.find(1)), wire(ev.find(1, 3)), ev.get("b3", 1).to_dict(),
           ev.get("b4", 1),
           ev.find_columnar(1, property_field="rating"),
           ev.find_columnar_by_entities(1, entity_ids=["u3", "v2"],
                                        target_entity_ids=["i1"]),
           {k: v.fields for k, v in ev.aggregate_properties(
               1, entity_type="item").items()}]
    c.close()
    return out


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_cross_read(tmp_path, writer, reader, partitions):
    """A log one package wrote reads back through the other exactly as
    through the writer (the file format is the reference's)."""
    root = tmp_path / "log"
    write_log(writer, root, partitions)
    theirs = read_log(writer, root, partitions)
    ours = read_log(reader, root, partitions)
    for a, b in zip(theirs, ours):
        if isinstance(a, dict) and a and isinstance(
                next(iter(a.values())), np.ndarray):
            cols_equal(a, b)
        else:
            assert a == b
    assert len(ours[0]) == 64 and ours[3] is None
    # the reader appends to the writer's log, and the writer reads it
    c = nl(reader, root, partitions)
    c.get_data_object("events", "test").insert(
        mk(reader, eid="late", sec=58, event_id="late"), 1)
    c.close()
    assert read_log(writer, root, partitions)[0][-1]["eventId"] == "late"
