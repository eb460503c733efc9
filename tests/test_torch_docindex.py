"""Port parity: the docindex metadata backend (the Elasticsearch role).

The JAX package's `TestDocIndex` cases (tests/test_storage.py) run for
both packages' `docindex`: the log replayed on reopen, a torn tail
skipped, compaction by atomic rewrite, term queries answered from the
posting lists, a sort that puts a missing field last in both directions,
float, bool and non-scalar filters, and the refusal of the event and
model roles. Then the six metadata DAOs take the same calls on both
packages (results equal by repr; records are frozen dataclasses of the
same name), the two logs those calls leave are byte-equal, and an index
one package wrote is read, DAO for DAO, by the other. Nothing here has a
tolerance: the backend stores and returns exact values.
"""

import datetime as dt
import os

import pytest

from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import docindex as JDoc
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import docindex as TDoc
from predictionio_tpu_torch.data.storage import registry as TReg

PKGS = {"jax": dict(base=JB, doc=JDoc, reg=JReg),
        "port": dict(base=TB, doc=TDoc, reg=TReg)}
KINDS = ("apps", "access_keys", "channels", "engine_instances",
         "engine_manifests", "evaluation_instances")
UTC = dt.timezone.utc


def client(pkg, root):
    m = PKGS[pkg]
    return m["doc"].StorageClient(m["reg"].StorageClientConfig(
        "TEST", "docindex", {"PATH": str(root / "dix"), "FSYNC": "false"}))


def index(pkg, path):
    return PKGS[pkg]["doc"].DocIndex(str(path), fsync=False)


@pytest.mark.parametrize("pkg", PKGS)
def test_survives_reopen(pkg, tmp_path):
    B = PKGS[pkg]["base"]
    c = client(pkg, tmp_path)
    apps = c.get_data_object("apps", "ns")
    aid = apps.insert(B.App(0, "persisted", "d"))
    aid2 = apps.insert(B.App(0, "deleted"))
    apps.delete(aid2)
    c.close()
    c2 = client(pkg, tmp_path)
    apps2 = c2.get_data_object("apps", "ns")
    assert apps2.get(aid).name == "persisted"
    assert apps2.get(aid2) is None
    assert apps2.get_by_name("persisted").id == aid
    # the int-id sequence continues past the replayed ids
    assert apps2.insert(B.App(0, "next")) == aid2 + 1
    c2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_torn_tail_ignored(pkg, tmp_path):
    B = PKGS[pkg]["base"]
    c = client(pkg, tmp_path)
    apps = c.get_data_object("apps", "ns")
    aid = apps.insert(B.App(0, "whole"))
    c.close()
    with open(tmp_path / "dix" / "ns" / "apps.log", "ab") as f:
        f.write(b'{"op":"put","id":"99","doc":{"id":99,"na')   # a crash
    c2 = client(pkg, tmp_path)
    apps2 = c2.get_data_object("apps", "ns")
    assert apps2.get(aid).name == "whole"
    assert apps2.get(99) is None
    c2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_compaction_rewrites_log(pkg, tmp_path):
    path = tmp_path / "c" / "x.log"
    ix = index(pkg, path)
    for i in range(1500):
        ix.put("hot", {"v": i})          # 1499 dead ops
    assert ix.get("hot") == {"v": 1499}
    # compaction fired at the 1024-dead-ops threshold and appends resumed
    # after it: the log holds far fewer than 1500 ops
    assert sum(1 for _ in open(path, "rb")) < 600
    ix.close()
    ix2 = index(pkg, path)
    assert ix2.get("hot") == {"v": 1499}
    ix2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_term_queries_use_posting_lists(pkg, tmp_path):
    ix = index(pkg, tmp_path / "q" / "x.log")
    for i in range(100):
        ix.put(str(i), {"status": "DONE" if i % 3 == 0 else "INIT",
                        "shard": i % 5, "t": i})
    hits = ix.search(eq={"status": "DONE", "shard": 0}, sort="t",
                     reverse=True)
    assert [d["t"] for d in hits] == [90, 75, 60, 45, 30, 15, 0]
    # the intersection came from the index, not a scan
    assert ix._inv["status"]["DONE"] & ix._inv["shard"][0] == \
        {str(d["t"]) for d in hits}
    assert ix.search(eq={"status": "GONE"}) == []
    ix.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_sort_missing_field_goes_last_both_directions(pkg, tmp_path):
    ix = index(pkg, tmp_path / "s" / "x.log")
    ix.put("a", {"t": 1})
    ix.put("b", {"t": 3})
    ix.put("legacy", {"other": True})
    assert [d.get("t") for d in ix.search(sort="t")] == [1, 3, None]
    assert [d.get("t") for d in ix.search(sort="t", reverse=True)] == \
        [3, 1, None]
    # mixed-type sort values order deterministically, without raising
    ix.put("m", {"t": "zzz"})
    assert [d.get("t") for d in ix.search(sort="t", reverse=True)][-1] \
        is None
    ix.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_eq_float_bool_and_nonscalar_filters(pkg, tmp_path):
    path = tmp_path / "f" / "x.log"
    ix = index(pkg, path)
    ix.put("f1", {"score": 1.5, "flag": True, "tags": ["a", "b"]})
    ix.put("f2", {"score": 1, "flag": 1, "tags": ["a"]})
    assert [d["score"] for d in ix.search(eq={"score": 1.5})] == [1.5]
    assert len(ix.search(eq={"flag": True})) == 1
    assert len(ix.search(eq={"flag": 1})) == 1
    assert ix.search(eq={"flag": True})[0] is not \
        ix.search(eq={"flag": 1})[0]
    # a non-scalar eq value falls back to a scan instead of nothing
    assert len(ix.search(eq={"tags": ["a", "b"]})) == 1
    ix.close()
    ix2 = index(pkg, path)      # the keys round-trip through the log
    assert len(ix2.search(eq={"flag": True})) == 1
    ix2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_refuses_event_and_model_roles(pkg, tmp_path):
    c = client(pkg, tmp_path)
    for kind in ("events", "models"):
        with pytest.raises(PKGS[pkg]["reg"].StorageError,
                           match="metadata backend"):
            c.get_data_object(kind, "ns")
    c.close()


def at(sec):
    return dt.datetime(2026, 1, 1, 0, 0, sec, tzinfo=UTC)


def write_all(pkg, c):
    """One seeded run of every metadata DAO's writes (explicit ids and
    keys, so the two packages' logs can compare byte for byte); returns
    what each call answered."""
    B = PKGS[pkg]["base"]
    apps = c.get_data_object("apps", "pio_meta")
    keys = c.get_data_object("access_keys", "pio_meta")
    chans = c.get_data_object("channels", "pio_meta")
    ins = c.get_data_object("engine_instances", "pio_meta")
    mans = c.get_data_object("engine_manifests", "pio_meta")
    evs = c.get_data_object("evaluation_instances", "pio_meta")
    out = [apps.insert(B.App(0, "a1", "first")), apps.insert(B.App(0, "a1")),
           apps.insert(B.App(5, "a5")), apps.update(B.App(5, "a5b", "d")),
           apps.update(B.App(9, "none")), apps.insert(B.App(0, "a6")),
           apps.delete(1)]
    out += [keys.insert(B.AccessKey("k1", 5, ("rate", "buy"))),
            keys.insert(B.AccessKey("k1", 5, ())),
            keys.insert(B.AccessKey("k2", 6, ())),
            keys.update(B.AccessKey("k2", 6, ("view",))),
            keys.delete("k9")]
    out += [chans.insert(B.Channel(0, "c1", 5)),
            chans.insert(B.Channel(0, "c1", 5)),
            chans.insert(B.Channel(0, "c1", 6)),
            chans.insert(B.Channel(20, "c2", 5))]
    for k in range(4):
        out.append(ins.insert(B.EngineInstance(
            id=f"ei{k}", status="COMPLETED" if k % 2 else "INIT",
            start_time=at(k), end_time=at(k + 10), engine_id="default",
            engine_version="0", engine_variant="/e.json",
            engine_factory="recommendation", batch=f"b{k}",
            env={"K": str(k)}, spark_conf={"s": "1"},
            data_source_params='{"app_name": "a"}',
            preparator_params="{}", algorithms_params="[]",
            serving_params="{}")))
    out.append(ins.update(ins.get("ei0").with_(status="COMPLETED")))
    out.append(ins.delete("ei3"))
    out += [mans.insert(B.EngineManifest("default", "0", "default", "d",
                                         ("/e.json",), "recommendation")),
            mans.insert(B.EngineManifest("other", "1", "o")),
            mans.update(B.EngineManifest("ghost", "1", "g")),
            mans.delete("other", "1")]
    for k in range(3):
        out.append(evs.insert(B.EvaluationInstance(
            id=f"ev{k}", status="EVALCOMPLETED" if k else "INIT",
            start_time=at(k), end_time=at(k + 5),
            evaluation_class="MyEval", engine_params_generator_class="Gen",
            batch="", env={}, spark_conf={}, evaluator_results=f"score {k}",
            evaluator_results_html=f"<b>{k}</b>",
            evaluator_results_json=f'{{"score": {k}}}')))
    out.append(evs.update(evs.get("ev0").with_(status="EVALCOMPLETED")))
    return out


def read_all(c):
    """Every DAO's reads, as reprs."""
    apps = c.get_data_object("apps", "pio_meta")
    keys = c.get_data_object("access_keys", "pio_meta")
    chans = c.get_data_object("channels", "pio_meta")
    ins = c.get_data_object("engine_instances", "pio_meta")
    mans = c.get_data_object("engine_manifests", "pio_meta")
    evs = c.get_data_object("evaluation_instances", "pio_meta")
    out = [apps.get_all(), apps.get(5), apps.get(1), apps.get_by_name("a6"),
           sorted(keys.get_all(), key=lambda k: k.key), keys.get("k2"),
           keys.get_by_app_id(5), chans.get_by_app_id(5), chans.get(2),
           sorted(ins.get_all(), key=lambda i: i.id), ins.get("ei1"),
           ins.get_completed("default", "0", "/e.json"),
           ins.get_latest_completed("default", "0", "/e.json"),
           ins.get_completed("default", "1", "/e.json"),
           mans.get_all(), mans.get("default", "0"), mans.get("ghost", "1"),
           sorted(evs.get_all(), key=lambda i: i.id), evs.get_completed(),
           evs.get("ev1")]
    return [repr(x) for x in out]


def test_metadata_daos_answer_as_the_references(tmp_path):
    got = {}
    for pkg in PKGS:
        c = client(pkg, tmp_path / pkg)
        got[pkg] = [repr(x) for x in write_all(pkg, c)] + read_all(c)
        c.close()
    assert got["jax"] == got["port"]
    for kind in KINDS:
        logs = [(tmp_path / pkg / "dix" / "pio_meta" / f"{kind}.log"
                 ).read_bytes() for pkg in PKGS]
        assert logs[0] == logs[1] and logs[0], kind


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_index_is_read_by_the_other_package(writer, tmp_path):
    reader = "port" if writer == "jax" else "jax"
    c = client(writer, tmp_path)
    write_all(writer, c)
    want = read_all(c)
    c.close()
    c2 = client(reader, tmp_path)
    assert read_all(c2) == want
    # and the reader goes on writing where the writer stopped
    B = PKGS[reader]["base"]
    assert c2.get_data_object("apps", "pio_meta").insert(
        B.App(0, "after")) == 7
    c2.close()


def test_registry_metadata_on_docindex(tmp_path, monkeypatch):
    """METADATA on a `docindex` source through both registries: an app
    the JAX registry created is found through the port's."""
    for k in [k for k in list(os.environ)
              if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "DIX")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_DIX_TYPE", "docindex")
    try:
        JReg.clear_cache()
        aid = JReg.Storage.get_meta_data_apps().insert(JB.App(0, "x"))
        JReg.clear_cache()
        TReg.clear_cache()
        assert TReg.Storage.config_summary()["METADATA"] == "docindex"
        assert TReg.Storage.get_meta_data_apps().get_by_name("x").id == aid
        assert (tmp_path / "pio" / "docindex" / "pio_meta" /
                "apps.log").exists()
    finally:
        JReg.clear_cache()
        TReg.clear_cache()
