"""Port parity: nativelog shard snapshots (`data/storage/snapshot.py` and
`snapshot create|restore|list` of the CLI).

The JAX package's `tests/test_snapshot.py` cases run for both packages,
each on a 4-partition nativelog EVENTDATA source of its own: a round trip
into another app (a tombstone kept), the refusal of a non-empty namespace
and `force`, a legacy file of the namespace replaced too, a checksum
mismatch and a partition mismatch refused, a torn tail shipped and
repaired, the CLI's verbs and exit codes, and `SnapshotError` where
EVENTDATA is not nativelog. Each case holds the two packages' answers
equal where they are data (events as wire dicts, manifests without
their creation stamp, the CLI's lines). Then snapshots cross packages: one
package takes it, the other restores it, in both directions, and the
restored app reads back event for event. Nothing here has a tolerance.
"""

import datetime as dt
import json
import os

import pytest

from predictionio_tpu.data import datamap as JDM
from predictionio_tpu.data import event as JE
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage import snapshot as JS
from predictionio_tpu.tools import cli as JCli
from predictionio_tpu_torch.data import datamap as TDM
from predictionio_tpu_torch.data import event as TE
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage import snapshot as TS
from predictionio_tpu_torch.tools import cli as TCli

PKGS = {"jax": dict(event=JE, dm=JDM, reg=JReg, snap=JS, cli=JCli),
        "port": dict(event=TE, dm=TDM, reg=TReg, snap=TS, cli=TCli)}
both = pytest.mark.parametrize("pkg", list(PKGS))
CREATED = dt.datetime(2026, 2, 1, tzinfo=dt.timezone.utc)


def t(sec):
    return dt.datetime(2015, 1, 1, 0, 0, sec, tzinfo=dt.timezone.utc)


def mk(pkg, eid, sec, rating=3.0):
    m = PKGS[pkg]
    return m["event"].Event(
        event="rate", entity_type="user", entity_id=eid,
        target_entity_type="item", target_entity_id=f"i{sec}",
        event_time=t(sec % 60), creation_time=CREATED,
        properties=m["dm"].DataMap({"rating": rating}))


def set_env(monkeypatch, root, plog="plog", partitions=4):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(root / "pio"))
    for repo, src in (("METADATA", "SQLITE"), ("EVENTDATA", "NLOG"),
                      ("MODELDATA", "LOCALFS")):
        monkeypatch.setenv(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", src)
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SQLITE_TYPE", "sqlite")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SQLITE_URL",
                       str(root / "pio" / "pio.db"))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LOCALFS_TYPE", "localfs")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_LOCALFS_HOSTS",
                       str(root / "pio" / "models"))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NLOG_TYPE", "nativelog")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NLOG_PATH", str(root / plog))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NLOG_PARTITIONS",
                       str(partitions))


@pytest.fixture
def nl(tmp_path, monkeypatch):
    """A function `use(pkg)` that points the environment at `pkg`'s own
    4-partition nativelog store under tmp_path/pkg and returns its events
    DAO (both registries' caches cleared)."""
    for k in [k for k in list(os.environ) if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)

    def use(pkg, root=None, **kw):
        for reg in (JReg, TReg):
            reg.clear_cache()
        root = root or tmp_path / pkg
        set_env(monkeypatch, root, **kw)
        return PKGS[pkg]["reg"].Storage.get_events()
    yield use
    for reg in (JReg, TReg):
        reg.clear_cache()


def wire(events):
    return sorted((e.to_dict() for e in events), key=lambda d: d["eventId"])


def without_stamp(m):
    return {k: v for k, v in m.items() if k != "created"}


@both
def test_create_restore_other_app(pkg, nl, tmp_path):
    ev = nl(pkg)
    S = PKGS[pkg]["snap"]
    ev.init(1)
    ids = ev.insert_batch([mk(pkg, f"u{i}", i).with_id(f"e{i}")
                           for i in range(120)], 1)
    ev.delete(ids[5], 1)   # the tombstone survives the round trip
    uri = f"file://{tmp_path}/backups_{pkg}"
    m = S.create_snapshot(1, uri, name="snap1")
    assert m["partitions"] == 4 and len(m["files"]) == 4
    S.restore_snapshot(uri, "snap1", app_id=2)
    src, dst = wire(ev.find(1)), wire(ev.find(2))
    assert len(src) == 119 and src == dst
    assert ev.get(ids[5], 2) is None


def test_both_packages_ship_the_same_manifest(nl, tmp_path):
    """The same events make the same shard files, names, sizes and
    digests in both packages' manifests."""
    got = {}
    for pkg in PKGS:
        ev = nl(pkg)
        ev.init(1)
        ev.insert_batch([mk(pkg, f"u{i}", i).with_id(f"e{i}")
                         for i in range(64)], 1)
        got[pkg] = without_stamp(PKGS[pkg]["snap"].create_snapshot(
            1, f"file://{tmp_path}/b_{pkg}", name="s"))
        assert PKGS[pkg]["snap"].read_manifest(
            f"file://{tmp_path}/b_{pkg}", "s")["files"] == got[pkg]["files"]
    assert got["jax"] == got["port"]
    assert [f["file"] for f in got["port"]["files"]] == \
        [f"events_1_0_p{k}.log" for k in range(4)]


@both
def test_restore_refuses_nonempty_then_force(pkg, nl, tmp_path):
    ev = nl(pkg)
    S = PKGS[pkg]["snap"]
    ev.init(1)
    ev.insert_batch([mk(pkg, f"u{i}", i) for i in range(20)], 1)
    uri = f"file://{tmp_path}/backups"
    S.create_snapshot(1, uri, name="snap1")
    ev.insert(mk(pkg, "after", 59), 1)
    with pytest.raises(S.SnapshotError, match="--force"):
        S.restore_snapshot(uri, "snap1")
    S.restore_snapshot(uri, "snap1", force=True)
    found = list(ev.find(1))
    assert len(found) == 20       # the write after the snapshot is gone
    assert not any(e.entity_id == "after" for e in found)


@both
def test_restore_replaces_legacy_file_too(pkg, nl, tmp_path):
    """Restore replaces every live file of the namespace, a
    pre-partitioning legacy log the snapshot does not name included."""
    ev = nl(pkg)
    S = PKGS[pkg]["snap"]
    nlmod = type(ev).__module__
    _hash = __import__(nlmod, fromlist=["_hash"])._hash
    ev.init(1)
    ev.insert_batch([mk(pkg, f"u{i}", i) for i in range(10)], 1)
    uri = f"file://{tmp_path}/backups"
    S.create_snapshot(1, uri, name="s")
    # app 9's legacy (unpartitioned) log, built through the C library as
    # an upgrade from a pre-partitioning store leaves it
    legacy = os.path.join(ev.root, "events_9_0.log")
    h = ev.lib.el_open(legacy.encode())
    e = mk(pkg, "uL", 1).with_id("Lid")
    payload = json.dumps(e.to_dict()).encode()
    ev.lib.el_append(h, b"Lid", 3, payload, len(payload), 1000,
                     _hash(ev.lib, "user\x00uL"), _hash(ev.lib, "rate"), 0)
    ev.lib.el_flush(h)
    ev.lib.el_close(h)
    assert any(x.entity_id == "uL" for x in ev.find(9))
    with pytest.raises(S.SnapshotError, match="--force"):
        S.restore_snapshot(uri, "s", app_id=9)
    S.restore_snapshot(uri, "s", app_id=9, force=True)
    got = list(ev.find(9))
    assert len(got) == 10 and not any(x.entity_id == "uL" for x in got)


@both
def test_checksum_mismatch_refused(pkg, nl, tmp_path):
    ev = nl(pkg)
    S = PKGS[pkg]["snap"]
    ev.init(1)
    ev.insert_batch([mk(pkg, f"u{i}", i) for i in range(20)], 1)
    uri = f"file://{tmp_path}/backups"
    m = S.create_snapshot(1, uri, name="snap1")
    blob = tmp_path / "backups" / "snapshots" / "snap1" / \
        m["files"][0]["file"]
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    with pytest.raises(S.SnapshotError, match="checksum"):
        S.restore_snapshot(uri, "snap1", app_id=3)
    assert list(ev.find(3)) == []      # nothing was written


@both
def test_partition_mismatch_refused(pkg, nl, tmp_path):
    ev = nl(pkg)
    S = PKGS[pkg]["snap"]
    ev.init(1)
    ev.insert_batch([mk(pkg, f"u{i}", i) for i in range(8)], 1)
    uri = f"file://{tmp_path}/backups"
    S.create_snapshot(1, uri, name="snap1")
    nl(pkg, root=tmp_path / pkg, plog="plog2", partitions=2)
    with pytest.raises(S.SnapshotError, match="PARTITIONS"):
        S.restore_snapshot(uri, "snap1")


@both
def test_torn_tail_snapshot_restores_complete_records(pkg, nl, tmp_path):
    """A process killed mid-append leaves a torn record at a shard's
    tail; the snapshot ships it as it is and the restored store's open
    path repairs it: every earlier record reads, the store is writable."""
    ev = nl(pkg)
    S = PKGS[pkg]["snap"]
    ev.init(1)
    ev.insert_batch([mk(pkg, f"u{i}", i) for i in range(40)], 1)
    path = ev._path_of(1, None, ev._write_part(mk(pkg, "u3", 3)))
    ev.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 5)
    ev2 = nl(pkg)
    n_after_crash = len(list(ev2.find(1)))
    assert n_after_crash == 39
    uri = f"file://{tmp_path}/backups"
    S.create_snapshot(1, uri, name="postcrash")
    S.restore_snapshot(uri, "postcrash", app_id=9)
    assert len(list(ev2.find(9))) == n_after_crash
    ev2.insert(mk(pkg, "postrestore", 58), 9)
    assert len(list(ev2.find(9))) == n_after_crash + 1


def cli(pkg, capsys, *args):
    rc = PKGS[pkg]["cli"].main(list(args))
    return rc, capsys.readouterr().out


def test_cli_create_list_restore(nl, tmp_path, capsys):
    """The CLI's verbs print the reference's lines and exit codes on the
    same store (the snapshot stamp and URI aside)."""
    said = {}
    for pkg in PKGS:
        ev = nl(pkg)
        ev.init(1)
        ev.insert_batch([mk(pkg, f"u{i}", i).with_id(f"e{i}")
                         for i in range(15)], 1)
        uri = f"file://{tmp_path}/backups_{pkg}"
        rows = [cli(pkg, capsys, "snapshot", "create", "--appid", "1",
                    "--uri", uri, "--name", "cli1"),
                cli(pkg, capsys, "snapshot", "list", "--uri", uri),
                cli(pkg, capsys, "snapshot", "restore", "--uri", uri,
                    "--name", "cli1", "--appid", "4")]
        assert len(list(ev.find(4))) == 15
        rows += [cli(pkg, capsys, "snapshot", "restore", "--uri", uri,
                     "--name", "cli1", "--appid", "4"),
                 cli(pkg, capsys, "snapshot", "restore", "--uri", uri,
                     "--name", "cli1", "--appid", "4", "--force"),
                 cli(pkg, capsys, "snapshot", "list", "--uri",
                     f"file://{tmp_path}/nothing_{pkg}"),
                 cli(pkg, capsys, "snapshot", "list", "--uri",
                     "nosuch://h/x")]
        said[pkg] = [(rc, out.replace(uri, "URI").replace(pkg, "PKG").split(
            "created=")[0]) for rc, out in rows]
    assert said["jax"] == said["port"]
    assert [rc for rc, _ in said["port"]] == [0, 0, 0, 1, 0, 0, 1]
    assert said["port"][0][1] == \
        "Snapshot cli1 created: 4 file(s), " + \
        said["port"][0][1].split("file(s), ")[1]


@both
def test_cli_wrong_backend_fails_cleanly(pkg, tmp_path, monkeypatch, capsys):
    for k in [k for k in list(os.environ) if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    PKGS[pkg]["reg"].clear_cache()
    try:
        rc, out = cli(pkg, capsys, "snapshot", "create", "--appid", "1",
                      "--uri", f"file://{tmp_path}/backups")
        assert rc == 1 and out.startswith(
            "Snapshot failed: pio snapshot requires the nativelog event "
            "store (EVENTDATA backend is SQLEvents)")
    finally:
        PKGS[pkg]["reg"].clear_cache()


@pytest.mark.parametrize("taker", ["jax", "port"])
def test_a_snapshot_is_restored_by_the_other_package(taker, nl, tmp_path):
    """One package takes the snapshot, the other restores it into a fresh
    store (another app id), and both packages read the restored app back
    event for event; the manifest's keys are the reference's."""
    restorer = "port" if taker == "jax" else "jax"
    ev = nl(taker)
    ev.init(3)
    ids = ev.insert_batch([mk(taker, f"u{i}", i).with_id(f"e{i}")
                           for i in range(90)], 3)
    ev.delete(ids[7], 3)
    want = wire(ev.find(3))
    uri = f"file://{tmp_path}/shared"
    m = PKGS[taker]["snap"].create_snapshot(3, uri, name="xpkg")
    assert sorted(m) == ["app_id", "channel_id", "created", "files", "name",
                         "partitions"]
    ev2 = nl(restorer, root=tmp_path / "fresh")
    assert without_stamp(PKGS[restorer]["snap"].read_manifest(uri, "xpkg")
                         ) == without_stamp(m)
    PKGS[restorer]["snap"].restore_snapshot(uri, "xpkg", app_id=11)
    assert wire(ev2.find(11)) == want
    assert [x["name"] for x in PKGS[restorer]["snap"].list_snapshots(uri)] \
        == ["xpkg"]
    ev3 = nl(taker, root=tmp_path / "fresh")
    assert wire(ev3.find(11)) == want
