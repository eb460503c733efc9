"""Port parity: engine manifests (the EngineManifests DAO) on every backend
that stores them, and the storage facade's accessor.

The same calls, with the same records, go to the JAX package's DAO and to
the port's, each on a store of its own: sqlite, memory, docindex, pgsql
and mysql. The SQL dialects run their own statements on an embedded
SQLite database (`SQLiteWire`, a connection with the wire clients'
`execute` shape: `$n` placeholders become SQLite's `?n`, and MySQL's
`ON DUPLICATE KEY UPDATE col=VALUES(col)` becomes SQLite's `ON CONFLICT
DO UPDATE SET col=excluded.col`), so an upsert, a missing row and a
delete's row count behave as a server's would. Results are held equal by
their repr (the records are frozen dataclasses of the same name and
fields): nothing here has a tolerance. Then the cross-reads: a store of
sqlite or docindex one package wrote is read back by the other.
"""

import os
import re
import sqlite3

import pytest

from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import docindex as JDoc
from predictionio_tpu.data.storage import memory as JMem
from predictionio_tpu.data.storage import mysql as JMy
from predictionio_tpu.data.storage import pgsql as JPG
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage import sqlite as JSql
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import docindex as TDoc
from predictionio_tpu_torch.data.storage import memory as TMem
from predictionio_tpu_torch.data.storage import mysql as TMy
from predictionio_tpu_torch.data.storage import pgsql as TPG
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage import sqlite as TSql

PKGS = {
    "jax": dict(base=JB, reg=JReg, sqlite=JSql, memory=JMem, docindex=JDoc,
                pgsql=JPG, mysql=JMy),
    "port": dict(base=TB, reg=TReg, sqlite=TSql, memory=TMem, docindex=TDoc,
                 pgsql=TPG, mysql=TMy),
}
BACKENDS = ("sqlite", "memory", "docindex", "pgsql", "mysql")

_DOLLAR = re.compile(r"\$(\d+)")
_MY_UPSERT = re.compile(r"ON DUPLICATE KEY UPDATE (.*)$", re.S)


class _Result:
    def __init__(self, rows, rowcount, lastrowid):
        self.rows = rows
        self.rowcount = len(rows) if rows else rowcount
        self.last_insert_id = lastrowid or 0


class SQLiteWire:
    """A wire connection's `execute(sql, params)` over embedded SQLite, for
    the pgsql and mysql DAOs: the statements they send run as written,
    but for the placeholder style and MySQL's upsert clause."""

    def __init__(self, path):
        self.db = sqlite3.connect(path, check_same_thread=False)
        self.statements = []

    def execute(self, sql, params=()):
        self.statements.append((sql, tuple(params)))
        m = _MY_UPSERT.search(sql)
        if m:
            sets = re.sub(r"(\w+)=VALUES\((\w+)\)", r"\1=excluded.\2",
                          m.group(1))
            sql = sql[:m.start()] + "ON CONFLICT DO UPDATE SET " + sets
        cur = self.db.execute(_DOLLAR.sub(r"?\1", sql), tuple(params))
        rows = [tuple(r) for r in cur.fetchall()]
        self.db.commit()
        return _Result(rows, cur.rowcount, cur.lastrowid)

    def close(self):
        self.db.close()


def client_of(pkg, backend, root):
    """`pkg`'s StorageClient for `backend`, its store under `root`."""
    m = PKGS[pkg]
    cfg = m["reg"].StorageClientConfig
    if backend == "sqlite":
        return m["sqlite"].StorageClient(cfg("T", "sqlite",
                                             {"URL": str(root / "pio.db")}))
    if backend == "memory":
        return m["memory"].StorageClient(cfg("T", "memory", {}))
    if backend == "docindex":
        return m["docindex"].StorageClient(cfg("T", "docindex",
                                               {"PATH": str(root / "dix")}))
    return m[backend].StorageClient(cfg("T", backend, {}),
                                    conn=SQLiteWire(str(root / "sql.db")))


@pytest.fixture(params=BACKENDS)
def pair(request, tmp_path):
    clients = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        clients[pkg] = client_of(pkg, request.param, tmp_path / pkg)
    yield request.param, clients
    for c in clients.values():
        c.close()


def manifests(B, n=3):
    return [B.EngineManifest(f"engine{k % 2}", str(k), f"name {k}",
                             None if k == 0 else f"description {k}",
                             tuple(f"/engines/{k}/file{j}.json"
                                   for j in range(k)),
                             "recommendation" if k % 2 else "similarproduct")
            for k in range(n)]


def run_calls(pkg, dao):
    """The manifest DAO's every method, in the reference's contract: an
    insert overwrites, an update without upsert skips a missing row, a
    second delete finds nothing."""
    B = PKGS[pkg]["base"]
    ms = manifests(B)
    out = []
    for m in ms:
        out.append(dao.insert(m))
    out.append(dao.get("engine0", "0"))
    out.append(dao.get("engine1", "1"))
    out.append(dao.get("engine1", "0"))
    out.append(sorted(dao.get_all(), key=lambda m: (m.id, m.version)))
    ghost = B.EngineManifest("ghost", "9", "ghost")
    out.append(dao.update(ghost))
    out.append(dao.get("ghost", "9"))
    out.append(dao.update(ghost, upsert=True))
    out.append(dao.get("ghost", "9"))
    renamed = B.EngineManifest("engine0", "2", "renamed", "new",
                               ("/a.json",), "ecommerce")
    out.append(dao.update(renamed))
    out.append(dao.get("engine0", "2"))
    out.append(dao.insert(B.EngineManifest("engine1", "1", "again")))
    out.append(dao.get("engine1", "1"))
    out.append(dao.delete("engine0", "0"))
    out.append(dao.delete("engine0", "0"))
    out.append(dao.get("engine0", "0"))
    out.append(sorted(dao.get_all(), key=lambda m: (m.id, m.version)))
    return [repr(x) for x in out]


def test_manifest_dao_parity(pair):
    backend, clients = pair
    got = {pkg: run_calls(pkg, c.get_data_object("engine_manifests", "ns"))
           for pkg, c in clients.items()}
    assert got["jax"] == got["port"]
    assert "renamed" in "".join(got["port"])


@pytest.mark.parametrize("backend", ["pgsql", "mysql"])
def test_sql_dialects_send_the_references_statements(backend, tmp_path):
    """The same calls send the same (SQL, params) sequence through both
    packages' dialect, the table's DDL included."""
    sent = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        c = client_of(pkg, backend, tmp_path / pkg)
        run_calls(pkg, c.get_data_object("engine_manifests", "ns"))
        sent[pkg] = c.conn.statements
        c.close()
    assert sent["jax"] == sent["port"]
    assert any("enginemanifests" in sql for sql, _ in sent["port"])


@pytest.mark.parametrize("backend", ["sqlite", "docindex"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_manifest_store_is_read_by_the_other_package(backend, writer,
                                                       tmp_path):
    reader = "port" if writer == "jax" else "jax"
    w = client_of(writer, backend, tmp_path)
    wdao = w.get_data_object("engine_manifests", "pio_meta")
    for m in manifests(PKGS[writer]["base"], 4):
        wdao.insert(m)
    wdao.delete("engine1", "3")
    w.close()
    r = client_of(reader, backend, tmp_path)
    rdao = r.get_data_object("engine_manifests", "pio_meta")
    want = [repr(m) for m in manifests(PKGS[reader]["base"], 3)]
    assert sorted(repr(m) for m in rdao.get_all()) == sorted(want)
    assert repr(rdao.get("engine0", "2")) == want[2]
    r.close()


@pytest.fixture()
def storage_env(tmp_path, monkeypatch):
    for k in [k for k in list(os.environ)
              if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    for reg in (JReg, TReg):
        reg.clear_cache()
    yield tmp_path
    for reg in (JReg, TReg):
        reg.clear_cache()


@pytest.mark.parametrize("backend", BACKENDS)
def test_storage_facade_hands_out_engine_manifests(backend, storage_env,
                                                   monkeypatch):
    """`Storage.get_meta_data_engine_manifests()` on a METADATA source of
    each type, through both packages' registries (the SQL dialects'
    connections made over embedded SQLite, as above)."""
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_METADATA_SOURCE", "META")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_META_TYPE", backend)
    if backend == "sqlite":
        monkeypatch.setenv("PIO_STORAGE_SOURCES_META_URL",
                           str(storage_env / "meta.db"))
    if backend == "docindex":
        monkeypatch.setenv("PIO_STORAGE_SOURCES_META_PATH",
                           str(storage_env / "dix"))
    got = {}
    for pkg, m in PKGS.items():
        if backend in ("pgsql", "mysql"):
            db = str(storage_env / f"{pkg}.db")
            monkeypatch.setattr(m[backend], "connect_from_env",
                                lambda *a, _db=db, **kw: SQLiteWire(_db))
        dao = m["reg"].Storage.get_meta_data_engine_manifests()
        assert isinstance(dao, m["base"].EngineManifests)
        dao.insert(m["base"].EngineManifest("e", "1", "n", None, ("f",),
                                            "recommendation"))
        got[pkg] = repr(dao.get_all())
        m["reg"].clear_cache()
    assert got["jax"] == got["port"]
