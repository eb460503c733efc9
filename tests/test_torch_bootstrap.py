"""Port parity: the snapshot bootstrap (`dataplane/bootstrap.py`) and the
`bootstrap` command, against the JAX package's, on the CPU.

The two bootstrap cases of tests/test_dataplane.py run on the port, each
package on a 4-partition nativelog store of its own seeded with the same
32 rate events (8 users, 8 items; rank 4, 3 iterations, lam 0.1, seed 7):

- no tail: the bootstrapped tenant's tables are bit-equal to a batch
  train of the same store, its read streamed (32 rows), no catch-up;
- a tail of 4 events written in `on_restored` is folded before
  admission, the fresh user answers, the gates are back on; the port's
  tables are within 1e-4 of the JAX bootstrap's, row by row by id (the
  ROADMAP's parity note at lam 0.1: the two packages' solves round
  apart), and both count the same catch-up events and folds.

Then `python -m predictionio_tpu_torch bootstrap` runs as the reference's
command does: the report line alone, and `--serve --port 0` as a
subprocess whose host answers the tenant's queries and exits 0 on
SIGTERM.
"""

import datetime as dt
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.data import datamap as JDM
from predictionio_tpu.data import event as JE
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.storage import snapshot as JS
from predictionio_tpu.data.storage.base import App as JApp
from predictionio_tpu.dataplane import bootstrap as JB
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.tenancy import HostConfig as JHostConfig
from predictionio_tpu.tenancy import ServingHost as JServingHost
from predictionio_tpu_torch.core import EngineParams as TEngineParams
from predictionio_tpu_torch.data import datamap as TDM
from predictionio_tpu_torch.data import event as TE
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage import snapshot as TS
from predictionio_tpu_torch.data.storage.base import App as TApp
from predictionio_tpu_torch.dataplane import bootstrap as TB
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.tenancy import HostConfig, ServingHost
from predictionio_tpu_torch.tools import cli as TCli
from predictionio_tpu_torch.workflow.core_workflow import run_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
APP = "bootapp"
PKGS = {"jax": dict(event=JE, dm=JDM, reg=JReg, snap=JS, app=JApp, boot=JB,
                    R=JR, params=JEngineParams,
                    host=(JServingHost, JHostConfig)),
        "torch": dict(event=TE, dm=TDM, reg=TReg, snap=TS, app=TApp,
                      boot=TB, R=TR, params=TEngineParams,
                      host=(ServingHost, HostConfig))}


def set_env(monkeypatch, root):
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
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NLOG_PATH", str(root / "plog"))
    monkeypatch.setenv("PIO_STORAGE_SOURCES_NLOG_PARTITIONS", "4")


@pytest.fixture
def nl(tmp_path, monkeypatch, mesh8):
    """`use(pkg)` points the environment at `pkg`'s own nativelog store
    under tmp_path/pkg (both registries' caches cleared)."""
    for k in [k for k in list(os.environ) if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(k)

    def use(pkg):
        for reg in (JReg, TReg):
            reg.clear_cache()
        set_env(monkeypatch, tmp_path / pkg)
        return tmp_path / pkg
    yield use
    for reg in (JReg, TReg):
        reg.clear_cache()


def params(pkg):
    R = PKGS[pkg]["R"]
    if pkg == "jax":
        ds = R.DataSourceParams(app_name=APP)
        algo = R.ALSAlgorithmParams(rank=4, num_iterations=3, lam=0.1,
                                    seed=7)
    else:
        ds = R.DataSourceParams(app_name=APP, device="cpu")
        algo = R.ALSAlgorithmParams(rank=4, num_iterations=3, lam=0.1,
                                    seed=7, device="cpu")
    return PKGS[pkg]["params"](
        data_source_params=("", ds),
        preparator_params=("", R.PreparatorParams()),
        algorithm_params_list=[("als", algo)], serving_params=("", None))


def t_ms(k):
    return dt.datetime(2021, 3, 1, tzinfo=dt.timezone.utc) \
        + dt.timedelta(milliseconds=k)


def seed(pkg):
    """The reference's 32 rate events into app `bootapp`."""
    m = PKGS[pkg]
    Storage = m["reg"].Storage
    app_id = Storage.get_meta_data_apps().insert(m["app"](0, APP))
    ev = Storage.get_events()
    ev.init(app_id)
    ev.insert_batch([m["event"].Event(
        event="rate", entity_type="user", entity_id=f"u{u}",
        target_entity_type="item", target_entity_id=f"i{i}",
        event_time=t_ms(u * 31 + i),
        properties=m["dm"].DataMap({"rating": float(1 + (u * i) % 5)}))
        for u in range(8) for i in range(8) if (u + i) % 2 == 0], app_id)
    return app_id, ev


def factors(model):
    """{user id: row}, {item id: row} of a recommendation model."""
    users = model.user_ix.ids_of(range(len(model.user_ix)))
    items = model.item_ix.ids_of(range(len(model.item_ix)))
    U = np.asarray(model.als.user_factors, np.float64)
    V = np.asarray(model.als.item_factors, np.float64)
    return dict(zip(users, U)), dict(zip(items, V))


def test_exact_parity_vs_full_live_train(nl, tmp_path):
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    nl("torch")
    app_id, _ = seed("torch")
    uri = f"file://{tmp_path}/backups"
    TS.create_snapshot(app_id, uri, name="snap")
    host = ServingHost(HostConfig(ip="127.0.0.1", port=0))
    try:
        report = TB.bootstrap_from_snapshot(
            "t1", uri, "snap", TR.RecommendationEngineFactory.apply(),
            params("torch"), host=host, engine_factory="recommendation",
            force=True)
        assert report.admitted and report.catchup_events == 0
        assert report.load is not None          # streamed, not batch
        assert report.load.rows == 32 and report.load.steady_compiles == 0
        assert report.restored_files == 4
        boot = host.slots["t1"].server.models[0]
        iid = run_train(TR.RecommendationEngineFactory.apply(),
                        params("torch"), engine_id="ref",
                        engine_variant="ref",
                        engine_factory="recommendation")
        ref = EngineServer(ServerConfig(
            ip="127.0.0.1", port=0, engine_id="ref", engine_version="0",
            engine_variant="ref", micro_batch=0),
            engine=TR.RecommendationEngineFactory.apply(),
            engine_params=params("torch")).load()
        assert ref.engine_instance.id == iid
        r = ref.models[0]
        assert list(boot.user_ix.ids) == list(r.user_ix.ids)
        assert list(boot.item_ix.ids) == list(r.item_ix.ids)
        assert np.array_equal(boot.als.user_factors, r.als.user_factors)
        assert np.array_equal(boot.als.item_factors, r.als.item_factors)
    finally:
        host.stop()


def test_tail_folded_before_admission_matches_jax(nl, tmp_path):
    got = {}
    for pkg in ("jax", "torch"):
        nl(pkg)
        m = PKGS[pkg]
        app_id, ev = seed(pkg)
        uri = f"file://{tmp_path}/backups_{pkg}"
        m["snap"].create_snapshot(app_id, uri, name="snap")
        def fresh(_manifest, m=m, app_id=app_id):
            # live ingestion into the restored namespace: after the
            # cutover, so the catch-up folds it
            now = dt.datetime.now(dt.timezone.utc)
            m["reg"].Storage.get_events().insert_batch([m["event"].Event(
                event="rate", entity_type="user", entity_id="fresh_u",
                target_entity_type="item", target_entity_id=f"i{i}",
                event_time=now, properties=m["dm"].DataMap({"rating": 5.0}))
                for i in range(4)], app_id)

        Host, Cfg = m["host"]
        host = Host(Cfg(ip="127.0.0.1", port=0))
        try:
            report = m["boot"].bootstrap_from_snapshot(
                "t2", uri, "snap", m["R"].RecommendationEngineFactory.apply(),
                params(pkg), host=host, engine_factory="recommendation",
                force=True, on_restored=fresh)
            assert report.admitted
            assert report.catchup_events == 4
            assert report.catchup_folds >= 1
            assert report.bootstrap_catchup_s > 0
            slot = host.slots["t2"]
            assert slot.scheduler.config.gates
            out = slot.server.handle_query({"user": "fresh_u", "num": 3})
            assert len(out["itemScores"]) > 0
            got[pkg] = (factors(slot.server.models[0]),
                        (report.catchup_events, report.catchup_folds,
                         report.restored_files, report.restored_bytes))
        finally:
            host.stop()
    (tu, tv), tmeta = got["torch"]
    (ju, jv), jmeta = got["jax"]
    assert tmeta == jmeta
    assert set(tu) == set(ju) and "fresh_u" in tu and set(tv) == set(jv)
    for port_rows, ref_rows in ((tu, ju), (tv, jv)):
        for k in ref_rows:
            assert np.abs(port_rows[k] - ref_rows[k]).max() <= TOL, k


def variant(path, app=APP):
    with open(path, "w") as f:
        json.dump({"id": "boot", "engineFactory": "recommendation",
                   "datasource": {"params": {"app_name": app,
                                             "device": "cpu"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": 4, "num_iterations": 3, "lam": 0.1,
                       "seed": 7, "device": "cpu"}}]}, f)


def test_cli_bootstrap_prints_the_report(nl, tmp_path, capsys):
    nl("torch")
    app_id, _ = seed("torch")
    uri = f"file://{tmp_path}/backups"
    TS.create_snapshot(app_id, uri, name="snap")
    path = str(tmp_path / "engine.json")
    variant(path)
    assert TCli.main(["bootstrap", "t3", "--snapshot", "snap", "--uri", uri,
                      "-v", path, "--force"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["tenant"] == "t3" and report["catchup_events"] == 0
    assert report["load"]["rows"] == 32 and not report["admitted"]
    assert report["kernel_launches"].get("cg_solve", 0) == 0
    assert set(report) >= {
        "tenant", "snapshot", "app_id", "app_name", "cutover",
        "restored_files", "restored_bytes", "restore_s",
        "engine_instance_id", "train_s", "load", "catchup_events",
        "catchup_folds", "bootstrap_catchup_s", "admitted"}
    assert TCli.main(["bootstrap", "t3", "--snapshot", "nope", "--uri",
                      uri, "-v", path, "--force"]) == 1
    assert capsys.readouterr().out.startswith("Bootstrap failed: ")


def test_cli_bootstrap_serve_answers_and_stops(nl, tmp_path):
    nl("torch")
    app_id, _ = seed("torch")
    uri = f"file://{tmp_path}/backups"
    TS.create_snapshot(app_id, uri, name="snap")
    path = str(tmp_path / "engine.json")
    variant(path)
    TReg.clear_cache()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch", "bootstrap", "t4",
         "--snapshot", "snap", "--uri", uri, "-v", path, "--force",
         "--serve", "--ip", "127.0.0.1", "--port", "0"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "serving host live at" in line:
                break
        assert lines and lines[-1].startswith(
            "Tenant 't4' admitted; serving host live at http://127.0.0.1:"), \
            "".join(lines)
        report = json.loads(lines[-2])
        assert report["admitted"] is True
        url = lines[-1].rsplit(" ", 1)[1].rstrip(".\n")
        req = urllib.request.Request(
            url + "/engines/t4/queries.json", method="POST",
            data=json.dumps({"user": "u1", "num": 3}).encode())
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert len(json.loads(resp.read())["itemScores"]) == 3
        with urllib.request.urlopen(url + "/placement.json",
                                    timeout=30) as resp:
            plc = json.loads(resp.read())
        assert plc["tenants"]["t4"]["engineId"] == "boot"
        assert plc["tenants"]["t4"]["scheduler"] is True
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
