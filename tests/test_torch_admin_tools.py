"""Port parity: the tools of this slice, against the JAX package's on the
same store.

`build` and `unregister` (the engine manifest registered and removed,
the reference's lines and exit codes), `servers` (concurrent probes, the
mesh note read from /stats.json), `run` and `upgrade` go through both
packages' `cli.main` on one SQLite store (the `tmp_env` fixture) and
print the same lines. The dashboards of both packages serve the same
index, result pages (txt, html, json) and 404s for the same evaluation
instances, the same `/telemetry` tables for the same servers' /stats.json
(their own process registries aside), and `/metrics`, `/traces.json`,
`/flight.json` and `/fleet/*`; the admin servers answer the same
`/cmd/app` routes with the same codes and bodies (the minted keys aside),
and an app one creates is listed by the other. `dashboard` and
`adminserver` also run as `python -m predictionio_tpu_torch`
subprocesses, print their line, serve, and exit 0 on SIGTERM.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.tools import admin as JAdmin
from predictionio_tpu.tools import cli as JCli
from predictionio_tpu.tools import dashboard as JDash
from predictionio_tpu.utils import http as JHttp
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.tools import admin as TAdmin
from predictionio_tpu_torch.tools import cli as TCli
from predictionio_tpu_torch.tools import dashboard as TDash

PKGS = {"jax": dict(base=JB, reg=JReg, cli=JCli, dash=JDash, admin=JAdmin),
        "port": dict(base=TB, reg=TReg, cli=TCli, dash=TDash, admin=TAdmin)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def store(tmp_env):
    """One SQLite/localfs store both packages' registries read."""
    TReg.clear_cache()
    yield tmp_env
    TReg.clear_cache()


def cli(pkg, capsys, *args):
    rc = PKGS[pkg]["cli"].main(list(args))
    return rc, capsys.readouterr().out


def call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            ct = resp.headers.get("Content-Type", "")
            data = resp.read()
            return resp.status, ct, (json.loads(data) if "json" in ct
                                     else data.decode())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), \
            json.loads(e.read() or b"null")


VARIANT = {"id": "default", "version": "3",
           "engineFactory": "recommendation",
           "description": "the smoke's recommender",
           "datasource": {"params": {"app_name": "x"}},
           "algorithms": [{"name": "als", "params": {"rank": 5}}]}


def test_build_and_unregister(store, tmp_path, capsys):
    vf = tmp_path / "engine.json"
    vf.write_text(json.dumps(VARIANT))
    said = {}
    for pkg in PKGS:
        said[pkg] = [cli(pkg, capsys, "build", "--engine-json", str(vf))]
        manifests = {p: [repr(x) for x in PKGS[p]["reg"].Storage
                         .get_meta_data_engine_manifests().get_all()]
                     for p in PKGS}
        assert manifests["jax"] == manifests["port"] and \
            len(manifests["port"]) == 1
        said[pkg] += [cli(pkg, capsys, "unregister", "-v", str(vf)),
                      cli(pkg, capsys, "unregister", "-v", str(vf))]
    assert said["jax"] == said["port"]
    assert said["port"] == [
        (0, "Engine recommendation is valid. Registered manifest default "
            "3. Build finished successfully.\n"),
        (0, "Unregistered engine default 3.\n"),
        (1, "Engine default 3 is not registered.\n")]
    # the port's manifest, read through the JAX registry
    TCli.main(["build", "--engine-json", str(vf)])
    capsys.readouterr()
    assert repr(JReg.Storage.get_meta_data_engine_manifests().get(
        "default", "3")) == repr(JB.EngineManifest(
            "default", "3", "default", "the smoke's recommender",
            (str(vf),), "recommendation"))


def test_build_refuses_what_the_reference_refuses(store, tmp_path, capsys):
    nofactory = tmp_path / "nofactory.json"
    nofactory.write_text(json.dumps({"datasource": {}}))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"engineFactory": "nope"}))
    badparams = tmp_path / "badparams.json"
    badparams.write_text(json.dumps(
        {"engineFactory": "recommendation",
         "algorithms": [{"name": "no-such-algorithm", "params": {}}]}))
    for pkg in PKGS:
        assert cli(pkg, capsys, "build", "-v", str(nofactory)) == \
            (1, "engineFactory missing in engine.json\n")
        with pytest.raises(KeyError):
            PKGS[pkg]["cli"].main(["build", "-v", str(bad)])
        with pytest.raises(Exception):
            PKGS[pkg]["cli"].main(["build", "-v", str(badparams)])
        assert PKGS[pkg]["reg"].Storage.get_meta_data_engine_manifests(
        ).get_all() == []


def test_run_and_upgrade(store, tmp_path, capsys):
    script = tmp_path / "main.py"
    script.write_text(
        "import sys\nprint('argv', sys.argv[1:], __name__)\n")
    said = {pkg: [cli(pkg, capsys, "run", str(script), "a", "b"),
                  cli(pkg, capsys, "upgrade")] for pkg in PKGS}
    assert said["jax"] == said["port"]
    assert said["port"][0] == (0, "argv ['a', 'b'] __main__\n")
    assert said["port"][1][1].endswith(
        ": offline build; no upgrade channel configured.\n")


class StubServer:
    """An engine or event server's read routes, with fixed bodies."""

    def __init__(self, stats):
        r = JHttp.Router()
        r.add("GET", "/", lambda req: JHttp.Response(200, {"ok": True}))
        r.add("GET", "/stats.json", lambda req: JHttp.Response(200, stats))
        r.add("GET", "/traces.json", lambda req: JHttp.Response(200, {
            "traces": [{"kind": "query", "traceId": "00aa",
                        "durationMs": 3.5, "links": [1]}]}))
        r.add("GET", "/slow.json", lambda req: JHttp.Response(200, {
            "slow": [{"traceId": "00bb", "totalMs": 120.0, "stages": [
                {"stage": "queue_wait", "ms": 100.0},
                {"stage": "dispatch", "ms": 20.0}]}]}))
        self.http = JHttp.HttpServer(r, "127.0.0.1", 0)
        self.http.start()
        self.port = self.http.port

    def stop(self):
        self.http.stop()


ENGINE_STATS = {"requestCount": 12, "avgServingSec": 0.0125,
                "modelSwaps": 1, "modelVersion": "v1",
                "queryLatency": {"count": 12, "p50": 0.001, "p95": 0.002,
                                 "p99": 0.003},
                "batchWait": {"count": 4, "p50": 0.0005, "p95": 0.001,
                              "p99": 0.001}}
EVENT_STATS = {"currentWindow": {"count": 7,
                                 "byEvent": {"rate": 5, "buy": 2}}}


def started(pkg, kind, **kw):
    m = PKGS[pkg]
    if kind == "dash":
        return m["dash"].Dashboard(m["dash"].DashboardConfig(
            ip="127.0.0.1", port=0, **kw)).start()
    return m["admin"].AdminServer(m["admin"].AdminServerConfig(
        ip="127.0.0.1", port=0)).start()


def test_dashboards_serve_the_same_pages(store, monkeypatch, tmp_path):
    monkeypatch.setenv("PIO_FLEET_DIR", str(tmp_path / "fleet"))
    dao = TReg.Storage.get_meta_data_evaluation_instances()
    ids = [dao.insert(TB.EvaluationInstance(
        status="EVALCOMPLETED" if k else "INIT",
        evaluation_class=f"MyEval<{k}>",
        engine_params_generator_class="Gen",
        evaluator_results=f"score: 0.{k}",
        evaluator_results_html=f"<html>{k}</html>",
        evaluator_results_json=json.dumps({"score": k}))) for k in range(3)]
    engine, events = StubServer(ENGINE_STATS), StubServer(EVENT_STATS)
    dashes = {pkg: started(
        pkg, "dash", engine_url=f"http://127.0.0.1:{engine.port}",
        event_server_url=f"http://127.0.0.1:{events.port}")
        for pkg in PKGS}
    try:
        pages = {}
        for pkg, d in dashes.items():
            p = d.config.port
            got = [call(p, "GET", "/")]
            for iid in ids:
                for fmt in ("txt", "html", "json"):
                    got.append(call(
                        p, "GET",
                        f"/engine_instances/{iid}/evaluator_results.{fmt}"))
            got.append(call(p, "GET",
                            "/engine_instances/nope/evaluator_results.txt"))
            code, ct, page = call(p, "GET", "/telemetry")
            got.append((code, ct, page.split("<h2>This process")[0]))
            pages[pkg] = got
            code, ct, text = call(p, "GET", "/metrics")
            assert code == 200 and "pio_jax_compiles_total" in text, pkg
            for path in ("/traces.json", "/flight.json",
                         "/fleet/status.json", "/fleet/health.json",
                         "/fleet/traces.json?trace_id=00aa"):
                assert call(p, "GET", path)[0] == 200, (pkg, path)
            assert call(p, "GET", "/fleet/metrics")[0] == 200
        assert pages["jax"] == pages["port"]
        index = pages["port"][0][2]
        assert "MyEval&lt;1&gt;" in index and "MyEval&lt;0&gt;" not in index
        assert pages["port"][1][0] == 404          # not EVALCOMPLETED
        assert pages["port"][4][2] == "score: 0.1"
        assert pages["port"][6][2] == {"score": 1}
        assert pages["port"][-2][0] == 404
        telemetry = pages["port"][-1][2]
        for want in ("requestCount", "12", "event rate", "00aa",
                     "queue_wait 100.0ms → dispatch 20.0ms"):
            assert want in telemetry, want
        status = call(dashes["port"].config.port, "GET",
                      "/fleet/status.json")[2]
        assert "dashboard" in [m["role"] for m in status["members"]]
    finally:
        for d in dashes.values():
            d.stop()
        engine.stop()
        events.stop()


def use_db(monkeypatch, path):
    monkeypatch.setenv("PIO_STORAGE_SOURCES_SQLITE_URL", str(path))
    JReg.clear_cache()
    TReg.clear_cache()


def test_admin_servers_answer_the_same_routes(store, monkeypatch):
    servers = {pkg: started(pkg, "admin") for pkg in PKGS}
    try:
        seen = {}
        for pkg, s in servers.items():
            use_db(monkeypatch, store / f"{pkg}.db")   # ids from 1 in each
            p = s.config.port
            name = "adminapp"
            steps = [call(p, "GET", "/"),
                     call(p, "POST", "/cmd/app", {"name": name,
                                                  "description": "d"}),
                     call(p, "POST", "/cmd/app", {"name": name}),
                     call(p, "POST", "/cmd/app", {"id": 3}),
                     call(p, "GET", "/cmd/app"),
                     call(p, "DELETE", f"/cmd/app/{name}/data"),
                     call(p, "DELETE", f"/cmd/app/{name}"),
                     call(p, "DELETE", f"/cmd/app/{name}"),
                     call(p, "DELETE", "/cmd/app/ghost/data"),
                     call(p, "GET", "/cmd/app")]
            for code, ct, body in steps:
                if isinstance(body, dict):
                    body.pop("key", None)
                    for a in body.get("apps", ()):
                        a["accessKeys"] = len(a["accessKeys"])
            seen[pkg] = steps
        assert seen["jax"] == seen["port"]
        assert [c for c, _, _ in seen["port"]] == \
            [200, 200, 409, 400, 200, 200, 200, 404, 404, 200]
        # an app the port's server creates is listed by the JAX server's
        use_db(monkeypatch, store / "shared.db")
        code, _, body = call(servers["port"].config.port, "POST",
                             "/cmd/app", {"name": "shared", "id": 41})
        assert code == 200 and body["id"] == 41
        listed = call(servers["jax"].config.port, "GET", "/cmd/app")[2]
        assert [(a["name"], a["id"], a["accessKeys"])
                for a in listed["apps"]] == [("shared", 41, [body["key"]])]
    finally:
        for s in servers.values():
            s.stop()


def test_servers_probes_and_the_mesh_note(store, capsys):
    plain = StubServer(ENGINE_STATS)
    healthy = StubServer({"meshCoordinator": {"processes": 4}})
    poisoned = StubServer({"meshCoordinator": {"poisoned": True}})
    admin = started("port", "admin")
    try:
        notes = {pkg: [PKGS[pkg]["cli"]._engine_mesh_note("127.0.0.1",
                                                          s.port)
                       for s in (plain, healthy, poisoned)]
                 + [PKGS[pkg]["cli"]._engine_mesh_note("127.0.0.1", 1)]
                 for pkg in PKGS}
        assert notes["jax"] == notes["port"] == [
            "", "  mesh 4p healthy", "  MESH POISONED — redeploy", ""]
        said = {}
        for pkg in PKGS:
            said[pkg] = [
                cli(pkg, capsys, "servers", "--event-server-port", "1",
                    "--engine-port", str(healthy.port), "--dashboard-port",
                    "1", "--admin-port", str(admin.config.port)),
                cli(pkg, capsys, "servers", "--event-server-port", "1",
                    "--engine-port", "1", "--dashboard-port", "1",
                    "--admin-port", "1")]
        assert said["jax"] == said["port"]
        rc, out = said["port"][0]
        assert rc == 0 and out.count("down") == 2
        assert f":{healthy.port:<6d} UP (200)  mesh 4p healthy" in out
        assert said["port"][1][0] == 1
    finally:
        admin.stop()
        for s in (plain, healthy, poisoned):
            s.stop()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("verb,line", [
    ("dashboard", "Dashboard is listening on http://127.0.0.1:{port}"),
    ("adminserver", "Admin server is listening on http://127.0.0.1:{port}")])
def test_the_servers_run_as_commands(verb, line, store, tmp_path):
    port = free_port()
    env = dict(os.environ, PIO_FLEET_DIR=str(tmp_path / "fleet"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch", verb, "--ip",
         "127.0.0.1", "--port", str(port)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        first = proc.stdout.readline().strip()
        assert first == line.format(port=port)
        deadline = time.time() + 30
        while True:
            try:
                code, _, _ = call(port, "GET", "/")
                break
            except OSError:
                assert time.time() < deadline and proc.poll() is None
                time.sleep(0.1)
        assert code == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
