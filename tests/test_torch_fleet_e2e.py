"""The port's fleet across OS processes, on the CPU (the counterpart of
`tests/test_fleet_e2e.py` and `tests/test_fleet_chaos.py`).

Topology: a child process runs the port's event server (`python -m
predictionio_tpu_torch eventserver --stats`); this process trains the
recommendation template on the same SQLite store, serves it in an
in-process engine server and folds through an attached scheduler. Both
processes are fleet members under one `base_dir()`.

- One event POSTed to the child mints an ingest trace in the child's
  pid; the fold tick here resolves it through the child's event map (a
  local miss), links it and hot-swaps; `fleet_traces`,
  `/fleet/traces.json` and the CLI's `fleet traces` stitch the child's
  `event_ingest` and this pid's `fold_tick` into one waterfall of two
  pids.
- `federate_metrics` and the child's `/fleet/metrics` carry samples of
  both pids; `fleet_health` rolls up both members' SLOs.
- Three processes (the child event server, a `deploy` and an `update
  --follow`, which registers as `scheduler`): one is SIGKILLed (and
  reaped) and `fleet status` reports it dead within one heartbeat, while
  the survivors still federate.
- The same stitch through a child running the JAX package's event
  server: the port's fold tick resolves the JAX member's ingest trace,
  and both packages' `fleet_traces` of it give the same waterfall.
"""

import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.obs import fleet
from predictionio_tpu_torch.online import SchedulerConfig, attach_scheduler
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP, KEY = "fleete2e", "e2ekey"
RATE = {"event": "rate", "entityType": "user", "entityId": "newbie",
        "targetEntityType": "item", "targetEntityId": "i0",
        "properties": {"rating": 5.0}}


# the JAX package's event server over the same store, a fleet member of
# its own package's registry under the same base_dir()
JAX_CHILD = textwrap.dedent("""
    import json, os, signal
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM, signal.SIGINT})
    from predictionio_tpu.data.api.event_server import (EventServer,
                                                        EventServerConfig)
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0, stats=True))
    es.start()
    print(json.dumps({"port": es.config.port, "pid": os.getpid()}),
          flush=True)
    signal.sigwait({signal.SIGTERM, signal.SIGINT})
    es.stop()
""")


def post(url, body=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode() if body is not None else None,
        method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=30) as r:
        data = r.read()
        return (json.loads(data) if "json" in r.headers["Content-Type"]
                else data.decode())


def spawn(args, env, log, pattern, timeout_s=120.0):
    """A `python -m predictionio_tpu_torch` child, its output into `log`;
    (the process, the first group of `pattern` it printed)."""
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch", *args],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        with open(log) as f:
            m = re.search(pattern, f.read())
        if m:
            return proc, m.group(1)
        if proc.poll() is not None:
            with open(log) as f:
                raise AssertionError(f"{args[0]} exited {proc.returncode}: "
                                     f"{f.read()[-3000:]}")
        time.sleep(0.1)
    proc.kill()
    raise AssertionError(f"{args[0]} printed nothing matching {pattern}")


def stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """(the child's pid, its port, the engine server, its scheduler, the
    engine.json, the children's environment)."""
    root = tmp_path_factory.mktemp("fleet_e2e")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PIO_STORAGE_")}
    env["PIO_FS_BASEDIR"] = str(root / "pio")
    env.pop("PIO_FLEET_DIR", None)
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("PIO_STORAGE_") or k == "PIO_FLEET_DIR":
                mp.delenv(k)
        mp.setenv("PIO_FS_BASEDIR", env["PIO_FS_BASEDIR"])
        TReg.clear_cache()
        app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
        TReg.Storage.get_meta_data_access_keys().insert(
            AccessKey(KEY, app_id, ()))
        rng = np.random.default_rng(4)
        n = 400
        TReg.Storage.get_events().insert_columnar(ColumnarBatch(
            n, "rate", "user", [f"u{x}" for x in rng.integers(0, 20, n)],
            "item", [f"i{x}" for x in rng.integers(0, 15, n)],
            [{"rating": float(x)} for x in rng.integers(1, 6, n)],
            ["1970-01-01T00:00:%02d.%03dZ" % divmod(k, 1000)
             for k in range(n)]), app_id)
        path = root / "engine.json"
        path.write_text(json.dumps({
            "id": "default", "engineFactory": "recommendation",
            "datasource": {"params": {"app_name": APP}},
            "algorithms": [{"name": "als", "params": {
                "rank": 4, "num_iterations": 2, "lam": 0.1, "seed": 1,
                "device": "cpu"}}]}))
        create_workflow_main(WorkflowConfig(engine_variant=str(path)))
        child, port = spawn(
            ["eventserver", "--ip", "127.0.0.1", "--port", "0", "--stats"],
            env, root / "eventserver.log",
            r"Event Server is listening on http://127\.0\.0\.1:(\d+)")
        srv = EngineServer(ServerConfig(ip="127.0.0.1", port=0,
                                        engine_variant=str(path))).load()
        srv.start()
        try:
            sched = attach_scheduler(srv, SchedulerConfig(app_name=APP,
                                                          max_deltas=1))
            deadline = time.time() + 30
            while time.time() < deadline and len(
                    fleet.get_fleet().live_members()) < 2:
                time.sleep(0.1)
            yield dict(pid=child.pid, port=int(port), srv=srv, sched=sched,
                       path=str(path), env=env, root=root, child=child)
        finally:
            srv.stop()
            stop(child)
            TReg.clear_cache()


def test_one_trace_id_spans_two_pids(stack):
    child_pid, port, srv = stack["pid"], stack["port"], stack["srv"]
    by_role = {m["role"]: m for m in fleet.get_fleet().live_members()}
    assert by_role["event_server"]["pid"] == child_pid != os.getpid()
    assert by_role["engine_server"]["pid"] == os.getpid()
    resp = post(f"http://127.0.0.1:{port}/events.json?accessKey={KEY}",
                RATE)
    tid = resp["traceId"]
    swaps = srv.stats()["modelSwaps"]
    report = stack["sched"].tick(force=True)
    assert report is not None and report["events"] >= 1
    assert srv.stats()["modelSwaps"] == swaps + 1
    out = fleet.fleet_traces(tid)
    assert len(out["pids"]) >= 2, out
    kinds = {}
    for t in out["traces"]:
        kinds.setdefault(t["pid"], set()).add(t["kind"])
    assert "event_ingest" in kinds[child_pid]
    assert "fold_tick" in kinds[os.getpid()]
    fold = next(t for t in out["traces"] if t["kind"] == "fold_tick")
    assert tid in fold["links"]
    assert "hot_swap" in {c["name"] for c in fold["root"]["children"]}
    stitched = post(f"http://127.0.0.1:{port}/fleet/traces.json"
                    f"?trace_id={tid}")
    assert sorted(stitched["pids"]) == sorted({child_pid, os.getpid()})
    assert cli.main(["fleet", "traces", tid]) == 0


def test_federated_metrics_and_health_span_both_pids(stack):
    child_pid, port = stack["pid"], stack["port"]
    fed = fleet.federate_metrics()
    assert f'pid="{child_pid}"' in fed and f'pid="{os.getpid()}"' in fed
    body = post(f"http://127.0.0.1:{port}/fleet/metrics")
    assert f'role="engine_server",pid="{os.getpid()}"' in body
    assert f'role="event_server",pid="{child_pid}"' in body
    h = fleet.fleet_health()
    assert {r["memberId"] for r in h["members"]} >= {
        f"event_server-{child_pid}", f"engine_server-{os.getpid()}"}
    names = {s["name"] for s in h["slo"]}
    assert "serve_p99" in names and "ingest_write_p99" in names


def test_a_sigkilled_member_reads_dead_within_one_heartbeat(stack,
                                                            capsys):
    env, root = stack["env"], stack["root"]
    deploy, dport = spawn(
        ["deploy", "-v", stack["path"], "--ip", "127.0.0.1", "--port", "0"],
        env, root / "deploy.log", r"Engine API is live at "
        r"http://127\.0\.0\.1:(\d+)\.")
    follow = None
    try:
        follow, _ = spawn(
            ["update", "-v", stack["path"], "--engine-port", "0",
             "--follow", "--interval", "3600"], env, root / "follow.log",
            r"(Following app)")
        pids = {"event_server": stack["pid"], "engine_server": deploy.pid,
                "scheduler": follow.pid}
        deadline = time.time() + 30
        while time.time() < deadline:
            live = {(m["role"], m["pid"])
                    for m in fleet.get_fleet().live_members()}
            if set(pids.items()) <= live:
                break
            time.sleep(0.1)
        assert set(pids.items()) <= live, live
        follow.send_signal(signal.SIGKILL)
        t_kill = time.time()
        follow.wait(timeout=30)     # reaped: a zombie passes the pid probe
        while True:
            rc = cli.main(["fleet", "status"])
            line = next(x for x in capsys.readouterr().out.splitlines()
                        if f"scheduler-{follow.pid}" in x)
            if "DEAD" in line:
                assert rc == 1
                break
            assert time.time() - t_kill < fleet.heartbeat_s(), line
            time.sleep(0.05)
        assert time.time() - t_kill < fleet.heartbeat_s()
        fed = fleet.federate_metrics()
        for role, pid in (("event_server", stack["pid"]),
                          ("engine_server", deploy.pid)):
            assert f'pio_fleet_member_up{{role="{role}",pid="{pid}"}} 1' \
                in fed
        assert f'pid="{follow.pid}"' not in fed
        assert post(f"http://127.0.0.1:{dport}/fleet/status.json")[
            "dead"] >= 1
    finally:
        stop(deploy)
        if follow is not None:
            stop(follow)
    assert deploy.returncode == 0


def test_a_jax_member_stitches_alike_in_both_packages(stack):
    from predictionio_tpu.obs import fleet as RF
    env = dict(stack["env"], JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_CHILD], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line, proc.stderr.read()[-3000:]
        info = json.loads(line)
        deadline = time.time() + 30
        while time.time() < deadline and ("event_server", info["pid"]) \
                not in {(m["role"], m["pid"])
                        for m in fleet.get_fleet().live_members()}:
            time.sleep(0.1)
        resp = post(f"http://127.0.0.1:{info['port']}/events.json"
                    f"?accessKey={KEY}", dict(RATE, entityId="jaxnewbie"))
        tid = resp["traceId"]
        report = stack["sched"].tick(force=True)
        assert report is not None and report["events"] >= 1
        ours, theirs = fleet.fleet_traces(tid), RF.fleet_traces(tid)
        assert ours["pids"] == sorted({info["pid"], os.getpid()})
        kinds = {(t["pid"], t["kind"]) for t in ours["traces"]}
        assert (info["pid"], "event_ingest") in kinds
        assert (os.getpid(), "fold_tick") in kinds
        fold = next(t for t in ours["traces"] if t["kind"] == "fold_tick")
        assert tid in fold["links"]
        # both read the same members and stitch the same traces: equal
        # but for the order of members answering at once
        def masked(out):
            return dict(out, members=sorted(out["members"],
                                            key=lambda m: m["memberId"]))
        assert masked(ours) == masked(theirs)
    finally:
        stop(proc)
    assert proc.returncode == 0, proc.stderr.read()[-3000:]
