"""Port parity: `obs/fleet.py` (the member registry, federation, trace
stitching, the fleet-wide incident capture) and the `/fleet/*` routes vs
the JAX reference's, on the CPU, in this process.

- Both registries keep the same record layout: a member one package
  registers shows in the other's `fleet_status`, alive, with the same
  fields; a stale heartbeat or a dead same-node pid reads dead in both,
  a foreign node's pid is never probed, `PIO_FLEET=off` registers
  nothing.
- Federation: `_inject_labels`, `_parse_scrape`, `merge_scrapes` give
  byte-equal text for the same seeded scrapes, and `federate_metrics`,
  `fleet_health` and `fleet_traces` over the same live members answer
  alike; `resolve_event_traces` asks only other pids' members.
- Both packages' event and engine servers register once bound, answer
  `/fleet/status.json`, `/fleet/health.json`, `/fleet/metrics` and
  `/fleet/traces.json` with the reference's codes and shapes (metrics and
  traces gated by `--stats` on the event server), and deregister in
  `stop`; a started scheduler registers as `scheduler`.
- An incident captured while a peer is live freezes the peer's flight
  tail, traces and scrape under `fleet/<member>/`; both CLIs' `incidents
  show` and `fleet {status,metrics,traces}` print the same lines (ages and
  pids masked).
- The flight files' GC asks the registry first.

The two- and three-process cases are in `tests/test_torch_fleet_e2e.py`.
"""

import contextlib
import io
import json
import os
import re
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.api import event_server as JES
from predictionio_tpu.obs import fleet as JF
from predictionio_tpu.obs import flight as JFlight
from predictionio_tpu.obs import incidents as JInc
from predictionio_tpu.online import scheduler as JSched
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu.utils import http as JHttp
from predictionio_tpu_torch.data.api import event_server as TES
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.obs import fleet as TF
from predictionio_tpu_torch.obs import flight as TFlight
from predictionio_tpu_torch.obs import incidents as TInc
from predictionio_tpu_torch.online import scheduler as TSched
from predictionio_tpu_torch.tools import cli as tcli
from predictionio_tpu_torch.utils import http as THttp
from tests.test_torch_obs_e2e import engine_pair, models  # noqa: F401

PKG = {"jax": dict(F=JF, ES=JES, flight=JFlight, inc=JInc, sched=JSched,
                   cli=jcli, http=JHttp),
       "port": dict(F=TF, ES=TES, flight=TFlight, inc=TInc, sched=TSched,
                    cli=tcli, http=THttp)}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])
NODE = os.uname().nodename


def call(port, path, body=None, method=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method=method or ("POST" if body is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            data = r.read()
            ct = r.headers.get("Content-Type", "")
            return r.status, (json.loads(data) if "json" in ct
                              else data.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def record(member_id, pid, port=None, beat_age=0.0, node=NODE,
           host="127.0.0.1"):
    role = member_id.rsplit("-", 1)[0]
    now = time.time()
    rec = {"memberId": member_id, "role": role, "pid": pid, "host": host,
           "port": port, "startedAt": now - 100, "heartbeatAt":
           now - beat_age}
    if node is not None:
        rec["node"] = node
    return rec


def write_records(d, *recs):
    os.makedirs(d, exist_ok=True)
    for rec in recs:
        with open(os.path.join(d, rec["memberId"] + ".json"), "w") as f:
            json.dump(rec, f)


def masked(status: dict) -> dict:
    out = dict(status)
    out["members"] = [{k: v for k, v in m.items()
                       if k not in ("ageS", "heartbeatAt", "startedAt")}
                      for m in status["members"]]
    return out


# -- the registry -----------------------------------------------------------

@BOTH
def test_register_beat_and_deregister(tmp_path, pkg, monkeypatch):
    monkeypatch.setenv("PIO_FLEET_HEARTBEAT_S", "0.2")
    F = PKG[pkg]["F"]
    reg = F.FleetRegistry(fleet_dir=str(tmp_path / "fleet"))
    mid = reg.register("event_server", port=7070, host="0.0.0.0", stats=True)
    assert mid == f"event_server-{os.getpid()}"
    (m,) = reg.members()
    assert (m["alive"], m["port"], m["stats"], m["host"], m["url"],
            m["node"]) == (True, 7070, True, "127.0.0.1",
                           "http://127.0.0.1:7070", NODE)
    beat = m["heartbeatAt"]
    deadline = time.time() + 30
    while reg.members()[0]["heartbeatAt"] == beat \
            and time.time() < deadline:
        time.sleep(0.05)
    assert reg.members()[0]["heartbeatAt"] > beat
    assert reg.update_member(mid, {"tenants": ["a"]})
    assert reg.members()[0]["tenants"] == ["a"]
    assert reg.pid_status(os.getpid()) == "live"
    assert reg.pid_status("x") == reg.pid_status(None) == "unknown"
    reg.deregister(mid)
    assert reg.members() == []
    assert not reg.update_member(mid, {"x": 1})


@BOTH
def test_stale_dead_foreign_and_off(tmp_path, pkg, monkeypatch):
    F = PKG[pkg]["F"]
    monkeypatch.setenv("PIO_FLEET_LIVENESS_S", "30")
    reg = F.FleetRegistry(fleet_dir=str(tmp_path / "fleet"))
    write_records(reg.fleet_dir(),
                  record("engine_server-999999", 999999, 8000, beat_age=60,
                         node=None, host="10.0.0.9"),
                  record("scheduler-999998", 999998),
                  record("scheduler-999997", 999997, node="other-node"))
    alive = {m["memberId"]: m["alive"] for m in reg.members()}
    assert alive == {"engine_server-999999": False,
                     "scheduler-999998": False,   # the pid probe
                     "scheduler-999997": True}    # never probed
    assert reg.pid_status(999999) == reg.pid_status(999998) == "dead"
    assert [m["memberId"] for m in reg.live_members()] == [
        "scheduler-999997"]
    monkeypatch.setenv("PIO_FLEET", "off")
    assert reg.register("event_server", port=1) is None


def test_a_member_one_package_registers_the_other_lists(tmp_path):
    """The record layout is shared: either package's `fleet_status` lists
    the other's member, alive, with equal fields."""
    d = str(tmp_path / "fleet")
    got = {}
    for writer, reader in (("jax", "port"), ("port", "jax")):
        w = PKG[writer]["F"].FleetRegistry(fleet_dir=d)
        mid = w.register(f"{writer}_member", port=9000 + len(got),
                         stats=False)
        try:
            r = PKG[reader]["F"].FleetRegistry(fleet_dir=d)
            status = {pkg: masked(PKG[pkg]["F"].fleet_status(registry=reg))
                      for pkg, reg in ((reader, r), (writer, w))}
            assert status[reader] == status[writer]
            (m,) = status[reader]["members"]
            assert (m["memberId"], m["alive"], m["pid"]) == (
                mid, True, os.getpid())
            got[writer] = m
        finally:
            w.deregister(mid)
    assert set(got["jax"]) == set(got["port"])


# -- federation -------------------------------------------------------------

def seeded_scrape(seed: int, prefix: str = "pio_x") -> str:
    """A classic exposition with counters, labelled gauges, a histogram,
    label values holding quotes, braces and escapes, and a foreign
    sample of no declared family."""
    rng = np.random.default_rng(seed)
    lines = [f"# HELP {prefix}_total a counter",
             f"# TYPE {prefix}_total counter",
             f"{prefix}_total {float(rng.integers(0, 100))}",
             f"# HELP {prefix}_g a labelled gauge",
             f"# TYPE {prefix}_g gauge"]
    for v in ("a", 'q"x', "b}c", "e\\\\f", "n\\nl"):
        lines.append(f'{prefix}_g{{k="{v}",t="{rng.integers(0, 3)}"}} '
                     f"{float(rng.random()):.6f}")
    lines += [f"# HELP {prefix}_seconds a histogram",
              f"# TYPE {prefix}_seconds histogram"]
    for le in ("0.1", "1.0", "+Inf"):
        lines.append(f'{prefix}_seconds_bucket{{le="{le}"}} '
                     f"{float(rng.integers(0, 9))}")
    lines += [f"{prefix}_seconds_sum 1.5", f"{prefix}_seconds_count 9.0",
              f"foreign_gauge {float(rng.random()):.4f}",
              "# a comment", ""]
    if seed % 2:
        # the same family under another type: dropped with a note
        lines += [f"# TYPE {prefix}_total gauge", f"{prefix}_total 1.0"]
    return "\n".join(lines)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merge_and_relabel_are_byte_equal(seed):
    parts = [(seeded_scrape(seed), {"tenant": "a"}),
             (seeded_scrape(seed + 10), {"role": "x", "pid": "7"}),
             (seeded_scrape(seed + 20, "pio_y"), {}),
             ("", {"tenant": "empty"})]
    out = {pkg: PKG[pkg]["F"].merge_scrapes(parts) for pkg in PKG}
    assert out["port"] == out["jax"]
    for line in seeded_scrape(seed).splitlines():
        extra = {"role": 'r"1', "pid": "42"}
        assert TF._inject_labels(line, extra) == \
            JF._inject_labels(line, extra)
    assert TF._parse_scrape(seeded_scrape(seed + 1)) == \
        JF._parse_scrape(seeded_scrape(seed + 1))


@pytest.fixture
def store(tmp_env):
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, "flapp"))
    TReg.Storage.get_meta_data_access_keys().insert(
        AccessKey("flkey", app_id, ()))
    yield tmp_env
    TReg.clear_cache()


@pytest.fixture
def event_servers(store):
    """Both packages' event servers (`--stats`) on one store; each is a
    fleet member of this pid."""
    out = {}
    for pkg in PKG:
        es = PKG[pkg]["ES"].EventServer(PKG[pkg]["ES"].EventServerConfig(
            ip="127.0.0.1", port=0, stats=True))
        es.start()
        out[pkg] = es
    yield out
    for es in out.values():
        es.stop()


RATE = {"event": "rate", "entityType": "user", "entityId": "u1",
        "targetEntityType": "item", "targetEntityId": "i1",
        "properties": {"rating": 3.0}}


def test_the_fleet_views_of_both_packages_agree(event_servers):
    members = TF.get_fleet().live_members()
    assert {m["role"] for m in members} == {"event_server"}
    assert len(members) == 1      # both servers share this pid's id
    for es in event_servers.values():
        call(es.config.port, "/events.json?accessKey=flkey", RATE)
    fed = {pkg: PKG[pkg]["F"].federate_metrics(members) for pkg in PKG}
    assert fed["port"] == fed["jax"]
    assert f'pio_event_write_seconds_count{{role="event_server",pid="' \
        f'{os.getpid()}"}}' in fed["port"]
    TF.fleet_health(members)      # the first poll seeds the burn rates
    health = {pkg: PKG[pkg]["F"].fleet_health(members) for pkg in PKG}
    assert health["port"] == health["jax"]
    assert health["port"]["members"][0]["status"] in ("ok", "no_data")
    _, posted = call(event_servers["port"].config.port,
                     "/events.json?accessKey=flkey", RATE)
    stitched = {pkg: PKG[pkg]["F"].fleet_traces(posted["traceId"], members)
                for pkg in PKG}
    assert stitched["port"] == stitched["jax"]
    assert [t["kind"] for t in stitched["port"]["traces"]] == [
        "event_ingest"]


@pytest.mark.parametrize("path,stats", [
    ("/fleet/status.json", False), ("/fleet/health.json", False),
    ("/fleet/metrics", False), ("/fleet/traces.json?trace_id=00ab", False),
    ("/fleet/metrics", True), ("/fleet/traces.json", True),
    ("/fleet/traces.json?trace_id=00ab", True)])
def test_the_event_servers_fleet_routes_answer_alike(store, path, stats):
    got = {}
    for pkg in PKG:
        es = PKG[pkg]["ES"].EventServer(PKG[pkg]["ES"].EventServerConfig(
            ip="127.0.0.1", port=0, stats=stats))
        es.start()
        try:
            got[pkg] = call(es.config.port, path)
        finally:
            es.stop()
    (sj, bj), (st, bt) = got["jax"], got["port"]
    assert st == sj
    if isinstance(bt, dict) and "members" in bt and "fleetDir" in bt:
        bj, bt = masked(bj), masked(bt)
        for b in (bj, bt):
            for m in b["members"]:
                m.pop("port", None), m.pop("url", None)
    if isinstance(bt, str):
        # the scrapes differ by their processes' families: compare lines
        # of the fleet's own gauge
        bj = [x for x in bj.splitlines() if "pio_fleet_member_up" in x]
        bt = [x for x in bt.splitlines() if "pio_fleet_member_up" in x]
    assert bt == bj


def test_a_query_trace_and_the_event_traces_stitch(event_servers, models):
    """The engine servers register too: the fleet routes answer on them,
    and one event's ingest trace id stitches through either package's
    `/fleet/traces.json`."""
    servers = engine_pair(models)
    try:
        roles = sorted(m["role"] for m in TF.get_fleet().live_members())
        assert roles == ["engine_server", "event_server"]
        _, posted = call(event_servers["port"].config.port,
                         "/events.json?accessKey=flkey", RATE)
        tid = posted["traceId"]
        for pkg, srv in servers.items():
            st, body = call(srv.config.port,
                            f"/fleet/traces.json?trace_id={tid}")
            assert st == 200 and body["pids"] == [os.getpid()]
            assert any(t["traceId"] == tid and t["kind"] == "event_ingest"
                       for t in body["traces"])
            st, text = call(srv.config.port, "/fleet/metrics")
            assert st == 200 and 'role="engine_server"' in text \
                and 'role="event_server"' in text
            st, _ = call(srv.config.port, "/fleet/traces.json")
            assert st == 400
    finally:
        for s in servers.values():
            s.stop()
    assert sorted(m["role"] for m in TF.get_fleet().live_members()) == [
        "event_server"]


@BOTH
def test_event_traces_resolve_through_other_pids_only(pkg):
    F, H = PKG[pkg]["F"], PKG[pkg]["http"]
    served = {}

    def traces(req):
        ids = req.params.get("event_ids", "").split(",")
        served["ids"] = ids
        return H.Response(200, {"eventTraces": {
            e: "ab" * 8 for e in ids if e == "evt-1"}})
    r = H.Router()
    r.add("GET", "/traces.json", traces)
    srv = H.HttpServer(r, "127.0.0.1", 0)
    srv.start()
    try:
        peer = record("event_server-1", 1, srv.port)
        assert F.resolve_event_traces(["evt-1", "evt-2"], members=[peer]) \
            == {"evt-1": "ab" * 8}
        assert set(served["ids"]) == {"evt-1", "evt-2"}
        served.clear()
        assert F.resolve_event_traces(
            ["evt-1"], members=[dict(peer, pid=os.getpid())]) == {}
        assert "ids" not in served
    finally:
        srv.stop()


@BOTH
def test_an_unreachable_member_scrapes_down(tmp_path, pkg):
    F = PKG[pkg]["F"]
    reg = F.FleetRegistry(fleet_dir=str(tmp_path / "fleet"))
    write_records(reg.fleet_dir(),
                  record(f"engine_server-{os.getpid()}", os.getpid(), 1))
    fed = F.federate_metrics(reg.live_members(), timeout_s=0.5)
    assert fed.split("\n")[2] == (f'pio_fleet_member_up{{role='
                                  f'"engine_server",pid="{os.getpid()}"}} 0')
    h = F.fleet_health(reg.live_members(), timeout_s=0.5)
    assert h["status"] == "unreachable"


@BOTH
def test_a_started_scheduler_is_a_member(tmp_path, pkg, monkeypatch):
    monkeypatch.setenv("PIO_FLEET_DIR", str(tmp_path / "fleet"))
    S, F = PKG[pkg]["sched"], PKG[pkg]["F"]
    sched = S.DeltaTrainingScheduler(
        engine=None, engine_params=None, instance=None, algorithms=[],
        models=[], config=S.SchedulerConfig(app_name="x",
                                            poll_interval_s=3600),
        event_store=object())
    sched.start()
    try:
        assert [m["role"] for m in F.get_fleet().members()] == ["scheduler"]
    finally:
        sched.stop()
    assert F.get_fleet().members() == []


# -- incidents and the flight GC ---------------------------------------------

def test_a_capture_freezes_a_live_peer(event_servers, tmp_path,
                                       monkeypatch):
    """A bundle captured while a peer (a faked pid 1 in front of the
    port's event server) is live holds its flight tail, traces and scrape
    under fleet/<member>/ and the roster in fleet.json; both CLIs' `show`
    print the same fleet lines."""
    peer_id = "event_server-1"
    write_records(TF.get_fleet().fleet_dir(), record(
        peer_id, 1, event_servers["port"].config.port))
    ids = {}
    try:
        for pkg in PKG:
            mgr = PKG[pkg]["inc"].IncidentManager(
                incidents_dir=str(tmp_path / pkg), cooldown_s=0.0,
                trace_settle_s=0.0)
            ids[pkg] = mgr.capture("unit_test", "fleet capture", sync=True)
            d = os.path.join(str(tmp_path / pkg), ids[pkg])
            with open(os.path.join(d, "fleet.json")) as f:
                roster = json.load(f)["members"]
            assert any(m["memberId"] == peer_id and m["alive"]
                       for m in roster)
            sub = os.path.join(d, "fleet", peer_id)
            assert sorted(os.listdir(sub)) == ["flight.jsonl",
                                               "metrics.prom", "traces.json"]
            with open(os.path.join(sub, "metrics.prom")) as f:
                assert "pio_event_write_seconds" in f.read()
            assert mgr.load(ids[pkg])["fleet"] == roster
    finally:
        os.remove(os.path.join(TF.get_fleet().fleet_dir(),
                               peer_id + ".json"))
    out = {}
    for pkg in PKG:
        rc, text = run_cli(pkg, "incidents", "show", ids[pkg], "--dir",
                           str(tmp_path / pkg))
        assert rc == 0
        out[pkg] = text[text.index("  fleet at capture"):]
    assert out["port"] == out["jax"]


@BOTH
def test_the_flight_gc_asks_the_registry(tmp_path, pkg, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "pio"))
    F, flight = PKG[pkg]["F"], PKG[pkg]["flight"]
    fdir = str(tmp_path / "flight")
    ghost, reused = 999999, os.getpid() + 1
    write_records(F.get_fleet().fleet_dir(),
                  record(f"event_server-{ghost}", ghost, 7070,
                         host="10.0.0.9", node=None),
                  record(f"scheduler-{reused}", reused, beat_age=3600,
                         host="10.0.0.9", node=None))
    os.makedirs(fdir)
    series = {}
    for pid in (ghost, reused):
        series[pid] = [f"flight-{pid}-{i:06d}.jsonl" for i in (1, 2, 3)]
        for name in series[pid]:
            with open(os.path.join(fdir, name), "w") as f:
                f.write('{"kind":"x"}\n')
    rec = flight.FlightRecorder(flight_dir=fdir, max_files=1)
    fh, _ = rec._rotate(None)
    fh.close()
    left = set(os.listdir(fdir))
    assert set(series[ghost]) <= left
    assert len(left & set(series[reused])) <= 1
    assert flight._pid_is_live(os.getpid())
    assert not flight._pid_is_live(2 ** 22 + 7)
    assert not flight._pid_is_live(None)


# -- the CLI ------------------------------------------------------------------

def run_cli(pkg, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = PKG[pkg]["cli"].main(list(args))
    return rc, buf.getvalue()


AGE = re.compile(r"beat \d+\.\ds ago")


def test_both_clis_print_the_same_fleet_status(tmp_path):
    d = str(tmp_path / "fleetd")
    write_records(d, record("engine_server-999999", 999999, 8000),
                  record("scheduler-999997", 999997, node="other"),
                  dict(record("tenant_host-999996", 999996, 8100,
                              node="other"), tenants=["b", "a"]))
    got = {pkg: run_cli(pkg, "fleet", "status", "--dir", d) for pkg in PKG}
    assert got["port"][0] == got["jax"][0] == 1
    assert AGE.sub("beat _", got["port"][1]) == \
        AGE.sub("beat _", got["jax"][1])
    assert "DEAD" in got["port"][1] and "tenants=a,b" in got["port"][1]
    empty = str(tmp_path / "none")
    assert run_cli("port", "fleet", "status", "--dir", empty) == \
        run_cli("jax", "fleet", "status", "--dir", empty)


def test_both_clis_stitch_and_federate_alike(event_servers):
    _, posted = call(event_servers["port"].config.port,
                     "/events.json?accessKey=flkey", RATE)
    tid = posted["traceId"]
    for args, rc in ((("fleet", "traces", tid), 0),
                     (("fleet", "traces", "00000000000000ff"), 1)):
        got = {pkg: run_cli(pkg, *args) for pkg in PKG}
        assert got["port"][0] == got["jax"][0] == rc
        strip = re.compile(r"\d+\.\d+ms|\{.*\}")
        assert strip.sub("_", got["port"][1]) == \
            strip.sub("_", got["jax"][1])
    assert tid in got["port"][1] or rc == 1
    rc, text = run_cli("port", "fleet", "metrics")
    assert rc == 0 and 'role="event_server"' in text
