"""Port parity: `obs/incidents.py` and the CLI's `incidents` vs the JAX
reference's, on the CPU.

Each package's `IncidentManager` captures the same incidents (a gate
rejection naming a fold tick's trace, a canary rollback, a sentinel
breach) from the same flight records, traces and providers (each
package's flight recorder and tracer replaced by fresh ones holding the
same content, on the same fake clock). The bundle's files, its manifest
(`incident.json`: kind, reason, context, providers, counts), its flight
tail and its traces (the named trace and one hop of links) must be
equal, exactly, once ids and times are taken out; the registry scrape
opens with the process source. A second capture of a kind inside the
cooldown is suppressed on both and counted; `PIO_INCIDENTS=off` captures
nothing. `list_incidents`, `load` and `export` read a bundle either
package wrote alike, and so do both CLIs' `incidents list`, `show` and
`export`, line for line once the ids are named.
"""

import contextlib
import io
import json
import os
import re
import tarfile

import pytest

from predictionio_tpu.obs import flight as JF
from predictionio_tpu.obs import incidents as JI
from predictionio_tpu.obs import trace as JT
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch.obs import flight as TF
from predictionio_tpu_torch.obs import incidents as TI
from predictionio_tpu_torch.obs import trace as TT
from predictionio_tpu_torch.tools import cli as tcli
from tests.torch_obs_parity import FakeTime, canon

PKGS = {"jax": (JI, JF, JT, jcli), "port": (TI, TF, TT, tcli)}
FILES = ["flight.jsonl", "incident.json", "metrics.prom", "traces.json"]


def capture_all(name, root, monkeypatch):
    """Three incidents from the same state; returns (manager, incident
    ids, trace-id names)."""
    I, F, T, _ = PKGS[name]
    monkeypatch.setattr(T, "time", FakeTime())
    monkeypatch.setattr(F, "time", FakeTime())
    rec = F.FlightRecorder(metric_min_interval_s=0.0)
    tracer = T.Tracer()
    monkeypatch.setattr(F, "FLIGHT", rec)
    monkeypatch.setattr(T, "TRACER", tracer)
    monkeypatch.setenv("PIO_FLIGHT", "off")
    # an empty fleet: the bundles hold this process's view only (the
    # fleet capture is held in tests/test_torch_fleet.py)
    monkeypatch.setenv("PIO_FLEET_DIR", str(root) + "_fleet")
    ids = {}
    with tracer.trace("event_ingest", event="rate") as ing:
        with tracer.span("storage_write"):
            pass
    with tracer.trace("query") as other:
        pass
    with tracer.trace("fold_tick") as tick:
        with tracer.span("tail_read", freshEvents=3):
            pass
        with tracer.span("fold_solve", touchedUsers=2, touchedItems=1):
            pass
        tick.link(ing.trace_id)
        rec.record("gate_verdict", model_version="v7", passed=False,
                   verdicts={"finite": "fail"}, events=3)
    tracer.link_completed(ing.trace_id, tick.trace_id)
    ids.update({ing.trace_id: "ING", other.trace_id: "Q",
                tick.trace_id: "TICK"})
    rec.record("canary_rollback", model_version="v8", reason="nan_scores")
    rec.record("sentinel_breach", site="fold_in", detail="rows")
    mgr = I.IncidentManager(incidents_dir=str(root), cooldown_s=3600.0,
                            trace_settle_s=0.0)
    mgr.register_provider("scheduler", lambda: {"pendingEvents": 3,
                                                "foldIns": 1})
    mgr.register_provider("engine_server", lambda: {"modelVersion": "v7"})
    got = [mgr.capture("gate_rejected", "fold publish refused by quality "
                       "gate(s): finite", context={"events": 3},
                       trace_ids=(tick.trace_id,), sync=True),
           mgr.capture("canary_rollback", "canary rollback of v8",
                       context={"candidateVersion": "v8"}, sync=True),
           mgr.capture("sentinel_breach", "numerical fault in fold_in",
                       context={"site": "fold_in"}, sync=True),
           mgr.capture("canary_rollback", "again", sync=True)]
    return mgr, got, ids


def bundle(root, iid, ids):
    d = os.path.join(root, iid)
    out = {"files": sorted(os.listdir(d))}
    with open(os.path.join(d, "incident.json")) as f:
        out["meta"] = canon(json.load(f), ids)
    with open(os.path.join(d, "flight.jsonl")) as f:
        out["flight"] = canon([json.loads(x) for x in f if x.strip()], ids)
    with open(os.path.join(d, "traces.json")) as f:
        out["traces"] = canon(json.load(f), ids)
    with open(os.path.join(d, "metrics.prom")) as f:
        out["prom"] = f.read().split("\n", 1)[0]
    return out


@pytest.fixture
def captured(tmp_path, monkeypatch):
    out = {}
    for name in PKGS:
        root = tmp_path / name
        with monkeypatch.context() as m:
            out[name] = (root,) + capture_all(name, root, m)
    return out


def test_bundles_agree(captured):
    got = {}
    for name, (root, mgr, iids, ids) in captured.items():
        assert iids[3] is None    # inside the cooldown
        assert (mgr.captured, mgr.suppressed, mgr.failed) == (3, 1, 0)
        got[name] = [bundle(root, iid, ids) for iid in iids[:3]]
    assert got["port"] == got["jax"]
    first = got["port"][0]
    assert first["files"] == FILES
    assert first["prom"] == "# source: process"
    assert {t["traceId"] for t in first["traces"]["traces"]} == \
        {"TICK", "ING"}


@pytest.mark.parametrize("kind", ["gate_rejected", "canary_rollback",
                                  "sentinel_breach"])
def test_incident_ids_name_the_kind_and_the_process(captured, kind):
    for name, (root, mgr, iids, ids) in captured.items():
        iid = [i for i in iids if i and f"-{kind}-" in i][0]
        assert re.fullmatch(rf"\d{{8}}T\d{{6}}-{kind}-{os.getpid()}-\d+",
                            iid)


def test_the_kill_switch_captures_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_INCIDENTS", "off")
    for name in PKGS:
        mgr = PKGS[name][0].IncidentManager(
            incidents_dir=str(tmp_path / name))
        assert mgr.capture("gate_rejected", "x", sync=True) is None
        assert not os.path.exists(tmp_path / name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_managers_read_a_bundle_alike(captured, writer, tmp_path):
    root, _, iids, ids = captured[writer]
    names = {iid: f"I{k}" for k, iid in enumerate(iids[:3])}
    names.update(ids)
    got = {}
    for name in PKGS:
        mgr = PKGS[name][0].IncidentManager(incidents_dir=str(root))
        listed = mgr.list_incidents()
        loaded = [mgr.load(iid) for iid in iids[:3]]
        out = mgr.export(iids[0], str(tmp_path / f"{name}.tar.gz"))
        with tarfile.open(out) as tar:
            members = sorted(m.name.split("/", 1)[-1]
                             for m in tar.getmembers())
        got[name] = canon({"list": listed, "load": loaded,
                           "tar": members}, names)
    assert got["port"] == got["jax"]


def cli_lines(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def scrub(text, iids):
    for k, iid in enumerate(iids):
        text = text.replace(iid, f"<I{k}>")
    text = re.sub(r"\d{4}-\d\d-\d\dT[\d:.]+\+00:00", "<time>", text)
    text = re.sub(r'"t": [\d.e+]+', '"t": <t>', text)
    text = re.sub(r"#\s*\d+ ", "#<seq> ", text)
    return re.sub(r"trace=[0-9a-f]{16}", "trace=<id>", text)


@pytest.mark.parametrize("sub", ["list", "show", "export"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_both_clis_print_a_bundle_alike(captured, writer, sub, tmp_path,
                                        monkeypatch):
    root, _, iids, _ = captured[writer]
    iids = [i for i in iids if i]
    monkeypatch.chdir(tmp_path)
    got = {}
    for name in PKGS:
        argv = ["incidents", sub]
        if sub != "list":
            argv.append(iids[0])
        argv += ["--dir", str(root)]
        if sub == "export":
            argv += ["--out", str(tmp_path / "out" / name / "b.tar.gz")]
            os.makedirs(tmp_path / "out" / name)
        rc, out = cli_lines(PKGS[name][3], argv)
        out = out.replace(str(tmp_path / "out" / name), "<out>")
        got[name] = (rc, scrub(out, iids))
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0
