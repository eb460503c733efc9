"""Port parity: `obs/flight.py` vs the JAX reference's, on the CPU.

A seeded program of `record()` calls (lifecycle kinds with and without a
model version, per-event kinds coalesced over windows of a few clock
ticks, calls inside traces, watched counters moving between records) runs
on a fresh `FlightRecorder` of each package, with each module's clock
replaced by the same fake one. The ring (`snapshot` newest first,
filtered by kind, trace id and tenant; `tail`), the coalesced and record
counts, and `flight_response` (`n`, `kind`, `trace_id`) must be equal,
exactly, once trace ids are named and sequence numbers and times are
taken out. With the disk sink held back, a full hand-off queue drops the
same records on both and the ring keeps them; with it on, the JSONL lines
the writer leaves are the ring's records, in order, on both.
"""

import json
import os

import numpy as np
import pytest

from predictionio_tpu.obs import flight as JF
from predictionio_tpu.obs import metrics as JM
from predictionio_tpu.obs import trace as JT
from predictionio_tpu_torch.obs import flight as TF
from predictionio_tpu_torch.obs import metrics as TM
from predictionio_tpu_torch.obs import trace as TT
from tests.torch_obs_parity import FakeTime, canon

PKGS = {"jax": (JF, JM, JT), "port": (TF, TM, TT)}
LIFECYCLE = ("model_load", "hot_swap", "aot_warm", "fold_publish",
             "gate_verdict", "canary_promote", "train_start")
PER_EVENT = ("shed", "slow_query", "spill")


def program(seed: int):
    rng = np.random.default_rng(seed)
    prog = []
    for _ in range(150):
        r = rng.random()
        if r < 0.45:
            prog.append(("record", str(rng.choice(LIFECYCLE)),
                         f"v{int(rng.integers(0, 4))}"
                         if rng.random() < 0.6 else None,
                         {"events": int(rng.integers(0, 100))},
                         None, bool(rng.random() < 0.3)))
        elif r < 0.8:
            prog.append(("record", str(rng.choice(PER_EVENT)), None,
                         {"waitBoundS": round(float(rng.random()), 4)},
                         float(rng.choice([0.003, 0.008, 0.02])),
                         bool(rng.random() < 0.3)))
        else:
            prog.append(("inc", int(rng.integers(1, 9))))
    return prog


def run(name, prog, **kw):
    F, M, T = PKGS[name]
    rec = F.FlightRecorder(metric_min_interval_s=0.0, **kw)
    reg = M.MetricsRegistry(parent=M.get_registry())
    counter = reg.counter("pio_engine_requests_total", "requests")
    rec.watched = ("pio_engine_requests_total",)
    rec.add_source(reg)
    ids = {}
    for step in prog:
        if step[0] == "inc":
            counter.inc(step[1])
            continue
        _, kind, version, fields, coalesce_s, traced = step
        if traced:
            with T.TRACER.trace("query") as t:
                t.discard = True
                ids[t.trace_id] = f"T{len(ids)}"
                rec.record(kind, model_version=version,
                           coalesce_s=coalesce_s, **fields)
        else:
            rec.record(kind, model_version=version, coalesce_s=coalesce_s,
                       **fields)
    return rec, ids, reg


def views(name, rec, ids):
    F = PKGS[name][0]
    out = {"all": rec.snapshot(limit=1000), "tail": rec.tail(7),
           "records": rec.records, "coalesced": rec.coalesced,
           "dropped": rec.dropped}
    for kind in LIFECYCLE + PER_EVENT:
        out[kind] = rec.snapshot(limit=5, kind=kind)
    for tid in list(ids)[:5]:
        out["trace " + ids[tid]] = rec.snapshot(trace_id=tid)
    out["tenant"] = rec.snapshot(tenant="someone")
    orig = F.FLIGHT
    F.FLIGHT = rec
    try:
        out["resp"] = F.flight_response({"n": "9"})
        out["resp kind"] = F.flight_response({"kind": "shed", "n": "3"})
        if ids:
            out["resp trace"] = F.flight_response(
                {"trace_id": next(iter(ids))})
    finally:
        F.FLIGHT = orig
    return canon(out, ids)


@pytest.mark.parametrize("seed", range(6))
def test_the_same_records_give_the_same_ring(seed, monkeypatch):
    monkeypatch.setenv("PIO_FLIGHT", "off")
    got = {}
    for name in PKGS:
        monkeypatch.setattr(PKGS[name][0], "time", FakeTime())
        rec, ids, _ = run(name, program(seed), ring_capacity=64)
        got[name] = views(name, rec, ids)
    assert got["port"] == got["jax"]
    assert got["port"]["coalesced"] > 0


@pytest.mark.parametrize("capacity", [8, 16])
def test_a_full_queue_drops_the_disk_record_and_keeps_the_ring(
        capacity, monkeypatch, tmp_path):
    got = {}
    for name in PKGS:
        rec = PKGS[name][0].FlightRecorder(
            flight_dir=str(tmp_path / name), queue_capacity=capacity,
            metric_min_interval_s=0.0)
        monkeypatch.setattr(rec, "_ensure_writer", lambda: None)
        for i in range(40):
            rec.record("hot_swap", i=i)
        got[name] = (rec.dropped, rec.records, rec._q.qsize(),
                     [r["i"] for r in rec.tail(100)])
        rec.close()
    assert got["port"] == got["jax"]
    assert got["port"][0] == 40 - capacity


def test_the_files_hold_the_ring_in_order(monkeypatch, tmp_path):
    monkeypatch.delenv("PIO_FLIGHT", raising=False)
    got = {}
    for name in PKGS:
        d = tmp_path / name
        # no coalescing: on the real clock its windows would differ
        prog = [s[:4] + (None,) + s[5:] if s[0] == "record" else s
                for s in program(7)]
        rec, ids, _ = run(name, prog, flight_dir=str(d),
                          max_file_bytes=4096, max_files=50)
        assert rec.flush(10.0)
        rec.close()
        files = sorted(f for f in os.listdir(d) if f.endswith(".jsonl"))
        assert all(f.startswith(f"flight-{os.getpid()}-") for f in files)
        lines = [json.loads(line) for f in files
                 for line in (d / f).read_text().splitlines()]
        assert [r["seq"] for r in lines] == \
            [r["seq"] for r in rec.tail(10_000)]
        got[name] = canon(lines, ids)
    assert got["port"] == got["jax"]


def test_the_process_recorder_registers_its_families():
    for name in PKGS:
        reg = PKGS[name][1].get_registry()
        for fam in ("pio_flight_records_total", "pio_flight_dropped_total",
                    "pio_flight_write_errors_total",
                    "pio_flight_coalesced_total"):
            assert reg.get(fam) is not None, (name, fam)
