"""Port parity: `obs/profiler.py` vs the JAX reference's, on the CPU.

`profile_response`'s start, start, stop, stop answers agree with the
reference's (`JaxTraceController` there, `TorchTraceController` here):
message and tracing state, each answer's keys a superset of the
reference's (the port adds the activities it records and the Chrome
trace file it wrote); a bad action answers 400 on both. The CPU-only
trace is asked for by naming the device `"cpu"`; without a name the port
records CUDA activity, and with no card it answers 500 without
starting. The trace file is a Chrome trace with the ops the process ran.
The sampling profiler's `report` has the same keys and stack entries on
both, and its families are registered on both process registries.
"""

import json
import threading
import time

import pytest
import torch

from predictionio_tpu.obs import metrics as JM
from predictionio_tpu.obs import profiler as JP
from predictionio_tpu_torch.obs import metrics as TM
from predictionio_tpu_torch.obs import profiler as TP

DROP = ("dir", "traceFile", "activities", "allThreads")


def answers(mod, tmp, body_extra):
    out = []
    for action in ("start", "start", "stop", "stop"):
        body = {"dir": str(tmp)} if action == "start" else {}
        body.update(body_extra if action == "start" else {})
        out.append(mod.profile_response(action, body))
        if action == "start":
            torch.ones(8) @ torch.ones(8)
    return out


def test_start_start_stop_stop_agrees(tmp_path):
    j = answers(JP, tmp_path / "jax", {})
    t = answers(TP, tmp_path / "port", {"device": "cpu"})
    for (sj, bj), (st, bt) in zip(j, t):
        assert st == sj == 200
        assert set(bj) <= set(bt)
        assert {k: v for k, v in bt.items() if k not in DROP} == \
            {k: v for k, v in bj.items() if k not in DROP}
    assert [b["tracing"] for _, b in t] == [True, True, False, False]
    assert t[0][1]["activities"] == ["CPU"] and t[0][1]["allThreads"]
    with open(t[2][1]["traceFile"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name")) for e in events)
    assert TP.TORCH_TRACE.last_start_s >= 0
    assert TP.TORCH_TRACE.last_stop_s >= 0


def test_a_device_trace_without_a_card_answers_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("with a card the trace records CUDA activity "
                    "(tests/test_torch_cuda.py)")
    status, body = TP.profile_response("start", {"dir": str(tmp_path)})
    assert status == 500 and body["tracing"] is False
    assert "CUDA" in body["message"]
    assert not TP.TORCH_TRACE.tracing
    # the server's device decides when the body names none
    status, body = TP.profile_response("start", {"dir": str(tmp_path)},
                                       device="cpu")
    assert status == 200 and body["activities"] == ["CPU"]
    assert TP.profile_response("stop")[0] == 200


@pytest.mark.parametrize("action", [None, "bogus"])
def test_a_bad_action_agrees(action):
    assert TP.profile_response(action) == JP.profile_response(action)


def sample(mod, seconds=0.3):
    prof = mod.SamplingProfiler(hz=100.0, max_stacks=4)
    stop = threading.Event()

    def busy():
        while not stop.is_set():
            sum(range(1000))

    th = threading.Thread(target=busy)
    th.start()
    prof.start()
    time.sleep(seconds)
    prof.stop()
    stop.set()
    th.join()
    return prof


def test_report_shape_agrees(monkeypatch):
    monkeypatch.setenv("PIO_PROFILER", "on")
    j, t = sample(JP), sample(TP)
    rj, rt = j.report(top=3), t.report(top=3)
    assert sorted(rt) == sorted(rj)
    assert rt["samples"] > 0 and rt["distinctStacks"] <= 4
    assert [sorted(s) for s in rt["topStacks"]] == \
        [sorted(s) for s in rj["topStacks"]][:len(rt["topStacks"])]
    assert sorted(t.report_state()) == sorted(j.report_state())
    sj, bj = JP.profile_response("report", {"top": 2})
    st, bt = TP.profile_response("report", {"top": 2})
    assert st == sj == 200 and sorted(bt) == sorted(bj)


def test_the_kill_switch_and_the_families_agree(monkeypatch):
    monkeypatch.setenv("PIO_PROFILER", "off")
    assert TP.SamplingProfiler().start() is False
    assert JP.SamplingProfiler().start() is False
    for M in (JM, TM):
        reg = M.get_registry()
        for fam in ("pio_profiler_samples_total",
                    "pio_profiler_spent_seconds_total",
                    "pio_profiler_running"):
            assert reg.get(fam) is not None, fam
