"""Port parity: `obs/slowlog.py` vs the JAX reference's, on the CPU.

`build_waterfall` on the same traces, built span for span through each
package's tracer on the same fake clock, gives the same stage list,
names and milliseconds: batched windows (pipelined, with
`completionWaitMs`, and not), unbatched queries, with and without the
`predict` span's `deviceMs` and the `readback` span's `d2hWaitMs`, and a
serialize stage or none. `slow_threshold_s` agrees under
`PIO_SLOW_QUERY_MS` and `PIO_SLO_SERVE_P99_MS`, set, unset and malformed.
`capture_slow_query` into a fresh log of each package, then
`slow_response`, the ring's order and bound and the incident provider's
view agree once trace ids are named and times taken out.
"""

import itertools

import pytest

from predictionio_tpu.obs import slowlog as JL
from predictionio_tpu.obs import trace as JT
from predictionio_tpu_torch.obs import slowlog as TL
from predictionio_tpu_torch.obs import trace as TT
from tests.torch_obs_parity import FakeTime, canon

PKGS = {"jax": (JL, JT), "port": (TL, TT)}

# (batched, pipelined, deviceMs, d2hWaitMs, serialize_s)
CASES = list(itertools.product((True, False), (True, False),
                               (None, 0.75), (None, 1.5), (None, 0.002)))


def traces(T, batched, pipelined, device_ms, d2h_ms):
    """(query trace, batch trace or None) as the serve path makes them."""
    tracer = T.Tracer()
    bt = None
    with tracer.trace("query") as qt:
        if batched:
            with tracer.span("batch_wait"):
                attrs = {"batch": 7, "formationMs": 3.25}
                if pipelined:
                    attrs["pipelined"] = True
                bt = tracer.begin_trace("batch_predict", **attrs)
                bt.link(qt.trace_id)
                with tracer.resume(bt):
                    with tracer.span("supplement"):
                        pass
                    with tracer.span("predict", batch=7) as p:
                        if device_ms is not None:
                            p.attrs["deviceMs"] = device_ms
                if pipelined:
                    bt.root.attrs["completionWaitMs"] = 2.5
                with tracer.resume(bt, commit=True):
                    with tracer.span("readback") as rb:
                        if d2h_ms is not None:
                            rb.attrs["d2hWaitMs"] = d2h_ms
                    with tracer.span("post_process"):
                        pass
            qt.link(bt.trace_id)
        else:
            with tracer.span("supplement"):
                pass
            with tracer.span("predict") as p:
                if device_ms is not None:
                    p.attrs["deviceMs"] = device_ms
            with tracer.span("post_process"):
                pass
    return qt, bt


@pytest.mark.parametrize("case", CASES)
def test_the_same_traces_give_the_same_waterfall(case, monkeypatch):
    batched, pipelined, device_ms, d2h_ms, ser = case
    got = {}
    for name, (L, T) in PKGS.items():
        monkeypatch.setattr(T, "time", FakeTime())
        qt, bt = traces(T, batched, pipelined, device_ms, d2h_ms)
        got[name] = L.build_waterfall(qt, bt, serialize_s=ser)
    assert got["port"] == got["jax"]
    stages = [s["stage"] for s in got["port"]]
    assert stages[0] == "queue_wait"
    assert ("device_sync" in stages) == (device_ms is not None)
    assert ("d2h_wait" in stages) == (batched and d2h_ms is not None)


ENVS = [{}, {"PIO_SLOW_QUERY_MS": "0"}, {"PIO_SLOW_QUERY_MS": "120"},
        {"PIO_SLO_SERVE_P99_MS": "80"},
        {"PIO_SLOW_QUERY_MS": "30", "PIO_SLO_SERVE_P99_MS": "80"},
        {"PIO_SLOW_QUERY_MS": "junk", "PIO_SLO_SERVE_P99_MS": "90"},
        {"PIO_SLO_SERVE_P99_MS": "junk"}]


@pytest.mark.parametrize("env", ENVS)
def test_slow_threshold_agrees(monkeypatch, env):
    for k in ("PIO_SLOW_QUERY_MS", "PIO_SLO_SERVE_P99_MS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert TL.slow_threshold_s() == JL.slow_threshold_s()


def test_captures_and_slow_json_agree(monkeypatch):
    monkeypatch.setenv("PIO_SLOW_QUERY_MS", "0")
    got = {}
    for name, (L, T) in PKGS.items():
        monkeypatch.setattr(T, "time", FakeTime())
        monkeypatch.setattr(L, "SLOWLOG", L.SlowQueryLog(capacity=4))
        ids = {}
        for k, case in enumerate(CASES[:9]):
            batched, pipelined, device_ms, d2h_ms, ser = case
            qt, bt = traces(T, batched, pipelined, device_ms, d2h_ms)
            # capture_slow_query resolves the window through TRACER
            if bt is not None:
                T.TRACER._commit(bt)
            ids[qt.trace_id] = f"Q{k}"
            if bt is not None:
                ids[bt.trace_id] = f"B{k}"
            L.capture_slow_query(
                qt, 0.3 + k / 100, query={"user": f"u{k}", "num": 3},
                model_version="v1", serialize_s=ser,
                batch_trace_id=bt.trace_id if bt is not None else None)
        got[name] = canon({"resp": L.slow_response({"n": "3"}),
                           "all": L.SLOWLOG.snapshot(limit=10),
                           "top": L.SLOWLOG.top(2),
                           "recorded": L.SLOWLOG.recorded,
                           "provider": L.SLOWLOG.provider_state()}, ids)
    assert got["port"] == got["jax"]
    assert got["port"]["recorded"] == 9
    assert len(got["port"]["all"]) == 4
