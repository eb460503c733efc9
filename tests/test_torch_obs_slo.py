"""Port parity: `obs/slo.py` vs the JAX reference's, on the CPU.

Both default spec sets (the engine server's and the event server's),
under the same environment knobs, are equal field for field. A seeded
program of observations (query latencies into `pio_engine_query_seconds`,
fold-tick walls, rollbacks and gate rejects, the staleness gauge, event
writes) and clock steps runs against an `SLOEngine` of each package over
its own registry, with an injected clock; every `evaluate()` along the
way, the verdicts, burn rates, rates and event counts, and
`health_response` with and without an engine, must be equal, exactly.
`lock_probe` registers the same labeled family on both process
registries, and `timed_acquire` observes one wait an acquisition and
releases on an exception.
"""

import threading

import numpy as np
import pytest

from predictionio_tpu.obs import metrics as JM
from predictionio_tpu.obs import slo as JS
from predictionio_tpu_torch.obs import metrics as TM
from predictionio_tpu_torch.obs import slo as TS

PKGS = {"jax": (JS, JM), "port": (TS, TM)}
KNOBS = [{}, {"PIO_SLO_FAST_WINDOW_S": "5", "PIO_SLO_SLOW_WINDOW_S": "30",
              "PIO_SLO_SERVE_P99_MS": "50", "PIO_SLO_GUARD_BUDGET": "1",
              "PIO_SLO_INGEST_MIN_EVS": "3", "PIO_SLO_STALENESS_MAX_S": "20"}]


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def program(seed: int):
    rng = np.random.default_rng(seed)
    prog = []
    for _ in range(400):
        r = rng.random()
        if r < 0.45:
            # mostly fast queries, with bursts of slow ones
            slow = rng.random() < (0.6 if (len(prog) // 60) % 3 == 1
                                   else 0.02)
            prog.append(("query", float(rng.uniform(0.3, 2.0) if slow
                                        else rng.uniform(0.001, 0.2))))
        elif r < 0.55:
            prog.append(("tick", float(rng.uniform(0.1, 4.0))))
        elif r < 0.58:
            prog.append(("rollback",))
        elif r < 0.6:
            prog.append(("reject",))
        elif r < 0.7:
            prog.append(("stale", float(rng.uniform(0.0, 40.0))))
        elif r < 0.85:
            prog.append(("write", float(rng.uniform(0.0005, 0.3))))
        elif r < 0.95:
            prog.append(("advance", float(rng.uniform(0.5, 12.0))))
        else:
            prog.append(("evaluate",))
    return prog


def run(name, prog):
    S, M = PKGS[name]
    reg = M.MetricsRegistry()
    h_q = reg.histogram("pio_engine_query_seconds", "q")
    h_tick = reg.histogram("pio_fold_tick_seconds", "t",
                           labelnames=("tenant",)).labels(tenant="")
    c_rb = reg.counter("pio_guard_rollbacks_total", "r",
                       labelnames=("reason",))
    c_rej = reg.counter("pio_guard_gate_rejects_total", "g",
                        labelnames=("tenant",)).labels(tenant="")
    stale = {"v": 0.0}
    reg.gauge_func("pio_engine_model_staleness_seconds", "s",
                   lambda: stale["v"])
    h_w = reg.histogram("pio_event_write_seconds", "w")
    clock = Clock()
    engine = S.SLOEngine(S.default_engine_specs(), registries=[reg],
                         clock=clock, max_samples=64)
    events = S.SLOEngine(S.default_event_specs(), registries=[reg],
                         clock=clock, max_samples=64)
    out = []
    for step in prog:
        op = step[0]
        if op == "query":
            h_q.observe(step[1])
        elif op == "tick":
            h_tick.observe(step[1])
        elif op == "rollback":
            c_rb.labels(reason="nan_scores").inc()
        elif op == "reject":
            c_rej.inc()
        elif op == "stale":
            stale["v"] = step[1]
        elif op == "write":
            h_w.observe(step[1])
        elif op == "advance":
            clock.now += step[1]
        else:
            out.append((engine.evaluate(), events.evaluate()))
    out.append((S.health_response(engine, extra={"modelVersion": "v1"}),
                S.health_response(events)))
    return out


@pytest.mark.parametrize("knobs", range(len(KNOBS)))
def test_default_spec_sets_agree(monkeypatch, knobs):
    for k, v in KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    for fn in ("default_engine_specs", "default_event_specs"):
        j = [vars(s) for s in getattr(JS, fn)()]
        t = [vars(s) for s in getattr(TS, fn)()]
        assert t == j


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("knobs", range(len(KNOBS)))
def test_the_same_observations_give_the_same_verdicts(monkeypatch, seed,
                                                      knobs):
    for k, v in KNOBS[knobs].items():
        monkeypatch.setenv(k, v)
    got = {name: run(name, program(seed)) for name in PKGS}
    assert got["port"] == got["jax"]
    statuses = {s["status"] for ev, _ in got["port"] for s in ev["slo"]}
    assert len(statuses) > 1


def test_health_without_an_engine_agrees():
    assert TS.health_response(None) == JS.health_response(None)
    assert TS.health_response(None, {"x": 1}) == \
        JS.health_response(None, {"x": 1})


def test_lock_probe_registers_the_same_family():
    for name in PKGS:
        S, M = PKGS[name]
        probe = S.lock_probe("parity_probe")
        assert S.lock_probe("parity_probe") is probe
        fam = M.get_registry().get("pio_lock_wait_seconds")
        assert fam.mtype == "histogram"
        assert fam.labelnames == ("lock",)
        assert fam.bounds == tuple(JS.LOCK_WAIT_BUCKETS)
        n = probe.count
        lk = threading.Lock()
        with S.timed_acquire(lk, probe):
            assert lk.locked()
        with pytest.raises(RuntimeError):
            with S.timed_acquire(lk, probe):
                raise RuntimeError("released anyway")
        assert not lk.locked()
        assert probe.count == n + 2


def test_the_ports_lock_sites_are_the_reference_sites():
    import predictionio_tpu_torch.data.storage.registry  # noqa: F401
    from predictionio_tpu_torch.serving.batcher import MicroBatcher
    b = MicroBatcher(lambda qs: qs, max_batch=4)
    try:
        assert b.submit("q") == "q"
    finally:
        b.stop()
    fam = TM.get_registry().get("pio_lock_wait_seconds")
    locks = {key[0] for key in fam._children}
    assert {"batcher_inflight", "registry_publish"} <= locks
