"""Port parity: `resilience/` (retry policy, circuit breaker, spill WAL and
replayer, seeded faults) vs the JAX reference's, on the CPU.

Each case of `tests/test_resilience.py` that the port's slice covers runs
against both packages (`pkg` parameter), and the parity cases feed both
the same inputs and hold their outputs equal, exactly:

- the same seeded `RetryPolicy` draws the same delays, and a breaker
  driven through the same failures renders byte-equal `pio_breaker_*`
  samples;
- the same breaker sequence writes equal `breaker` flight records (`to`,
  `from_`, `consecutiveFailures`), one `breaker_open` bundle each, and
  equal samples; so does each package's fold scheduler over a store whose
  `find` raises until its tail breaker opens and then heals (the
  scheduler's own breaker is `resilience.CircuitBreaker`);
- one fault spec and seed give one decision stream, and `FaultSpec.parse`
  refuses the same bad specs with the same messages;
- a WAL written by either package is read by the other record for record
  (`pending`, `scan_wal`, `iter_pending`, the cursor, the quarantine
  sidecar), and both replayers drain it alike;
- both CLIs' `faults` and `spill` print the same lines;
- with `PIO_FAULTS` on the store, the port's event server acknowledges
  every event, spills some and replays them all: every acknowledged id is
  read back from the store exactly once.

The stores are this file's own dict-backed `ListEvents`, taken by both
packages (the port has no in-memory backend yet). Times are virtual
wherever a breaker or a retry waits; ids and timestamps are masked.
"""

import contextlib
import io
import json
import os
import random
import time
import urllib.request

import pytest

from predictionio_tpu import resilience as JRes
from predictionio_tpu.data.datamap import DataMap as JDataMap
from predictionio_tpu.data.event import Event as JEvent
from predictionio_tpu.obs import flight as JFlight
from predictionio_tpu.obs import incidents as JInc
from predictionio_tpu.obs import metrics as JMetrics
from predictionio_tpu.online import scheduler as JSched
from predictionio_tpu.resilience import spill as JSpill
from predictionio_tpu.tools import cli as jcli
from predictionio_tpu_torch import resilience as TRes
from predictionio_tpu_torch.data.datamap import DataMap as TDataMap
from predictionio_tpu_torch.data.event import Event as TEvent
from predictionio_tpu_torch.obs import flight as TFlight
from predictionio_tpu_torch.obs import incidents as TInc
from predictionio_tpu_torch.obs import metrics as TMetrics
from predictionio_tpu_torch.online import scheduler as TSched
from predictionio_tpu_torch.resilience import spill as TSpill
from predictionio_tpu_torch.tools import cli as tcli

PKG = {
    "jax": dict(res=JRes, spill=JSpill, Event=JEvent, DataMap=JDataMap,
                Registry=JMetrics.MetricsRegistry, flight=JFlight,
                inc=JInc, sched=JSched, cli=jcli,
                obs="predictionio_tpu.obs"),
    "port": dict(res=TRes, spill=TSpill, Event=TEvent, DataMap=TDataMap,
                 Registry=TMetrics.MetricsRegistry, flight=TFlight,
                 inc=TInc, sched=TSched, cli=tcli,
                 obs="predictionio_tpu_torch.obs"),
}
BOTH = pytest.mark.parametrize("pkg", ["jax", "port"])


def ev(pkg, i, name="rate"):
    P = PKG[pkg]
    return P["Event"](event=name, entity_type="user", entity_id=f"u{i}",
                      target_entity_type="item", target_entity_id=f"i{i}",
                      properties=P["DataMap"]({"rating": float(i % 5 + 1)}))


class ListEvents:
    """A dict-backed events store either package's replayer can write:
    `fail_first` insert attempts raise OSError (a store that is down), and
    ids in `reject` raise ValueError (a deterministic rejection)."""

    def __init__(self, fail_first=0, reject=()):
        self.rows = {}
        self.fail_first = fail_first
        self.attempts = 0
        self.reject = set(reject)

    def _attempt(self, events):
        self.attempts += 1
        if self.attempts <= self.fail_first:
            raise OSError("primary store down")
        if any(e.event_id in self.reject for e in events):
            raise ValueError("constraint violation")

    def insert(self, event, app_id, channel_id=None):
        self._attempt([event])
        eid = event.event_id or f"gen{len(self.rows)}"
        self.rows[(app_id, channel_id, eid)] = event
        return eid

    def insert_batch(self, events, app_id, channel_id=None):
        self._attempt(events)
        return [self.insert(e, app_id, channel_id) for e in events]

    def get(self, event_id, app_id, channel_id=None):
        return self.rows.get((app_id, channel_id, event_id))

    def ids(self, app_id=1, channel_id=None):
        return sorted(k[2] for k in self.rows if k[:2] == (app_id,
                                                            channel_id))


def virtual_policy(pkg, **kw):
    slept, clock = [], [0.0]

    def sleep(s):
        slept.append(s)
        clock[0] += s
    return PKG[pkg]["res"].RetryPolicy(sleep=sleep, clock=lambda: clock[0],
                                       **kw), slept


class FixedRng:
    def __init__(self, frac):
        self.frac = frac

    def uniform(self, lo, hi):
        return lo + self.frac * (hi - lo)


# -- RetryPolicy ------------------------------------------------------------

@BOTH
def test_retry_succeeds_gives_up_and_lets_a_400_through(pkg):
    R = PKG[pkg]["res"]
    policy, slept = virtual_policy(pkg, max_attempts=4, base_delay_s=0.1)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise IOError("transient")
        return "ok"
    assert policy.call(flaky) == "ok" and len(calls) == 3 and len(slept) == 2
    policy, _ = virtual_policy(pkg, max_attempts=3)
    calls.clear()

    def dead():
        calls.append(1)
        raise IOError("down")
    with pytest.raises(R.RetryBudgetExceeded) as e:
        policy.call(dead)
    assert len(calls) == 3 and isinstance(e.value.__cause__, IOError)
    calls.clear()

    def bad_request():
        calls.append(1)
        raise ValueError("not transient")
    with pytest.raises(ValueError):
        virtual_policy(pkg, max_attempts=5)[0].call(bad_request)
    assert len(calls) == 1


@BOTH
def test_jitter_is_capped_and_the_deadline_stops_retries(pkg):
    R = PKG[pkg]["res"]
    policy, _ = virtual_policy(pkg, max_attempts=8, base_delay_s=0.1,
                               max_delay_s=1.0)
    for attempt in range(1, 8):
        cap = min(1.0, 0.1 * 2 ** (attempt - 1))
        assert all(0.0 <= policy.delay_for(attempt) <= cap
                   for _ in range(20))
    policy, _ = virtual_policy(pkg, max_attempts=10, base_delay_s=0.8,
                               max_delay_s=0.8, deadline_s=0.5)
    object.__setattr__(policy, "rng", FixedRng(0.5))   # every delay 0.4
    calls = []

    def dead():
        calls.append(1)
        raise IOError("down")
    with pytest.raises(R.RetryBudgetExceeded):
        policy.call(dead)
    assert len(calls) == 2


@BOTH
def test_a_retry_after_hint_replaces_the_delay(pkg):
    policy, slept = virtual_policy(pkg, max_attempts=2, base_delay_s=10.0)

    class Hinted(IOError):
        retry_after_s = 0.123
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise Hinted("busy")
        return "ok"
    assert policy.call(flaky) == "ok" and slept == [0.123]
    assert PKG[pkg]["res"].retry_after_hint(Hinted("x")) == 0.123
    assert PKG[pkg]["res"].retry_after_hint(IOError("x")) is None


def test_a_seeded_policy_draws_the_same_delays():
    got = {}
    for pkg in PKG:
        policy = PKG[pkg]["res"].RetryPolicy(rng=random.Random(3),
                                             base_delay_s=0.05,
                                             max_delay_s=2.0)
        got[pkg] = [policy.delay_for(a) for a in range(1, 12)]
    assert got["port"] == got["jax"]
    assert TRes.TRANSIENT_ERRORS == JRes.TRANSIENT_ERRORS


# -- CircuitBreaker ---------------------------------------------------------

def breaker(pkg, **kw):
    clock = [0.0]
    reg = PKG[pkg]["Registry"]()
    return PKG[pkg]["res"].CircuitBreaker("test", clock=lambda: clock[0],
                                          registry=reg, **kw), clock, reg


@BOTH
def test_the_breaker_opens_probes_and_backs_off(pkg):
    R = PKG[pkg]["res"]
    br, clock, _ = breaker(pkg, failure_threshold=3)
    for _ in range(2):
        br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open"
    with pytest.raises(R.CircuitOpenError) as e:
        br.allow()
    assert e.value.retry_after_s > 0 and e.value.http_status == 503
    br, clock, _ = breaker(pkg, failure_threshold=1, reset_timeout_s=10.0,
                           max_reset_timeout_s=25.0)
    br.record_failure()
    clock[0] += 10.0
    assert br.state == "half_open"
    br.allow()                     # the probe slot
    with pytest.raises(R.CircuitOpenError):
        br.allow()                 # a concurrent caller: the probe is out
    br.record_failure()            # the probe failed: timeout doubled
    clock[0] += 10.0
    assert br.state == "open"
    clock[0] += 10.0
    assert br.state == "half_open"
    br.allow()
    br.record_failure()
    clock[0] += 25.0               # capped at max_reset_timeout_s
    assert br.state == "half_open"
    br.allow()
    br.record_success()
    assert br.state == "closed"


@BOTH
def test_the_guard_and_call_record_outcomes(pkg):
    R = PKG[pkg]["res"]
    br, clock, _ = breaker(pkg, failure_threshold=1, reset_timeout_s=5.0)
    assert br.call(lambda: 42) == 42
    with pytest.raises(IOError):
        with br.guard():
            raise IOError("down")
    with pytest.raises(R.CircuitOpenError):
        br.call(lambda: 42)        # open: the function never runs
    clock[0] += 5.0
    assert br.call(lambda: 7) == 7 and br.state == "closed"
    with pytest.raises(ValueError):
        R.CircuitBreaker("bad", failure_threshold=0,
                         registry=PKG[pkg]["Registry"]())


def test_concurrent_callers_keep_the_breakers_invariants():
    """More threads than cores on one port breaker, the switch interval
    shortened: successes alone never open it, an open breaker fails every
    caller fast and counts each, and a half-open breaker admits exactly
    one probe however many callers race for it."""
    import sys
    import threading
    br, clock, reg = breaker("port", failure_threshold=3,
                             reset_timeout_s=5.0)
    n_threads = 4 * (os.cpu_count() or 2)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(fn, n):
            out = []
            threads = [threading.Thread(target=lambda: out.append(fn(n)))
                       for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
            return out

        def successes(n):
            for _ in range(n):
                br.allow()
                br.record_success()
        run(successes, 500)
        assert br.state == "closed"
        assert "pio_breaker_transitions_total{" not in reg.render()
        for _ in range(3):
            br.record_failure()

        def fast_fails(n):
            k = 0
            for _ in range(n):
                with contextlib.suppress(TRes.CircuitOpenError):
                    br.allow()
                    k += 1
            return k
        assert sum(run(fast_fails, 50)) == 0
        assert f"pio_breaker_fast_failures_total{{breaker=\"test\"}} " \
            f"{float(50 * n_threads)}" in reg.render()
        clock[0] += 5.0
        assert sum(run(fast_fails, 1)) == 1      # the one probe
    finally:
        sys.setswitchinterval(switch)


def drive(br, clock):
    """One breaker sequence: open, fail fast twice, a failed probe, a
    good probe. Returns the states seen."""
    states = []
    for _ in range(3):
        br.record_failure()
        states.append(br.state)
    for _ in range(2):
        with contextlib.suppress(IOError):
            br.allow()
    clock[0] += 2.0
    states.append(br.state)
    br.allow()
    br.record_failure()
    states.append(br.state)
    clock[0] += 4.0
    br.allow()
    br.record_success()
    states.append(br.state)
    return states


def test_the_same_sequence_renders_the_same_breaker_samples():
    text, states = {}, {}
    for pkg in PKG:
        br, clock, reg = breaker(pkg, failure_threshold=3,
                                 reset_timeout_s=2.0)
        states[pkg] = drive(br, clock)
        text[pkg] = reg.render()
    assert states["port"] == states["jax"] == [
        "closed", "closed", "open", "half_open", "open", "closed"]
    assert text["port"] == text["jax"]
    assert 'pio_breaker_fast_failures_total{breaker="test"} 2.0' in \
        text["port"]


FLIGHT_MASK = ("seq", "t", "metrics", "traceId", "pid")


@pytest.fixture
def fresh_diagnostics(tmp_path, monkeypatch):
    """Each package's flight recorder, incident manager and process
    registry replaced by fresh ones for the test; an empty fleet."""
    monkeypatch.setenv("PIO_FLIGHT", "off")
    monkeypatch.setenv("PIO_FLEET_DIR", str(tmp_path / "fleet"))
    out = {}
    for pkg, P in PKG.items():
        rec = P["flight"].FlightRecorder(metric_min_interval_s=0.0)
        mgr = P["inc"].IncidentManager(
            incidents_dir=str(tmp_path / pkg / "incidents"),
            cooldown_s=3600.0, trace_settle_s=0.0)
        reg = P["Registry"]()
        monkeypatch.setattr(P["flight"], "FLIGHT", rec)
        monkeypatch.setattr(P["inc"], "INCIDENTS", mgr)
        import importlib
        monkeypatch.setattr(importlib.import_module(P["obs"]),
                            "get_registry", lambda reg=reg: reg)
        out[pkg] = (rec, mgr, reg)
    return out


def diagnostics_of(rec, mgr, reg):
    """(the breaker flight records masked, the incident kinds and
    contexts, the pio_breaker_* sample lines)."""
    assert mgr.drain()
    records = [{k: v for k, v in r.items() if k not in FLIGHT_MASK}
               for r in rec.tail(100) if r["kind"] == "breaker"]
    bundles = [mgr.load(i["id"]) for i in mgr.list_incidents()]
    incidents = [(b["kind"], b["reason"], b["context"]) for b in bundles]
    samples = [line for line in reg.render().splitlines()
               if line.startswith("pio_breaker")]
    return records, incidents, samples


def test_transitions_write_the_same_records_incident_and_samples(
        fresh_diagnostics):
    got = {}
    for pkg, (rec, mgr, reg) in fresh_diagnostics.items():
        clock = [0.0]
        br = PKG[pkg]["res"].CircuitBreaker(
            "event_store", failure_threshold=3, reset_timeout_s=2.0,
            clock=lambda clock=clock: clock[0])
        got[pkg] = (drive(br, clock), diagnostics_of(rec, mgr, reg))
    assert got["port"] == got["jax"]
    states, (records, incidents, samples) = got["port"]
    assert [(r["from_"], r["to"], r["consecutiveFailures"])
            for r in records] == [
        ("closed", "open", 3), ("open", "half_open", 3),
        ("half_open", "open", 4), ("open", "half_open", 4),
        ("half_open", "closed", 0)]
    assert {r["breaker"] for r in records} == {"event_store"}
    assert [k for k, _, _ in incidents] == ["breaker_open"]
    assert incidents[0][2] == {"breaker": "event_store", "failures": 3,
                               "resetTimeoutS": 2.0}
    assert 'pio_breaker_state{breaker="event_store"} 0.0' in samples


class HealingStore:
    """A tail the fold scheduler reads: `find` raises OSError until
    `healed`, then answers no events."""

    def __init__(self):
        self.healed = False

    def find(self, **kw):
        if not self.healed:
            raise OSError("event store down")
        return iter(())


def test_the_schedulers_tail_breaker_opens_and_heals_alike(
        fresh_diagnostics):
    """The fix of the scheduler's private breaker: both packages' fold
    schedulers over a store whose `find` raises until the breaker opens,
    then heals. Equal states, flight records, one `breaker_open` bundle
    each and equal `pio_breaker_*` samples."""
    got = {}
    for pkg, (rec, mgr, reg) in fresh_diagnostics.items():
        S = PKG[pkg]["sched"]
        store = HealingStore()
        sched = S.DeltaTrainingScheduler(
            engine=None, engine_params=None, instance=None, algorithms=[],
            models=[], config=S.SchedulerConfig(
                app_name="tailapp", event_names=["rate"],
                tail_breaker_failures=3, tail_breaker_reset_s=0.2),
            event_store=store)
        assert isinstance(sched._tail_breaker,
                          PKG[pkg]["res"].CircuitBreaker)
        clock = [0.0]        # virtual time: a loaded host moves no state
        sched._tail_breaker.clock = lambda clock=clock: clock[0]
        seen = []
        for _ in range(4):
            with pytest.raises(OSError) as e:
                sched.poll_events()
            seen.append((type(e.value).__name__,
                         sched.stats()["tailBreaker"]))
        clock[0] += 0.25
        store.healed = True
        assert sched.poll_events() == 0
        seen.append(("ok", sched.stats()["tailBreaker"]))
        got[pkg] = (seen, diagnostics_of(rec, mgr, reg))
    assert got["port"] == got["jax"]
    seen, (records, incidents, samples) = got["port"]
    assert seen == [("OSError", "closed"), ("OSError", "closed"),
                    ("OSError", "open"), ("CircuitOpenError", "open"),
                    ("ok", "closed")]
    assert [(r["from_"], r["to"], r["consecutiveFailures"])
            for r in records] == [("closed", "open", 3),
                                  ("open", "half_open", 3),
                                  ("half_open", "closed", 0)]
    assert [k for k, _, _ in incidents] == ["breaker_open"]
    assert incidents[0][2]["breaker"] == "scheduler_tail"
    assert ('pio_breaker_transitions_total{breaker="scheduler_tail",'
            'to="open"} 1.0') in samples
    assert 'pio_breaker_fast_failures_total{breaker="scheduler_tail"} ' \
        '1.0' in samples


# -- faults -----------------------------------------------------------------

@BOTH
def test_a_spec_parses_and_matches_by_prefix(pkg):
    R = PKG[pkg]["res"]
    spec = R.FaultSpec.parse("storage:latency_ms=5,latency_rate=0.5;"
                             "storage.write:error=0.3,seed=42")
    assert spec.seed == 42
    w = spec.rule_for("storage.write")
    assert w.error == 0.3 and w.latency_ms == 5.0
    r = spec.rule_for("storage.read")
    assert r.error is None and r.latency_ms == 5.0
    assert spec.rule_for("http") is None
    spec = R.FaultSpec.parse("storage:error=1.0,seed=1;storage.write:error=0")
    inj = R.FaultInjector(spec, registry=PKG[pkg]["Registry"]())
    store = R.FaultyEvents(ListEvents(), inj)
    store.insert(ev(pkg, 0), 1)            # writes never fault
    with pytest.raises(R.InjectedFault):
        store.get("x", 1)                  # reads always do
    hop = R.FaultInjector(R.FaultSpec.parse("http:error=1.0"),
                          registry=PKG[pkg]["Registry"]()).wrap_callable(
        "http", lambda: "ok")
    with pytest.raises(R.InjectedFault):
        hop()


BAD_SPECS = ["nocolon", "t:error", "t:error=x", "t:bogus=1", "t:error=1.5",
             "t:latency_rate=-1"]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_bad_specs_are_refused_alike(bad):
    msgs = {}
    for pkg in PKG:
        with pytest.raises(ValueError) as e:
            PKG[pkg]["res"].FaultSpec.parse(bad)
        msgs[pkg] = str(e.value)
    assert msgs["port"] == msgs["jax"]


SPECS = ["storage.write:error=0.5,seed=7",
         "storage:partition=0.2,latency_ms=1,latency_rate=0.3,seed=11;"
         "storage.write:error=0.25",
         "fold.factors:corrupt=0.5,seed=3"]


@pytest.mark.parametrize("spec", SPECS)
def test_one_spec_and_seed_give_one_decision_stream(spec):
    import numpy as np
    streams, counts = {}, {}
    for pkg, P in PKG.items():
        R = P["res"]
        reg = P["Registry"]()
        inj = R.FaultInjector(R.FaultSpec.parse(spec), sleep=lambda s: None,
                              registry=reg)
        out = []
        for k in range(200):
            target = ("storage.write", "storage.read")[k % 2]
            try:
                inj.before(target)
                out.append("ok")
            except R.InjectedFault:
                out.append("error")
            except ConnectionError:
                out.append("partition")
            arr, hit = inj.corrupt_array("fold.factors",
                                         np.ones(3, np.float32))
            out.append(bool(hit))
        streams[pkg] = out
        counts[pkg] = [line for line in reg.render().splitlines()
                       if line.startswith("pio_faults_injected_total")]
    assert streams["port"] == streams["jax"]
    assert counts["port"] == counts["jax"] and counts["port"]


def test_the_env_injector_wraps_the_store_and_corrupts_the_fold(monkeypatch):
    monkeypatch.setenv("PIO_FAULTS", "storage.write:error=1.0,seed=2;"
                                     "fold.ratings:corrupt=1")
    import numpy as np
    for pkg in PKG:
        R = PKG[pkg]["res"]
        R.reset_env_injector()
        try:
            wrapped = R.maybe_wrap_events(ListEvents())
            assert isinstance(wrapped, R.FaultyEvents)
            assert R.maybe_wrap_events(wrapped) is wrapped
            with pytest.raises(R.InjectedFault):
                wrapped.insert(ev(pkg, 0), 1)
            arr, hit = R.maybe_corrupt_array("fold.ratings",
                                             np.ones(4, np.float32))
            assert hit and np.isnan(arr).all()
            assert R.maybe_corrupt_array("fold.factors", arr)[1] is False
        finally:
            R.reset_env_injector()
    monkeypatch.delenv("PIO_FAULTS")
    assert TRes.injector_from_env() is None
    store = ListEvents()
    assert TRes.maybe_wrap_events(store) is store


def test_the_port_registry_wraps_events_under_pio_faults(tmp_env,
                                                         monkeypatch):
    from predictionio_tpu_torch.data.storage import registry as TReg
    monkeypatch.setenv("PIO_FAULTS", "storage.write:error=1.0,seed=2")
    TReg.clear_cache()
    try:
        events = TReg.Storage.get_events()
        assert isinstance(events, TRes.FaultyEvents)
        with pytest.raises(TRes.InjectedFault):
            events.insert(ev("port", 0), 1)
    finally:
        monkeypatch.delenv("PIO_FAULTS")
        TReg.clear_cache()
    assert not isinstance(TReg.Storage.get_events(), TRes.FaultyEvents)


def run_cli(pkg, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = PKG[pkg]["cli"].main(list(args))
    return rc, buf.getvalue()


@pytest.mark.parametrize("args", [
    ("faults", "--spec", "storage.write:error=0.3,seed=42", "--preview",
     "12"),
    ("faults", "--spec", "storage:latency_ms=5,partition=0.5;"
     "fold.factors:nan=0.5", "--preview", "8", "--target", "storage.read"),
    ("faults", "--spec", "garbage"),
    ("faults",)])
def test_both_clis_print_the_same_faults_lines(args, monkeypatch):
    monkeypatch.delenv("PIO_FAULTS", raising=False)
    got = {pkg: run_cli(pkg, *args) for pkg in PKG}
    assert got["port"] == got["jax"]


# -- the spill WAL and its replayer -----------------------------------------

def write_wal(pkg, path, n=6, channel=None):
    wal = PKG[pkg]["spill"].SpillWAL(str(path))
    ids = [wal.append(ev(pkg, i), 1, channel_id=channel) for i in range(n)]
    return wal, ids


def frames(pkg, path):
    """What `pkg`'s reader sees in a WAL: (app, channel, event dict,
    trace id) per pending record, and the read-only views."""
    wal = PKG[pkg]["spill"].SpillWAL(str(path))
    try:
        pending = [(a, c, e.to_dict(), t)
                   for _, a, c, e, t in wal.pending()]
        counts = (wal.pending_count(), wal.pending_bytes())
    finally:
        wal.close()
    S = PKG[pkg]["spill"]
    scan = S.scan_wal(str(path))
    scan.pop("path")
    return pending, counts, scan, list(S.iter_pending(str(path))), \
        S.read_quarantine(str(path))


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_wal_one_package_writes_the_other_reads(tmp_path, writer,
                                                  reader):
    path = tmp_path / "events.wal"
    wal, ids = write_wal(writer, path, n=7, channel=3)
    first = next(iter(wal.pending()))
    wal.checkpoint(first[0], records=1)      # the cursor moves past one
    wal.close()
    with open(path, "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad")   # a torn tail
    scans = {}
    for pkg in PKG:
        scans[pkg] = PKG[pkg]["spill"].scan_wal(str(path))
    assert scans[reader] == scans[writer]
    assert scans[reader]["tornBytes"] == 6
    assert scans[reader]["pendingRecords"] == 6
    got = frames(reader, path)                # repairs the torn tail
    want = frames(writer, path)
    assert got == want
    assert [p[2]["eventId"] for p in got[0]] == ids[1:]
    assert {(a, c) for a, c, _, _ in got[0]} == {(1, 3)}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_replayer_drains_the_other_packages_wal(tmp_path, writer, reader):
    """Dedup, a poisoned record quarantined, the trace ids carried: the
    reader's replayer drains the writer's WAL as the writer's would."""
    out = {}
    for pkg in (writer, reader):
        path = tmp_path / pkg / "events.wal"
        os.makedirs(path.parent)
        wal, ids = write_wal(writer, path, n=5)
        wal.close()
        R = PKG[pkg]["res"]
        wal = R.SpillWAL(str(path))
        store = ListEvents(reject={ids[2]})
        store.rows[(1, None, ids[0])] = "already there"   # a crash window
        r = R.SpillReplayer(wal, store, policy=R.RetryPolicy(
            max_attempts=1, sleep=lambda s: None),
            registry=PKG[pkg]["Registry"](), quarantine_after=2)
        drained = [r.drain(), r.drain()]
        out[pkg] = (drained, r.stats(), r.quarantined, r.deduped,
                    store.ids(), [q["event"]["eventId"] for q in
                                  PKG[pkg]["spill"].read_quarantine(
                                      str(path))], ids)
        wal.close()
    (dj, sj, qj, ddj, rows_j, quar_j, ids_j) = out[writer]
    (dt, st, qt, ddt, rows_t, quar_t, ids_t) = out[reader]
    assert (dj, qj, ddj) == (dt, qt, ddt)
    sj.pop("lastError"), st.pop("lastError")
    assert sj == st
    assert quar_t == [ids_t[2]] and quar_j == [ids_j[2]]
    assert rows_t == sorted(set(ids_t) - {ids_t[2]})


@BOTH
def test_a_down_store_stops_the_drain_and_quarantines_nothing(tmp_path,
                                                              pkg):
    R = PKG[pkg]["res"]
    wal, ids = write_wal(pkg, tmp_path / "w.wal", n=5)
    store = ListEvents(fail_first=10 ** 6)
    r = R.SpillReplayer(wal, store, policy=R.RetryPolicy(
        max_attempts=1, sleep=lambda s: None),
        registry=PKG[pkg]["Registry"](), quarantine_after=2)
    for _ in range(4):
        assert r.drain() == 0
    assert r.quarantined == 0 and wal.pending_count() == 5
    store.fail_first = 0
    assert r.drain() == 5 and store.ids() == sorted(ids)
    assert wal.pending_count() == 0 and os.path.getsize(wal.path) == 0


@BOTH
def test_an_open_breaker_gates_the_replay(tmp_path, pkg):
    R = PKG[pkg]["res"]
    wal, _ = write_wal(pkg, tmp_path / "w.wal", n=1)
    clock = [0.0]
    br = R.CircuitBreaker("replay", failure_threshold=1, reset_timeout_s=10.0,
                          clock=lambda: clock[0],
                          registry=PKG[pkg]["Registry"]())
    br.record_failure()
    r = R.SpillReplayer(wal, ListEvents(), app_breaker=br,
                        policy=R.RetryPolicy(max_attempts=1,
                                             sleep=lambda s: None),
                        registry=PKG[pkg]["Registry"]())
    assert r.drain() == 0 and wal.pending_count() == 1
    clock[0] += 10.0
    assert r.drain() == 1 and br.state == "closed"


@BOTH
def test_frames_carry_the_ingest_trace_and_the_replay_restores_it(
        tmp_path, pkg):
    P = PKG[pkg]
    tracer = __import__(P["obs"] + ".trace", fromlist=["TRACER"]).TRACER
    path = str(tmp_path / "w.wal")
    wal = P["spill"].SpillWAL(path)
    with tracer.trace("outage_ingest") as t:
        t.discard = True
        eid = wal.append(ev(pkg, 0), 1)
        tid = t.trace_id
    wal.append(ev(pkg, 1), 1)
    wal.close()
    envs = list(P["spill"].iter_pending(path))
    assert envs[0]["traceId"] == tid and "traceId" not in envs[1]
    tracer._event_traces.pop(eid, None)
    wal = P["spill"].SpillWAL(path)
    r = P["res"].SpillReplayer(wal, ListEvents(), policy=P["res"].RetryPolicy(
        max_attempts=1, sleep=lambda s: None), registry=P["Registry"]())
    assert r.drain() == 2
    assert tracer.trace_id_for_event(eid) == tid
    wal.close()


def test_requeue_and_both_clis_spill_lines(tmp_path, monkeypatch, tmp_env):
    """`spill status/peek/requeue` print the same lines in both CLIs over
    one WAL with a quarantined record; requeue lands it in the store."""
    from predictionio_tpu_torch.data.storage import registry as TReg
    path = tmp_path / "events.wal"
    wal, ids = write_wal("port", path, n=4)
    first = next(iter(wal.pending()))
    wal.checkpoint(first[0], records=1)
    wal.close()
    rec = {"appId": 1, "channelId": None,
           "event": ev("port", 9).with_id("q" * 32).to_dict(),
           "error": "constraint violation"}
    with open(str(path) + ".quarantine", "w") as f:
        f.write(json.dumps(rec) + "\n")
    for args in (("spill", "status"), ("spill", "peek", "2"),
                 ("spill", "peek", "--quarantine")):
        got = {pkg: run_cli(pkg, *args, "--wal", str(path)) for pkg in PKG}
        assert got["port"] == got["jax"], args
        assert got["port"][0] == 0
        if args[1] == "status":
            assert "records total/pending: 4 / 3" in got["port"][1]
    rc, out = run_cli("port", "spill", "requeue", "-f", "--wal", str(path))
    assert (rc, out.strip()) == (0, "Requeued 1 record(s) directly into the "
                                 "event store (id-deduped). Quarantine "
                                 "cleared.")
    got = TReg.Storage.get_events().get("q" * 32, 1)
    assert got is not None and got.entity_id == "u9"
    assert not os.path.exists(str(path) + ".quarantine")
    assert run_cli("port", "spill", "requeue", "--wal", str(path)) == (
        0, "Quarantine is empty; nothing to requeue.\n")


# -- the event server's resilient write path --------------------------------

def call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_a_faulted_store_loses_no_acknowledged_event(tmp_env, monkeypatch):
    """PIO_FAULTS fails 30 % of the store's writes: every single, batch
    and columnar event is acknowledged 201, some spill, the replayer
    drains them all, and every acknowledged id is read back from the
    store exactly once. The JAX event server, on the same spec and seed
    and the same serial posts, spills the same events."""
    from predictionio_tpu.data.storage import registry as JReg
    from predictionio_tpu_torch.data.api import event_server as TES
    from predictionio_tpu_torch.data.storage import registry as TReg
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    monkeypatch.setenv("PIO_FAULTS", "storage.write:error=0.3,seed=21")
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, "spillapp"))
    TReg.Storage.get_meta_data_access_keys().insert(
        AccessKey("spillkey", app_id, ()))
    s = TES.EventServer(TES.EventServerConfig(ip="127.0.0.1", port=0,
                                              stats=True))
    s.start()
    acked, spilled = [], 0
    try:
        body = {"event": "rate", "entityType": "user", "entityId": "a",
                "targetEntityType": "item", "targetEntityId": "b",
                "properties": {"rating": 3.0}}
        for k in range(40):
            code, got = call(s.config.port, "POST",
                             "/events.json?accessKey=spillkey",
                             dict(body, entityId=f"u{k}"))
            assert code == 201, got
            acked.append(got["eventId"])
            spilled += bool(got.get("spilled"))
        code, got = call(s.config.port, "POST",
                         "/batch/events.json?accessKey=spillkey",
                         [dict(body, entityId=f"b{k}") for k in range(20)])
        assert code == 200 and {g["status"] for g in got} == {201}
        acked += [g["eventId"] for g in got]
        spilled += sum(bool(g.get("spilled")) for g in got)
        for k in range(6):
            code, got = call(s.config.port, "POST",
                             "/events/columnar.json?accessKey=spillkey",
                             {"event": "rate", "entityType": "user",
                              "entityId": [f"c{k}{j}" for j in range(5)],
                              "targetEntityType": "item",
                              "targetEntityId": ["x"] * 5,
                              "returnIds": True})
            assert code == 201, got
            acked += got["eventIds"]
            spilled += 5 * bool(got.get("spilled"))
        assert spilled > 0
        deadline = time.time() + 60
        while s._wal.pending_bytes() and time.time() < deadline:
            time.sleep(0.1)
        assert s._wal.pending_bytes() == 0
        assert s.spilled_count == spilled
        code, health = call(s.config.port, "GET", "/health.json")
        assert health["breaker"] in ("closed", "open", "half_open")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{s.config.port}/metrics", timeout=30) as r:
            text = r.read().decode()
        values = {line.split(" ")[0]: float(line.split(" ")[1])
                  for line in text.splitlines()
                  if line.startswith("pio_ingest_spill")}
        assert values == {"pio_ingest_spilled_total": spilled,
                          "pio_ingest_spill_pending_bytes": 0.0}
        assert 'pio_faults_injected_total{target="storage.write",' \
            'kind="error"}' in text
    finally:
        s.stop()
    monkeypatch.delenv("PIO_FAULTS")
    TReg.clear_cache()
    events = TReg.Storage.get_events()
    assert len(set(acked)) == len(acked) == 90
    assert all(events.get(eid, app_id) is not None for eid in acked)
    assert len(list(events.find(app_id=app_id, limit=-1))) == len(acked)
    # the reference, the same spec and seed, the same serial singles; no
    # replay thread draws from the decision stream meanwhile
    monkeypatch.setenv("PIO_FAULTS", "storage.write:error=0.3,seed=21")
    for R in (JRes, TRes):
        monkeypatch.setattr(R.SpillReplayer, "start", lambda self: self)
    JReg.clear_cache()
    from predictionio_tpu.data.api import event_server as JES
    flags = {}
    for name, mod, reg in (("jax", JES, JReg), ("port", TES, TReg)):
        reg.clear_cache()
        js = mod.EventServer(mod.EventServerConfig(
            ip="127.0.0.1", port=0, breaker_failures=10 ** 6,
            spill_dir=str(tmp_env / f"spill_{name}")))
        js.start()
        try:
            flags[name] = [
                bool(call(js.config.port, "POST",
                          "/events.json?accessKey=spillkey",
                          dict(body, entityId=f"p{k}"))[1].get("spilled"))
                for k in range(30)]
        finally:
            js.stop()
    JReg.clear_cache()
    TReg.clear_cache()
    assert flags["port"] == flags["jax"] and any(flags["port"])
