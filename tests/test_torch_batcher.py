"""Port parity: the micro-batcher (`serving/batcher.py`) vs the JAX
reference's, behaviour by behaviour.

Every test runs the same assertions against both `MicroBatcher`s (the
`impl` parameter): coalescing and fan-out, an idle query and serial
traffic paying no window, the straggler hold and the latency budget's cap
on it, loud shutdown, errors reaching every waiter (synchronous, in begin
and in finish), a wrong result count, the pipelined executor's overlap
and backpressure, the adaptive target and window, and deadline shedding.
The device occupancy the adaptive sizing reads is set on the instance.
Times are wall-clock bounds with a wide margin (a 300-500 ms window
against a bound of 250 ms or less).
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from predictionio_tpu.serving import batcher as JB
from predictionio_tpu_torch.serving import batcher as TB


@pytest.fixture(params=["jax", "port"])
def impl(request):
    return JB if request.param == "jax" else TB


def pipelined(mod, begin, inflight=2, **kw):
    return mod.MicroBatcher(lambda qs: begin(qs)(), max_batch=8,
                            max_wait_ms=5, process_batch_begin=begin,
                            inflight=inflight, adaptive=False, **kw)


def wait_until(cond, timeout_s=5.0):
    deadline = time.perf_counter() + timeout_s
    while not cond() and time.perf_counter() < deadline:
        time.sleep(0.002)
    return cond()


def test_coalesces_and_fans_out(impl):
    batches = []

    def handler(queries):
        batches.append(len(queries))
        time.sleep(0.002)
        return [q * 10 for q in queries]

    b = impl.MicroBatcher(handler, max_batch=8, max_wait_ms=30)
    try:
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(b.submit, range(32)))
    finally:
        b.stop()
    assert sorted(results) == [i * 10 for i in range(32)]
    assert max(batches) > 1 and max(batches) <= 8
    assert sum(batches) == 32
    s = b.stats()
    assert s["batchedQueries"] == 32 and s["batches"] == len(batches)
    assert s["exitFullBatch"] + s["exitDrainGate"] + s["exitWindow"] + \
        s["exitAdaptive"] == s["batches"]


def test_pipelined_results_fan_out(impl):
    def begin(queries):
        qs = list(queries)
        return lambda: [q * 10 for q in qs]

    b = pipelined(impl, begin)
    try:
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(b.submit, range(32)))
        assert sorted(results) == [i * 10 for i in range(32)]
        assert b.pipelined
        assert b._inflight == 0 and b._inflight_batches == 0
    finally:
        b.stop()


def test_idle_query_dispatches_immediately(impl):
    b = impl.MicroBatcher(lambda qs: qs, max_batch=8, max_wait_ms=500)
    try:
        t0 = time.perf_counter()
        assert b.submit(7) == 7
        assert time.perf_counter() - t0 < 0.25
        assert b.stats()["immediateBatches"] >= 1
    finally:
        b.stop()


def test_closed_loop_serial_pays_no_window(impl):
    b = impl.MicroBatcher(lambda qs: qs, max_batch=8, max_wait_ms=300)
    try:
        t0 = time.perf_counter()
        for i in range(5):
            assert b.submit(i) == i
        assert time.perf_counter() - t0 < 0.3
        assert b.stats()["immediateBatches"] >= 5
    finally:
        b.stop()


def test_straggler_holds_the_window_and_the_budget_caps_it(impl):
    held = impl.MicroBatcher(lambda qs: qs, max_batch=8, max_wait_ms=300,
                             adaptive=False)
    try:
        with held._flight_lock:
            held._undispatched += 1    # a counted straggler never arrives
        t0 = time.perf_counter()
        held.submit(1)
        assert time.perf_counter() - t0 >= 0.25
        assert held.stats()["exitWindow"] == 1
    finally:
        held.stop()
    capped = impl.MicroBatcher(lambda qs: qs, max_batch=8, max_wait_ms=300,
                               latency_budget_ms=40, adaptive=False)
    try:
        with capped._flight_lock:
            capped._undispatched += 1
        t0 = time.perf_counter()
        capped.submit(1)
        assert time.perf_counter() - t0 < 0.2
    finally:
        capped.stop()


def test_stop_fails_queued_waiters_loudly(impl):
    started = threading.Event()

    def handler(qs):
        started.set()
        time.sleep(0.3)
        return qs

    b = impl.MicroBatcher(handler, max_batch=1, max_wait_ms=1)
    with ThreadPoolExecutor(4) as ex:
        f1 = ex.submit(b.submit, 1)
        assert started.wait(2)
        f2 = ex.submit(b.submit, 2)
        time.sleep(0.05)
        b.stop()
        assert f1.result(timeout=5) == 1
        with pytest.raises(impl.ShutdownError, match="shutting down"):
            f2.result(timeout=5)
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(3)


def test_stop_completes_dispatched_windows(impl):
    started, release = threading.Event(), threading.Event()

    def begin(queries):
        started.set()

        def finish():
            release.wait(5)
            return list(queries)
        return finish

    b = pipelined(impl, begin, inflight=1)
    with ThreadPoolExecutor(4) as ex:
        f1 = ex.submit(b.submit, 1)
        assert started.wait(5)
        f2 = ex.submit(b.submit, 2)
        time.sleep(0.05)
        stopper = ex.submit(b.stop)
        time.sleep(0.1)
        release.set()
        stopper.result(timeout=15)
        assert f1.result(timeout=5) == 1
        with pytest.raises(impl.ShutdownError):
            f2.result(timeout=5)


@pytest.mark.parametrize("where", ["sync", "begin", "finish"])
def test_an_error_reaches_every_waiter(impl, where):
    def handler(queries):
        raise RuntimeError("boom")

    def begin(queries):
        if where == "begin":
            raise RuntimeError("boom in begin")

        def finish():
            raise RuntimeError("boom in finish")
        return finish

    b = (impl.MicroBatcher(handler, max_batch=4, max_wait_ms=5)
         if where == "sync" else pipelined(impl, begin))
    try:
        with ThreadPoolExecutor(4) as ex:
            futures = [ex.submit(b.submit, i) for i in range(4)]
            for f in futures:
                with pytest.raises(RuntimeError, match="boom"):
                    f.result(timeout=5)
        assert b._inflight == 0 and b._inflight_batches == 0
    finally:
        b.stop()


@pytest.mark.parametrize("mode", ["sync", "pipelined"])
def test_a_wrong_result_count_is_an_error(impl, mode):
    b = (impl.MicroBatcher(lambda qs: [1], max_batch=4, max_wait_ms=20)
         if mode == "sync" else pipelined(impl, lambda qs: lambda: [0]))
    try:
        with ThreadPoolExecutor(3) as ex:
            futures = [ex.submit(b.submit, i) for i in range(3)]
            errors = 0
            for f in futures:
                try:
                    f.result(timeout=5)
                except RuntimeError as e:
                    assert "results for" in str(e)
                    errors += 1
        # a window of one gets its one result; every window of more
        # queries fails all of them: never a silent wrong answer
        assert errors != 1
        assert b.n_batches == 3 or errors >= 2
    finally:
        b.stop()


def test_windows_overlap(impl):
    release = threading.Event()
    dispatched = []

    def begin(queries):
        dispatched.append(tuple(queries))

        def finish():
            release.wait(5)
            return list(queries)
        return finish

    b = pipelined(impl, begin, inflight=2)
    try:
        with ThreadPoolExecutor(4) as ex:
            f1 = ex.submit(b.submit, 1)
            assert wait_until(lambda: dispatched)
            f2 = ex.submit(b.submit, 2)
            assert wait_until(lambda: len(dispatched) >= 2), \
                "the second window never dispatched while the first was " \
                "in flight"
            release.set()
            assert f1.result(timeout=5) == 1 and f2.result(timeout=5) == 2
    finally:
        release.set()
        b.stop()


def test_backpressure_caps_the_inflight_windows(impl):
    release = threading.Event()
    max_seen = [0]

    def begin(queries):
        def finish():
            release.wait(10)
            return list(queries)
        return finish

    b = pipelined(impl, begin, inflight=2)
    try:
        with ThreadPoolExecutor(6) as ex:
            futures = [ex.submit(b.submit, i) for i in range(6)]
            deadline = time.perf_counter() + 3
            while time.perf_counter() < deadline:
                max_seen[0] = max(max_seen[0], b._inflight_batches)
                if b.n_pipeline_stalls > 0:
                    break
                time.sleep(0.002)
            assert max_seen[0] <= 2
            release.set()
            assert sorted(f.result(timeout=10)
                          for f in futures) == list(range(6))
        assert b.n_pipeline_stalls >= 1
        assert b.stats()["pipelineStalls"] == b.n_pipeline_stalls
    finally:
        release.set()
        b.stop()


def test_adaptive_target_is_a_capped_pow2(impl, monkeypatch):
    b = impl.MicroBatcher(lambda qs: qs, max_batch=16, max_wait_ms=5,
                          adaptive=True)
    try:
        monkeypatch.setattr(b, "_occupancy", lambda: 0.0)
        for undispatched in (1, 3, 5, 9, 40):
            b._undispatched = undispatched
            t = b._target_batch()
            assert t <= 16 and t & (t - 1) == 0
        b._undispatched = 0
    finally:
        b.stop()


def test_adaptive_target_and_window_scale_with_occupancy(impl,
                                                         monkeypatch):
    b = impl.MicroBatcher(lambda qs: qs, max_batch=16, max_wait_ms=100,
                          adaptive=True)
    try:
        b._undispatched = 5
        monkeypatch.setattr(b, "_occupancy", lambda: 0.0)
        idle_target = b._target_batch()
        p = type("P", (), {"t_enqueue": 0.0})()
        short = b._window_deadline(0.0, p)
        monkeypatch.setattr(b, "_occupancy", lambda: 0.9)
        busy_target = b._target_batch()
        full = b._window_deadline(0.0, p)
        b._undispatched = 0
        assert (idle_target, busy_target) == (8, 16)
        assert short == pytest.approx(0.025, rel=0.01)
        assert full == pytest.approx(0.100, rel=0.01)
    finally:
        b.stop()


def test_adaptive_window_dispatches_at_the_bucket(impl, monkeypatch):
    release = threading.Event()

    def handler(qs):
        release.wait(2)
        return list(qs)

    b = impl.MicroBatcher(handler, max_batch=16, max_wait_ms=500,
                          adaptive=True)
    monkeypatch.setattr(b, "_occupancy", lambda: 0.0)
    try:
        with ThreadPoolExecutor(8) as ex:
            futures = [ex.submit(b.submit, i) for i in range(4)]
            time.sleep(0.1)
            with b._flight_lock:
                b._undispatched += 2       # counted stragglers
            release.set()
            t0 = time.perf_counter()
            for f in futures:
                f.result(timeout=5)
            assert time.perf_counter() - t0 < 0.45
        with b._flight_lock:
            b._undispatched -= 2
        assert b.n_exit_adaptive + b.n_exit_drain_gate + b.n_exit_full \
            + b.n_exit_window == b.n_batches
    finally:
        b.stop()


def test_deadline_shedding(impl):
    started, release = threading.Event(), threading.Event()

    def handler(qs):
        started.set()
        release.wait(5)
        return list(qs)

    b = impl.MicroBatcher(handler, max_batch=4, max_wait_ms=200,
                          adaptive=False)
    try:
        assert b.queue_wait_bound_s() == 0.0
        release.set()             # an idle batcher sheds nothing
        assert b.submit(1, deadline_s=0.001) == 1
        release.clear()
        started.clear()
        with ThreadPoolExecutor(2) as ex:
            f1 = ex.submit(b.submit, 2)
            assert started.wait(5) and wait_until(
                lambda: b.queue_wait_bound_s() > 0)
            with pytest.raises(impl.ShedError) as shed:
                b.submit(3, deadline_s=0.05)
            assert shed.value.http_status == 503
            assert shed.value.retry_after_s == pytest.approx(
                b.queue_wait_bound_s(), abs=0.05)
            assert shed.value.retry_after_s >= 0.2
            release.set()
            assert f1.result(timeout=5) == 2
        assert b.stats()["shedQueries"] == 1
    finally:
        release.set()
        b.stop()
