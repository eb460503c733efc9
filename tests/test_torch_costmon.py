"""Port parity: the cost monitor (`obs/costmon.py`) and the runtime
counters (`obs/torchmon.py`, the port's `obs/jaxmon.py`) vs the JAX
reference's, on the CPU.

- The same series of booked device times (each an extrapolated estimate
  on a scripted monotonic clock) gives both packages the same occupancy
  EWMA, tenant shares and gauge, exactly; the same sampled walls give
  the same p50/p99 views.
- Sampling is counted, not timed: with `PIO_DEVICE_SYNC_EVERY` N, the
  1st, (N+1)th, ... dispatch per label is sampled (both packages book
  the same number of samples over the same dispatches), every dispatch
  counts its enqueue wall, and a sampled dispatch that paid a compile
  books nothing; a callable that stamps its own work (a captured graph)
  has each sampled replay booked once, times N.
- `executable()` scopes count hits and misses and attribute compile
  seconds (an `nvcc` build or a graph capture here, a backend compile
  in the reference) alike, `defer_to_outer` included; the build
  directory's hits and misses are booked under the active label.
- The micro-batcher's adaptive target and straggler window read the
  cost monitor's occupancy and equal the reference's for the same
  reading and queue state.
- The transfer counters keep per-thread totals apart, and the device
  memory gauge renders no sample without a card, as the reference's
  renders none on CPU devices. The views' keys equal the reference's.
- `analyze_jit` reads what XLA's `cost_analysis()` reads for the same
  product (512 FLOPs, 512 bytes) and both packages' gauges carry it; the
  serve program counts at least its product's FLOPs.
No test bounds a wall-clock time.
"""

import threading

import numpy as np
import pytest

from predictionio_tpu.obs import costmon as JC
from predictionio_tpu.obs import jaxmon as JX
from predictionio_tpu.serving import batcher as JB
from predictionio_tpu_torch.obs import costmon as TC
from predictionio_tpu_torch.obs import torchmon as TX
from predictionio_tpu_torch.serving import batcher as TB


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


@pytest.fixture()
def fresh(monkeypatch):
    """Both cost monitors installed, with their occupancy windows, EWMAs,
    per-label states and tenant-labelled families reset, and
    `time.monotonic` a scripted clock."""
    clock = Clock()
    monkeypatch.setattr("time.monotonic", clock)
    for mod in (JC, TC):
        mod.install()
        for name, value in (("_occ_window_t0", None), ("_occ_acc", 0.0),
                            ("_occ_ewma", 0.0)):
            monkeypatch.setattr(mod, name, value)
        monkeypatch.setattr(mod, "_occ_acc_tenant", {})
        monkeypatch.setattr(mod, "_occ_share_ewma", {})
        monkeypatch.setattr(mod, "_dev_state", {})
        # the tenant-labelled families (`device_time_by_tenant` reads
        # one): empty and off the process registries, so no earlier
        # test's tenant time shows here and no tenant these tests book
        # (`a`, `b`) stays in a registry a later test scrapes
        for name in ("_c_device_s", "_c_dispatch_s", "_c_device_syncs",
                     "_g_tenant_occ"):
            fam = getattr(mod, name)
            monkeypatch.setattr(mod, name, type(fam)(fam.name, fam.help,
                                                     fam.labelnames))
    monkeypatch.setattr(TC, "_pending", [])
    return clock


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_same_booked_times_give_the_same_occupancy(fresh, seed):
    rng = np.random.default_rng(seed)
    tenants = ["", "", "a", "b"]
    for _ in range(300):
        dt = float(rng.choice([0.01, 0.2, 0.7, 1.3]))
        est = float(np.round(rng.exponential(0.05), 6))
        tenant = str(rng.choice(tenants))
        fresh.t += dt
        for mod in (JC, TC):
            mod._note_device_time(est, tenant)
        assert TC.occupancy() == JC.occupancy()
        assert TC.tenant_occupancy_shares() == JC.tenant_occupancy_shares()
    assert TC._g_occupancy.value == JC._g_occupancy.value
    assert TC.occupancy() > 0


@pytest.mark.parametrize("n", [1, 7, 128, 300])
def test_the_same_sampled_walls_give_the_same_percentiles(fresh, n):
    rng = np.random.default_rng(n)
    walls = rng.exponential(0.002, n)
    for mod in (JC, TC):
        st = mod._device_state("pct_probe")
        for w in walls:
            st.ring.append(float(w))
    assert TC.device_time_percentiles("pct_probe") == \
        JC.device_time_percentiles("pct_probe")
    assert TC.device_time_percentiles("no_such_label") is None


def test_one_sampled_timing_in_every_sixteen_dispatches(fresh, monkeypatch):
    """Both packages sample the 1st, 17th, 33rd... dispatch of a label,
    and count every dispatch's enqueue wall."""
    import jax.numpy as jnp
    import torch
    monkeypatch.setenv("PIO_DEVICE_SYNC_EVERY", "16")
    x_j, x_t = jnp.ones((4, 4)), torch.ones((4, 4))
    # compiled before any timed dispatch: a sample that compiles is
    # skipped, and the reference's first matmul would compile
    jnp.matmul(x_j, x_j).block_until_ready()
    for n in (1, 16, 17, 33, 40):
        label = f"sample_probe_{n}"
        for _ in range(n):
            JC.device_timed(label, jnp.matmul, x_j, x_j)
            TC.device_timed(label, torch.matmul, x_t, x_t)
        want = -(-n // 16)
        for mod in (JC, TC):
            syncs = mod._c_device_syncs.labels(executable=label, tenant="")
            assert syncs.value == want, (mod.__name__, n)
            st = mod._device_state(label)
            assert next(st.tick) == n
            assert mod.device_time_percentiles(label)["samples"] == want
        assert TC.dispatch_seconds_by_executable()[label] >= 0
    monkeypatch.setenv("PIO_DEVICE_SYNC_EVERY", "0")
    TC.device_timed("never_sampled", torch.matmul, x_t, x_t)
    assert TC.device_time_percentiles("never_sampled") is None


def test_a_sampled_dispatch_that_compiled_books_nothing(fresh):
    import torch

    def builds(a):
        TX.record_compile(0.5)
        return a * 2

    TC.device_timed("compiling_probe", builds, torch.ones(3))
    assert TC.device_time_percentiles("compiling_probe") is None
    TC.device_timed("compiling_probe", lambda a: a, torch.ones(3))
    assert TC.device_time_percentiles("compiling_probe") is None  # 2nd of 16


def test_executable_scopes_count_and_attribute_alike(fresh):
    def jax_compile(secs):
        JC._on_duration("/jax/core/compile/backend_compile_duration", secs)

    compiles = {JC: jax_compile, TC: TX.record_compile}
    for mod in (JC, TC):
        before = mod.cache_counts()
        sec0 = mod.compile_seconds_by_executable()
        with mod.executable("scope_probe"):
            pass
        with mod.executable("scope_probe"):
            compiles[mod](0.25)
        with mod.executable("outer_probe"):
            with mod.executable("scope_probe", defer_to_outer=True):
                compiles[mod](0.5)
        after = mod.cache_counts()
        sec1 = mod.compile_seconds_by_executable()

        def grew(kind, label):
            return (after[kind].get(label, 0)
                    - before[kind].get(label, 0))
        assert (grew("hits", "scope_probe"), grew("misses", "scope_probe"),
                grew("misses", "outer_probe")) == (1, 1, 1), mod.__name__
        assert sec1["scope_probe"] - sec0.get("scope_probe", 0) == 0.25
        assert sec1["outer_probe"] - sec0.get("outer_probe", 0) == 0.5
    assert TC._label_ctx.get() is None


def test_build_directory_hits_and_misses_book_under_the_label(fresh):
    before = TC.pcache_counts()
    with TC.executable("pcache_probe"):
        TX.record_pcache(hit=True)
        TX.record_pcache(hit=False)
        TX.record_pcache(hit=False)
    after = TC.pcache_counts()
    assert after["hits"]["pcache_probe"] - before["hits"].get(
        "pcache_probe", 0) == 1
    assert after["misses"]["pcache_probe"] - before["misses"].get(
        "pcache_probe", 0) == 2
    assert set(TC.pcache_totals()) == set(JC.pcache_totals())


@pytest.mark.parametrize("occ", [0.0, 0.2, 0.39, 0.4, 0.75, 1.0])
@pytest.mark.parametrize("undispatched,queued", [(0, 0), (1, 0), (5, 3),
                                                 (9, 20), (40, 40)])
def test_the_adaptive_target_follows_the_cost_monitor(
        monkeypatch, occ, undispatched, queued):
    monkeypatch.setattr(JC, "occupancy", lambda: occ)
    monkeypatch.setattr(TC, "occupancy", lambda: occ)
    monkeypatch.delenv("PIO_SERVE_ADAPT_OCC", raising=False)
    got = []
    for mod in (JB, TB):
        b = mod.MicroBatcher(lambda qs: qs, max_batch=16, max_wait_ms=100,
                             adaptive=True)
        try:
            # hold the formation thread before the state is built: running,
            # it takes the queued items before `_window_deadline` reads
            # the depth
            b._stop.set()
            b._thread.join(timeout=10)
            assert not b._thread.is_alive()
            b._undispatched = undispatched
            for _ in range(queued):
                b._q.put(None)
            p = type("P", (), {"t_enqueue": 0.0})()
            got.append((b._occupancy(), b._target_batch(),
                        b._window_deadline(0.0, p)))
        finally:
            while not b._q.empty():
                b._q.get_nowait()
            b._undispatched = 0
            b.stop()
    assert got[1] == got[0]


def test_transfer_counters_keep_threads_apart():
    for mon in (JX, TX):
        mine = mon.thread_h2d_total()
        total = mon.h2d_total()
        mon.record_h2d(1000)
        seen = {}

        def other():
            seen["before"] = mon.thread_h2d_total()
            mon.record_h2d(7)
            seen["after"] = mon.thread_h2d_total()

        t = threading.Thread(target=other)
        t.start()
        t.join()
        assert mon.h2d_delta(mine) == 1000
        assert seen["after"] - seen["before"] == 7
        assert mon.h2d_total() - total == 1007
        d0 = mon.thread_d2h_total()
        mon.record_d2h(24)
        assert mon.thread_d2h_total() - d0 == 24


def test_runtime_families_and_views_match_the_reference(fresh):
    from predictionio_tpu.obs import get_registry as j_reg
    from predictionio_tpu_torch.obs import get_registry as t_reg
    JX.install()
    TX.install()
    for name in ("pio_jax_compiles_total", "pio_jax_compile_seconds_total",
                 "pio_jax_host_to_device_bytes_total",
                 "pio_jax_device_to_host_bytes_total",
                 "pio_jax_device_memory_bytes"):
        j, t = j_reg().get(name), t_reg().get(name)
        assert (t.mtype, t.labelnames) == (j.mtype, j.labelnames), name
    # no card: no device memory sample, as on the reference's CPU devices
    assert TX._device_memory_samples() == []
    assert JX._device_memory_samples() == []
    for mod in (JC, TC):
        mod._device_state("view_probe").ring.append(0.001)
    tj, tt = JC.device_snapshot(), TC.device_snapshot()
    assert set(tt) == set(tj)
    assert tt["sampledWallMs"]["view_probe"] == \
        tj["sampledWallMs"]["view_probe"]
    assert tt["syncEvery"] == tj["syncEvery"]
    for fn in ("device_time_by_executable", "dispatch_seconds_by_executable",
               "device_time_by_tenant",
               "compile_seconds_by_executable", "cache_counts",
               "pcache_counts", "pcache_totals"):
        assert type(getattr(TC, fn)()) is type(getattr(JC, fn)()), fn
    assert (TC.ALS_SWEEP, TC.FOLD_SIDE, TC.BATCH_PREDICT,
            TC.BATCH_PREDICT_MASKED, TC.GATES_PROBE) == (
        JC.ALS_SWEEP, JC.FOLD_SIDE, JC.BATCH_PREDICT,
        JC.BATCH_PREDICT_MASKED, JC.GATES_PROBE)


class StampingGraph:
    """A stand-in for a captured graph: it stamps each replay's device
    time, hands a sampled one to its callback before the next replay,
    and `poll` reads a pending one when asked to wait."""

    records_events = True

    def __init__(self, seconds):
        self.seconds = iter(seconds)
        self.pending = None

    def __call__(self, x, sample=None):
        if self.pending is not None:
            self.poll(wait=True)
        self.stamp = next(self.seconds)
        self.pending = sample
        return x

    def poll(self, wait=False):
        if self.pending is None:
            return True
        if not wait:
            return False
        book, self.pending = self.pending, None
        book(self.stamp)
        return True


def test_a_stamping_graph_books_its_sampled_replays(fresh, monkeypatch):
    """A callable that stamps its own work (a captured graph on the card)
    gets the booking of its sampled dispatches as `sample=`: read before
    its next replay or when the views flush, booked once, times the
    sampling factor."""
    import torch
    monkeypatch.setenv("PIO_DEVICE_SYNC_EVERY", "4")
    graph = StampingGraph([0.001 * (k + 1) for k in range(9)])
    x = torch.ones(2)
    for _ in range(9):
        assert TC.device_timed("stamp_probe", graph, x) is x
    TC.flush()
    # the 1st, 5th and 9th dispatches: stamps 1, 5 and 9 ms, times 4
    assert TC.device_time_percentiles("stamp_probe")["samples"] == 3
    assert TC.device_samples_by_executable()["stamp_probe"] == 3
    assert TC.device_time_by_executable()["stamp_probe"] == \
        round(4 * (0.001 + 0.005 + 0.009), 4)
    TC.flush()
    assert TC.device_samples_by_executable()["stamp_probe"] == 3
    assert TC._pending == []


def test_analyze_jit_counts_what_xla_counts():
    """`analyze_jit` on the reference test's 8x4 @ 4x8 f32 product: XLA's
    `cost_analysis()` on the CPU reads 512 FLOPs and 512 bytes accessed;
    the port's counted run reads the same, and both packages' gauges
    carry the values under the label."""
    import jax.numpy as jnp
    import torch

    from predictionio_tpu.obs import get_registry as j_reg
    from predictionio_tpu_torch.obs import get_registry as t_reg
    j = JC.analyze_jit("analysis_parity", lambda a, b: a @ b,
                       jnp.ones((8, 4)), jnp.ones((4, 8)))
    t = TC.analyze_jit("analysis_parity", lambda a, b: a @ b,
                       torch.ones(8, 4), torch.ones(4, 8))
    assert j == t == {"flops": 512.0, "bytes_accessed": 512.0}
    for reg in (j_reg(), t_reg()):
        for name, key in (("pio_executable_flops", "flops"),
                          ("pio_executable_bytes_accessed",
                           "bytes_accessed")):
            fam = reg.get(name)
            assert fam.labelnames == ("executable",)
            got = {labels["executable"]: v
                   for labels, v in fam.samples() if labels}
            assert got["analysis_parity"] == t[key]


def test_cost_analysis_without_a_cost_and_a_failing_program():
    """Something without `cost_analysis()` banks nothing and reads None
    in both packages; a program that fails raises in the port (its run is
    the analysis), where the reference's lowering failure reads None."""
    import torch
    assert JC.record_cost_analysis("analysis_none", object()) is None
    assert TC.record_cost_analysis("analysis_none", object()) is None
    assert TC.record_cost_analysis(
        "analysis_obj", TC.CostAnalysis(7, 9)) == {
            "flops": 7.0, "bytes_accessed": 9.0}
    with pytest.raises(RuntimeError):
        TC.analyze_jit("analysis_bad", lambda a, b: a @ b,
                       torch.ones(8, 4), torch.ones(5, 8))


def test_analyze_jit_counts_the_serve_program():
    """The serve path's batched top-k program: at least the product's
    2*b*i*r FLOPs, and the bytes of its non-view aten ops (a view moves
    nothing), on the tensors' own device."""
    import functools

    import torch

    from predictionio_tpu_torch.ops import als as TA
    b, i, r = 4, 32, 8
    U, V = torch.ones(64, r), torch.ones(i, r)
    fn = functools.partial(TA._users_topk_b, U, V, n_items=30, k=16, p=0)
    got = TC.analyze_jit("analysis_serve", fn,
                         torch.zeros(b, dtype=torch.int64))
    assert got["flops"] == 2 * b * i * r
    assert got["bytes_accessed"] >= 4 * i * r
