"""Port parity: the compile plane (`compile/buckets.py`,
`compile/aot.py`, `compile/cache.py`) and the upload cache
(`utils/device_cache.py`) vs the JAX reference's, on the CPU.

- Every bucket function equals the reference's over every n in 1..2^20
  (`bucket_rows`, `bucket_batch`, `occupancy`, `should_promote` on their
  own buckets and a floor) and over the shard counts and flag dims
  (`bucket_rows_sharded`, `bucket_key`, `bucket_label`).
- `cached_put`, `cached_put_padded` and `cached_put_rows` pad as the
  reference's do, element for element; a second call for the same host
  array returns the same device copy and uploads nothing; the copy goes
  with its host array.
- The executable registry with the CPU's holder (the eager callable): a
  dispatch with no executable misses, runs the fallback and adopts the
  bucket in the background, the next hits; a failed capture is memoized
  and not retried while the fallback serves; a blocking `ensure` waits
  for a capture in flight; the serve path captures no next bucket ahead
  of growth (a grown model is captured under its own key at its first
  window); an executable goes with its owner.
  The same miss/hit/failed sequence gives the reference's registry the
  same counts, and the snapshots carry the reference's keys.
- The build directory: its salt covers every kernel source and the
  flags, `cache_status` and `clear_cache(all_salts=)` act on the salted
  directories, a library found built is a hit and an `nvcc` run a miss,
  and `cache status|clear` prints them.
"""

import gc
import json
import logging
import threading

import numpy as np
import pytest
import torch

from predictionio_tpu.compile import aot as JA
from predictionio_tpu.compile import buckets as JB
from predictionio_tpu.utils import device_cache as JD
from predictionio_tpu_torch.compile import aot as TA
from predictionio_tpu_torch.compile import buckets as TB
from predictionio_tpu_torch.compile import cache as TCache
from predictionio_tpu_torch.obs import costmon as TC
from predictionio_tpu_torch.obs import torchmon as TX
from predictionio_tpu_torch.obs.metrics import MetricsRegistry as TReg
from predictionio_tpu_torch.ops import als as TALS
from predictionio_tpu_torch.utils import device_cache as TD


@pytest.mark.parametrize("fn", ["bucket_rows", "bucket_batch"])
@pytest.mark.parametrize("floor", [None, 1, 16, 64])
def test_row_and_batch_buckets_equal_the_reference(fn, floor):
    kw = {} if floor is None else {"floor": floor}
    jf, tf = getattr(JB, fn), getattr(TB, fn)
    ns = range(-2, (1 << 20) + 1)
    assert [tf(n, **kw) for n in ns] == [jf(n, **kw) for n in ns]


def test_constants_equal_the_reference():
    assert (TB.ROWS_FLOOR, TB.BATCH_FLOOR, TB.K_FLOOR, TB.PROMOTE_AT) == \
        (JB.ROWS_FLOOR, JB.BATCH_FLOOR, JB.K_FLOOR, JB.PROMOTE_AT)


def test_occupancy_and_promotion_equal_the_reference():
    for n in range(1, (1 << 20) + 1, 7):
        b = JB.bucket_rows(n)
        assert TB.occupancy(n, b) == JB.occupancy(n, b)
        assert TB.should_promote(n, b) == JB.should_promote(n, b)
        assert TB.should_promote(n, b, 0.5) == JB.should_promote(n, b, 0.5)
        assert TB.next_bucket(b) == JB.next_bucket(b)
    assert TB.occupancy(5, 0) == JB.occupancy(5, 0)


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7, 8])
def test_sharded_row_buckets_equal_the_reference(shards):
    ns = range(1, (1 << 20) + 1, 13)
    assert [TB.bucket_rows_sharded(n, shards) for n in ns] == \
        [JB.bucket_rows_sharded(n, shards) for n in ns]
    assert TB.bucket_rows_sharded(100, shards, floor=16) == \
        JB.bucket_rows_sharded(100, shards, floor=16)


def test_keys_and_labels_equal_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(500):
        dims = {k: int(rng.integers(0, 1 << 20)) for k in rng.choice(
            ["u", "i", "b", "k", "r", "s", "fp", "p"],
            int(rng.integers(1, 8)), replace=False)}
        assert TB.bucket_key(dims) == JB.bucket_key(dims)
        assert TB.bucket_label(dims) == JB.bucket_label(dims)
        assert hash(TB.bucket_key(dims)) == hash(JB.bucket_key(dims))
    assert TB.batch_ladder(16) == [1, 2, 4, 8, 16]
    assert TB.batch_ladder(20) == [1, 2, 4, 8, 16, 32]


@pytest.mark.parametrize("rows,target", [(5, 64), (64, 64), (70, 64),
                                         (1, 1), (3, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_cached_put_rows_pads_as_the_reference(rows, target, dtype):
    arr = (np.arange(rows * 3) - 4).astype(dtype).reshape(rows, 3)
    h0 = TX.h2d_total()
    t = TD.cached_put_rows(arr, target, "cpu")
    j = JD.cached_put_rows(arr, target)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.dtype == torch.from_numpy(arr).dtype
    uploaded = TX.h2d_total() - h0
    assert uploaded == np.asarray(j).nbytes
    # a second call is a hit: the same copy, nothing uploaded
    assert TD.cached_put_rows(arr, target, "cpu") is t
    assert JD.cached_put_rows(arr, target) is j
    assert TX.h2d_total() - h0 == uploaded


def test_cached_put_and_padded_equal_the_reference():
    arr = np.arange(30, dtype=np.float32).reshape(10, 3)
    t, j = TD.cached_put(arr, "cpu"), JD.cached_put(arr)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert TD.cached_put(arr, "cpu") is t
    for m in (1, 4, 8):
        tp = TD.cached_put_padded(arr, "cpu", m)
        jp = JD.cached_put_padded(arr, None, m)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert TD.cached_put_padded(arr, "cpu", m) is tp


def test_a_copy_goes_with_its_host_array():
    # collect first: entries whose host arrays an earlier test dropped
    # would otherwise go with this test's collect and shrink the count
    gc.collect()
    n0 = TD.cache_size()
    arr = np.ones((7, 2), np.float32)
    TD.cached_put_rows(arr, 64, "cpu")
    TD.cached_put(arr, "cpu")
    assert TD.cache_size() == n0 + 2
    del arr
    gc.collect()
    assert TD.cache_size() == n0


def test_a_tensor_is_padded_on_its_device_into_a_copy_of_its_own():
    t = torch.arange(6.0).reshape(3, 2)
    h0 = TX.h2d_total()
    p = TD.cached_put_rows(t, 64)
    assert p.shape == (64, 2) and torch.equal(p[:3], t) and not p[3:].any()
    exact = TD.cached_put_rows(t, 3)
    assert exact is not t and torch.equal(exact, t)
    assert TD.cached_put_rows(t, 64) is p
    assert TX.h2d_total() == h0


def test_residency_sizes_and_drop():
    a = np.zeros((4, 4), np.float32)
    TD.put_resident("size-probe", (a,), {"U": torch.zeros(8, 4),
                                        "pair": (torch.zeros(2), None)})
    assert TD.resident_sizes()["size-probe"] == 8 * 4 * 4 + 2 * 4
    assert TD._device_nbytes(torch.zeros(3, dtype=torch.float64)) == 24
    assert TD._device_nbytes(np.zeros(5, np.int8)) == 5
    TD.drop_resident("size-probe")
    assert "size-probe" not in TD.resident_sizes()


class Owner:
    """A stand-in model: what an executable is bound to."""


def eager_builder(calls):
    def builder(bound, b=0, k=0):
        calls.append((b, k))
        if k < 0:
            raise RuntimeError("capture failed")
        return (lambda x: x * k), (torch.zeros(b),)
    return builder


def test_registry_hit_miss_failed_and_adoption(caplog):
    # a captured log record of the failure would hold its traceback, and
    # so the owner, past the test's collection check
    caplog.set_level(logging.CRITICAL, logger=TA.__name__)
    # counters of its own: the process registry's count every test's
    reg = TA.AOTRegistry(registry=TReg())
    calls = []
    reg.register("probe", eager_builder(calls))
    owner = Owner()
    dims = {"b": 4, "k": 3}
    x = torch.ones(4)
    # a miss: the fallback answers, a background capture adopts the bucket
    out = reg.dispatch("probe", dims, lambda a: a + 100, x, bound=(owner,))
    assert torch.equal(out, x + 100)
    for t in list(reg._threads):
        t.join(10)
    assert reg.lookup("probe", dims, (owner,)) is not None
    out = reg.dispatch("probe", dims, lambda a: a + 100, x, bound=(owner,))
    assert torch.equal(out, x * 3)
    snap = reg.snapshot()
    assert (snap["dispatchHits"], snap["dispatchMisses"]) == \
        ({"probe": 1.0}, {"probe": 1.0})
    assert snap["hitRate"] == 0.5 and snap["executablesResident"] == 1
    assert snap["bucketsCompiled"] == {"probe": ["b4-k3"]}
    # a failed capture is memoized: no retry, the fallback keeps serving
    bad = {"b": 4, "k": -1}
    assert reg.ensure("probe", bad, (owner,)) is None
    n = len(calls)
    for _ in range(3):
        out = reg.dispatch("probe", bad, lambda a: a - 1, x, bound=(owner,))
        assert torch.equal(out, x - 1)
    for t in list(reg._threads):
        t.join(10)
    assert len(calls) == n and reg.snapshot()["failedBuckets"] == 1
    assert isinstance(reg.failure("probe", bad, (owner,)), RuntimeError)
    spare = Owner()     # the raised error's frames hold what warm() got
    with pytest.raises(RuntimeError, match="capture failed"):
        reg.warm([("probe", bad, (spare,))], strict=True)
    # another owner is another key; an owner's executables go with it
    other = Owner()
    assert reg.ensure("probe", dims, (other,)) is not None
    assert reg.snapshot()["executablesResident"] == 2
    del owner
    gc.collect()
    snap = reg.snapshot()
    assert snap["executablesResident"] == 1
    assert snap["failedBuckets"] == 1      # the spare's


def test_the_reference_registry_counts_the_same_sequence():
    """The same miss, adoption, hit and failed-bucket sequence through
    the reference's registry (a jitted program, its bucket compiled in
    the background) gives the same counts."""
    import jax
    import jax.numpy as jnp
    from predictionio_tpu.obs.metrics import MetricsRegistry as JReg

    def jbuilder(b=0, k=0):
        if k < 0:
            raise RuntimeError("compile failed")
        fn = jax.jit(lambda x: x * k)
        return fn, (jax.ShapeDtypeStruct((b,), jnp.float32),), {}

    regs = {"jax": JA.AOTRegistry(registry=JReg()),
            "port": TA.AOTRegistry(registry=TReg())}
    regs["jax"].register("probe", jbuilder)
    regs["port"].register("probe", eager_builder([]))
    owner = Owner()
    out = {}
    for name, reg in regs.items():
        kw = {} if name == "jax" else {"bound": (owner,)}
        x = jnp.ones(4) if name == "jax" else torch.ones(4)
        for dims in ({"b": 4, "k": 3}, {"b": 4, "k": 3}, {"b": 8, "k": -1},
                     {"b": 8, "k": -1}):
            reg.dispatch("probe", dims, lambda a: a, x, **kw)
            for t in list(reg._threads):
                t.join(30)
        s = reg.snapshot()
        out[name] = {k: s[k] for k in ("dispatchHits", "dispatchMisses",
                                       "hitRate", "failedBuckets",
                                       "executablesResident", "inflight")}
        assert set(regs["jax"].snapshot()) <= set(s) | {"xlaCache"}
    assert out["port"] == out["jax"]


def test_a_blocking_ensure_waits_for_the_capture_in_flight():
    reg = TA.AOTRegistry(registry=TReg())
    started, release = threading.Event(), threading.Event()

    def slow(bound, b=0):
        started.set()
        release.wait(10)
        return (lambda x: x), (torch.zeros(b),)

    reg.register("slow", slow)
    owner = Owner()
    assert reg.ensure("slow", {"b": 2}, (owner,), background=True) is None
    started.wait(10)
    got = {}
    waiter = threading.Thread(target=lambda: got.setdefault(
        "exe", reg.ensure("slow", {"b": 2}, (owner,))))
    waiter.start()
    assert reg.snapshot()["inflight"] == 1 and "exe" not in got
    release.set()
    waiter.join(10)
    assert got["exe"] is not None and got["exe"] is reg.lookup(
        "slow", {"b": 2}, (owner,))
    assert reg.compile_count == 1


def test_the_serve_path_captures_no_next_bucket(monkeypatch):
    """A model whose items fill 3/4 of their row bucket has no next
    bucket captured: a graph is keyed on its model, whose buckets never
    change, so it could never replay. A grown model (a new object) misses
    at its first window, answers through the eager program, and is then
    captured under its own key, which its next window replays."""
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    rng = np.random.default_rng(1)
    m = TALS.ALSModel(rng.standard_normal((40, 4)).astype(np.float32),
                      rng.standard_normal((50, 4)).astype(np.float32), 4,
                      torch.device("cpu"))
    aot = TA.get_aot()
    dims = TALS.batch_predict_dims(m, 3, 5)
    assert TB.should_promote(m.n_items, dims["i"])
    TALS.users_topk_serve(m, [0, 1, 2], 5)
    for t in list(aot._threads):
        t.join(10)
    promoted = dict(dims, i=128, k=16)
    assert aot.lookup(TC.BATCH_PREDICT, dims, (m,)) is not None
    assert aot.lookup(TC.BATCH_PREDICT, promoted, (m,)) is None
    grown = TALS.ALSModel(
        m.user_factors,
        np.concatenate([m.item_factors, rng.standard_normal(
            (30, 4)).astype(np.float32)]), 4, torch.device("cpu"))
    gdims = TALS.batch_predict_dims(grown, 3, 5)
    assert gdims["i"] == 128
    s0 = aot.snapshot()
    s, i = TALS.users_topk_serve(grown, [0, 1, 2], 5)
    for t in list(aot._threads):
        t.join(10)
    s1 = aot.snapshot()
    assert s1["dispatchMisses"][TC.BATCH_PREDICT] == \
        s0["dispatchMisses"].get(TC.BATCH_PREDICT, 0) + 1
    assert aot.lookup(TC.BATCH_PREDICT, gdims, (grown,)) is not None
    assert aot.lookup(TC.BATCH_PREDICT, gdims, (m,)) is None
    S = grown.user_factors[:3] @ grown.item_factors.T
    np.testing.assert_array_equal(i[:, :5], np.argsort(-S, axis=1)[:, :5])
    # the grown model's next window replays (on the CPU: the held
    # callable)
    TALS.users_topk_serve(grown, [3, 4, 5], 5)
    assert aot.snapshot()["dispatchHits"][TC.BATCH_PREDICT] == \
        s1["dispatchHits"].get(TC.BATCH_PREDICT, 0) + 1


def test_a_tenant_slot_captures_no_next_bucket(monkeypatch):
    """Under a tenant's scope the port's serve path captures no next
    bucket: the graph would be keyed on this model, whose buckets never
    change, and would hold a padded table outside the host's budget."""
    from predictionio_tpu_torch.obs.tenantctx import tenant_scope
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    rng = np.random.default_rng(1)
    m = TALS.ALSModel(rng.standard_normal((40, 4)).astype(np.float32),
                      rng.standard_normal((50, 4)).astype(np.float32), 4,
                      torch.device("cpu"))
    aot = TA.get_aot()
    dims = TALS.batch_predict_dims(m, 3, 5)
    assert TB.should_promote(m.n_items, dims["i"])
    with tenant_scope("slot"):
        TALS.users_topk_serve(m, [0, 1, 2], 5)
    for t in list(aot._threads):
        t.join(10)
    assert aot.lookup(TC.BATCH_PREDICT, dims, (m,)) is not None
    assert aot.lookup(TC.BATCH_PREDICT, dict(dims, i=128, k=16),
                      (m,)) is None


def test_warm_models_follows_the_switches(monkeypatch):
    from predictionio_tpu_torch.models import recommendation as TR
    rng = np.random.default_rng(2)
    m = TALS.ALSModel(rng.standard_normal((10, 4)).astype(np.float32),
                      rng.standard_normal((12, 4)).astype(np.float32), 4,
                      torch.device("cpu"))
    model = TR.RecommendationModel(m, None, None)
    algo = TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=4, device="cpu"))
    monkeypatch.setenv("PIO_AOT_WARM", "off")
    assert TA.warm_models([algo], [model])["disabled"]
    monkeypatch.setenv("PIO_AOT_WARM", "on")
    out = TA.warm_models([algo], [model], batch_hint=4, version="vX")
    assert out["specs"] == out["compiled"] == 6      # 2 labels x b 1, 2, 4
    assert TA.get_aot().snapshot()["versions"]["vX"] == {
        TC.BATCH_PREDICT: ["b1-i64-k16-p1-r4-u64", "b2-i64-k16-p1-r4-u64",
                           "b4-i64-k16-p1-r4-u64"],
        TC.BATCH_PREDICT_MASKED: ["b1-fp0-i64-k16-p1-r4",
                                  "b2-fp0-i64-k16-p1-r4",
                                  "b4-fp0-i64-k16-p1-r4"]}
    monkeypatch.setenv("PIO_AOT", "off")
    assert TA.warm_models([algo], [model])["disabled"]
    assert TA.aot_enabled() is False and JA.aot_enabled() is False
    assert TA.shared_jit("k", len) is TA.shared_jit("k", min) is len


@pytest.fixture()
def build_root(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a", "b"):
        (src / f"{name}.cu").write_text(f"// kernel {name}\n")
    monkeypatch.setattr(TCache, "CSRC_DIR", src)
    monkeypatch.setattr(TCache, "_salt_memo", None)
    monkeypatch.setenv("PIO_BUILD_CACHE_DIR", str(tmp_path / "build"))
    return tmp_path


def test_the_salt_covers_every_source_and_the_flags(build_root,
                                                    monkeypatch):
    salt = TCache.cache_salt()
    assert len(salt) == 12 and TCache.cache_dir().name == salt
    (build_root / "csrc" / "b.cu").write_text("// kernel b, edited\n")
    monkeypatch.setattr(TCache, "_salt_memo", None)
    edited = TCache.cache_salt()
    assert edited != salt
    monkeypatch.setattr(TCache, "_salt_memo", None)
    monkeypatch.setattr(TCache, "NVCC_FLAGS", TCache.NVCC_FLAGS + ("-G",))
    assert TCache.cache_salt() not in (salt, edited)


def test_the_salt_covers_the_toolchain(build_root, monkeypatch):
    """A library built by another machine's compilers (a checkout copied
    between hosts) lies under another salt and is never loaded."""
    salt = TCache.cache_salt()
    here = TCache.toolchain_id
    monkeypatch.setattr(TCache, "_salt_memo", None)
    monkeypatch.setattr(TCache, "toolchain_id",
                        lambda: "x86_64\nglibc 2.99\ng++ (other) 99.1\n")
    assert TCache.cache_salt() != salt
    monkeypatch.setattr(TCache, "_salt_memo", None)
    monkeypatch.setattr(TCache, "toolchain_id", here)
    assert TCache.cache_salt() == salt


def test_status_and_clear_act_on_the_salted_directories(build_root,
                                                         capsys):
    from predictionio_tpu_torch.tools import cli
    active = TCache.cache_dir()
    stale = TCache.cache_root() / "0123456789ab"
    for d, names in ((active, ("a.so", "b.so", "a.log")), (stale, ("a.so",))):
        d.mkdir(parents=True)
        for n in names:
            (d / n).write_bytes(b"x" * 10)
    st = TCache.cache_status()
    assert (st["libraries"], st["entries"], st["bytes"]) == \
        (["a.so", "b.so"], 3, 30)
    assert st["staleSalts"] == ["0123456789ab"]
    assert cli.main(["cache", "status"]) == 0
    assert json.loads(capsys.readouterr().out)["dir"] == str(active)
    assert cli.main(["cache", "clear"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["removed"], out["dirs"]) == (3, [str(active)])
    assert stale.is_dir() and not active.exists()
    assert TCache.clear_cache(all_salts=True)["dirs"] == [str(stale)]
    assert not stale.exists()


def test_a_library_found_built_is_a_hit_and_a_build_a_miss(build_root,
                                                            monkeypatch):
    from predictionio_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC_DIR", build_root / "csrc")
    monkeypatch.setattr(_build, "_counted", set())
    monkeypatch.setattr(_build, "BUILDS", _build.BuildCounts())
    d = TCache.cache_dir()
    d.mkdir(parents=True)
    (d / "a.so").write_bytes(b"")

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "wb").close()
            return "ptxas info: 0 bytes spill", None

    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    before = TC.pcache_counts()
    TX.install()
    from predictionio_tpu_torch.obs import get_registry
    compiles = get_registry().get("pio_jax_compiles_total")
    n0 = compiles.value
    with TC.executable("build_probe"):
        secs = _build.build_all(["a", "b"])
        _build.build_all(["a", "b"])          # counted once a process
    after = TC.pcache_counts()
    assert secs["a"] == 0.0 and (d / "b.so").exists()
    assert after["hits"]["build_probe"] - before["hits"].get(
        "build_probe", 0) == 1
    assert after["misses"]["build_probe"] - before["misses"].get(
        "build_probe", 0) == 1
    assert compiles.value - n0 == 1 and _build.BUILDS.builds == 1
