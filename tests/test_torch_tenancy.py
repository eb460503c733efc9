"""Port parity: the tenancy plane (`tenancy/budget.py`, `tenancy/host.py`,
the tenant hooks of `utils/device_cache`, the result cache, the batcher
and the engine server) against the JAX package's, on the CPU.

The reference's classes of tests/test_tenancy.py run here, most for both
packages on the same numpy tables (rank 8, 64 users, 128 items): upload
tagging and eviction, the budget manager's admission and eviction order,
routing and result isolation, the host's /stats.json `tenants` block
keys and /metrics families, eviction correctness (byte-identical answers
after a re-upload, the quiesce skip, a neighbour's canary untouched, a
fold's invalidation kept to its tenant), removal, the `tenants` CLI's
lines, the accounting's dedup and the per-namespace generation fence;
and TestNoisyNeighborIsolation of tests/test_tenant_chaos.py. Across the
packages: the same queries give the same response bytes, the same
tenant-prefixed cache keys, the same eviction victims and the same
`estimate_padded_bytes` (all exact: no tolerance). The port's own
differences are held too: bytes are summed by storage (two views of one
storage count once) and an eviction drops the tenant's captured
executables, after which the next query is a miss answering the same
bytes.
"""

import datetime as dt
import gc
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.core import FirstServing as JFirstServing
from predictionio_tpu.data.bimap import BiMap as JBiMap
from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.data.storage.base import EngineInstance as JInstance
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.serving import result_cache as JRC
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu import tenancy as JT
from predictionio_tpu.tools import cli as JCli
from predictionio_tpu.utils import device_cache as JDC
from predictionio_tpu_torch import tenancy as TT
from predictionio_tpu_torch.compile import buckets as TB
from predictionio_tpu_torch.compile.aot import get_aot
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.obs import costmon
from predictionio_tpu_torch.serving import result_cache as TRC
from predictionio_tpu_torch.serving import server as TSrv
from predictionio_tpu_torch.tools import cli as TCli
from predictionio_tpu_torch.utils import device_cache as TDC
from predictionio_tpu_torch.weights import from_jax_model

RANK = 8
PKGS = ("jax", "torch")
TEN = {"jax": JT, "torch": TT}
DC = {"jax": JDC, "torch": TDC}
both = pytest.mark.parametrize("pkg", PKGS)


def tables(n_users=64, n_items=128, seed=0, const=None):
    rng = np.random.default_rng(seed)
    if const is not None:
        return (np.full((n_users, RANK), const, np.float32),
                np.ones((n_items, RANK), np.float32))
    return (rng.standard_normal((n_users, RANK)).astype(np.float32),
            rng.standard_normal((n_items, RANK)).astype(np.float32))


def rec_model(pkg, n_users=64, n_items=128, seed=0, const=None):
    U, V = tables(n_users, n_items, seed, const)
    users = [f"u{k}" for k in range(n_users)]
    items = [f"i{k}" for k in range(n_items)]
    if pkg == "jax":
        return JR.RecommendationModel(
            JALS.ALSModel(U, V, RANK),
            JMap(JBiMap({u: k for k, u in enumerate(users)})),
            JMap(JBiMap({i: k for k, i in enumerate(items)})))
    return from_jax_model(U, V, users, items, RANK, device="cpu")


def slot_server(pkg, host, key, model=None, algo=None, **cfg):
    """A loaded tenant-tagged engine server of `pkg` serving `model`
    (no storage round trip), as the reference's test builds it."""
    model = model if model is not None else rec_model(pkg)
    if pkg == "jax":
        srv = JSrv.EngineServer(
            JSrv.ServerConfig(ip="127.0.0.1", port=0, **cfg),
            engine=JR.RecommendationEngineFactory.apply(), tenant=key,
            shared_result_cache=host.result_cache)
        now = dt.datetime.now(dt.timezone.utc)
        srv.engine_instance = JInstance(
            id=f"inst-{key}", status="COMPLETED", start_time=now,
            end_time=now, engine_id=key, engine_version="0",
            engine_variant="t", engine_factory="recommendation")
        srv.algorithms = [algo or JR.ALSAlgorithm(
            JR.ALSAlgorithmParams(rank=RANK))]
        srv.models = [model]
        srv.serving = JFirstServing()
    else:
        srv = TSrv.EngineServer(
            TSrv.ServerConfig(port=0, **cfg),
            TR.RecommendationEngineFactory.apply(),
            TR.RecommendationEngineFactory.engine_params(
                TR.RatingsData([], [], [])),
            TrainResult(models=[model], algorithms=[algo or TR.ALSAlgorithm(
                TR.ALSAlgorithmParams(rank=RANK, device="cpu"))]),
            tenant=key, shared_result_cache=host.result_cache)
    srv.model_version = f"inst-{key}"
    srv.last_good_version = f"inst-{key}"
    return srv


def admit(pkg, host, key, model=None, **cfg):
    return host.admit_server(TEN[pkg].TenantSpec(key=key, engine_id=key),
                             slot_server(pkg, host, key, model, **cfg))


def call(port, path, body=None, method=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method=method or ("POST" if body is not None else "GET"),
        headers=headers or {})
    with urllib.request.urlopen(req, timeout=15) as resp:
        data = resp.read()
        ct = resp.headers.get("Content-Type", "")
        return resp.status, (json.loads(data) if "json" in ct
                             else data.decode())


def raw_query(port, key, body) -> bytes:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/engines/{key}/queries.json",
        data=json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=15) as resp:
        return resp.read()


def make_host(pkg, **cfg):
    return TEN[pkg].ServingHost(TEN[pkg].HostConfig(ip="127.0.0.1", port=0,
                                                    **cfg))


@pytest.fixture
def host(request, mesh8, tmp_env):
    pkg = request.param
    h = make_host(pkg)
    yield pkg, h
    h.stop()


hosts = pytest.mark.parametrize("host", PKGS, indirect=True)


def port_put(arr, device="cpu"):
    return TDC.cached_put(arr, device)


def storages(tensors) -> int:
    """Bytes of the distinct storages behind `tensors`, computed here."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[(str(t.device), st.data_ptr())] = st.nbytes()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# Upload tagging (the port's device_cache; the reference's four cases)
# ---------------------------------------------------------------------------

class TestDeviceCacheTenantAttribution:
    def test_scope_tags_uploads_and_evict_frees(self):
        TDC.clear()
        a = np.ones((32, 8), dtype=np.float32)
        b = np.ones((16, 8), dtype=np.float32)
        with TDC.tenant_scope("ta"):
            port_put(a)
        with TDC.tenant_scope("tb"):
            port_put(b)
        sizes = TDC.tenant_sizes()
        assert sizes["ta"] == a.nbytes and sizes["tb"] == b.nbytes
        dropped, freed = TDC.evict_tenant("ta")
        assert dropped == 1 and freed == a.nbytes
        sizes = TDC.tenant_sizes()
        assert "ta" not in sizes and sizes["tb"] == b.nbytes
        with TDC.tenant_scope("ta"):
            port_put(a)
        assert TDC.tenant_sizes()["ta"] == a.nbytes
        TDC.clear()

    def test_untagged_uploads_stay_unattributed(self):
        TDC.clear()
        a = np.ones((8, 8), dtype=np.float32)
        port_put(a)
        assert TDC.tenant_sizes() == {}
        assert TDC.cache_size() == 1
        TDC.clear()

    def test_resident_slots_tagged_and_evicted(self):
        TDC.clear()
        key_arr = np.ones((4, 4), dtype=np.float32)
        payload = {"U": torch.from_numpy(key_arr.copy())}
        with TDC.tenant_scope("tr"):
            TDC.put_resident("slot:tr", (key_arr,), payload)
        assert TDC.tenant_sizes()["tr"] == key_arr.nbytes
        dropped, freed = TDC.evict_tenant("tr")
        assert dropped == 1 and freed == key_arr.nbytes
        assert TDC.get_resident("slot:tr", (key_arr,)) is None
        TDC.clear()

    def test_gc_of_host_array_untags(self):
        # collect first and hold only this test's tenant: entries of
        # other tests alive in this worker are none of its business
        gc.collect()
        a = np.ones((8, 8), dtype=np.float32)
        with TDC.tenant_scope("tg"):
            port_put(a)
        assert TDC.tenant_sizes()["tg"] == a.nbytes
        del a
        gc.collect()
        assert "tg" not in TDC.tenant_sizes()

    def test_a_model_table_is_a_view_of_its_padded_upload(self):
        """The port's device table of a model is rows [:n] of the serve
        path's bucket-padded upload: one storage, tagged once, counted
        once, and a ranking that pads the view reads that storage."""
        TDC.clear()
        a = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
        target = TB.bucket_rows(100)
        with TDC.tenant_scope("tv"):
            view = TDC.cached_table(a, "cpu")
            padded = TDC.cached_put_rows(a, target, "cpu")
            again = TDC.cached_put_rows(view, target)
        assert view is TDC.cached_table(a, "cpu")
        assert view.shape == (100, 4) and np.array_equal(view.numpy(), a)
        assert view.untyped_storage().data_ptr() == \
            padded.untyped_storage().data_ptr() == \
            again.untyped_storage().data_ptr()
        assert not padded[100:].any()
        assert TDC.tenant_sizes()["tv"] == target * 4 * 4
        assert TDC.evict_tenant("tv")[1] == target * 4 * 4
        TDC.clear()

    def test_an_upload_outside_a_scope_is_claimed_by_its_reader(self):
        """The port's cache: an upload made outside any scope (a model
        placed before its tenant was admitted) is held by the first
        tenant that reads it; one made inside a scope keeps its tag."""
        TDC.clear()
        a = np.ones((8, 8), dtype=np.float32)
        b = np.ones((4, 8), dtype=np.float32)
        port_put(a)
        with TDC.tenant_scope("tb"):
            port_put(b)
        assert TDC.tenant_sizes() == {"tb": b.nbytes}
        with TDC.tenant_scope("ta"):
            port_put(a)
            port_put(b)
        assert TDC.tenant_sizes() == {"ta": a.nbytes, "tb": b.nbytes}
        TDC.clear()

    def test_views_of_one_storage_count_once(self):
        """The port sums storages: a payload holding a tensor and a view
        of it counts the storage's bytes once, in sizes and in freed."""
        TDC.clear()
        key_arr = np.ones((16, 4), dtype=np.float32)
        base = torch.zeros((32, 4))
        with TDC.tenant_scope("tv"):
            TDC.put_resident("slot:tv", (key_arr,),
                             {"U": base, "Uv": base[:16], "U2": base[16:]})
        assert TDC.tenant_sizes()["tv"] == base.nbytes
        assert TDC.evict_tenant("tv") == (1, base.nbytes)
        TDC.clear()


# ---------------------------------------------------------------------------
# The budget manager
# ---------------------------------------------------------------------------

class TestBudgetManager:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_estimate_counts_padded_buckets(self, seed):
        """The port's estimate equals the reference's on the same
        seeded shapes, and the bucket formula."""
        rng = np.random.default_rng(seed)
        shapes = [tuple(int(x) for x in rng.integers(1, 3000, 2))
                  for _ in range(3)]
        models = {pkg: [rec_model(pkg, nu, ni) for nu, ni in shapes]
                  for pkg in PKGS}
        port = TT.estimate_padded_bytes(models["torch"])
        ref = JT.estimate_padded_bytes(models["jax"])
        expect = sum((TB.bucket_rows(nu) + TB.bucket_rows(ni)) * RANK * 4
                     for nu, ni in shapes)
        assert port == ref == expect

    @both
    def test_admit_refuses_never_fits(self, pkg):
        mgr = TEN[pkg].HBMBudgetManager(budget_bytes=1024)
        with pytest.raises(DC[pkg].TableBudgetExceeded, match="NEVER fit"):
            mgr.admit("big", [rec_model(pkg, 512, 512)])
        assert mgr.snapshot()["tenants"] == {}

    @both
    def test_admit_within_budget_and_snapshot(self, pkg):
        mgr = TEN[pkg].HBMBudgetManager(budget_bytes=1 << 30)
        mgr.admit("ok", [rec_model(pkg)], priority=2, pinned=True)
        snap = mgr.snapshot()["tenants"]["ok"]
        assert snap["pinned"] and snap["priority"] == 2
        assert snap["expectedPaddedBytes"] == \
            TT.estimate_padded_bytes([rec_model("torch")])

    def test_ensure_room_evicts_coldest_unpinned_alike(self, mesh8):
        """The same admissions, uploads and hits through both managers
        evict the same tenants and keep the same sizes."""
        out = {}
        for pkg in PKGS:
            DC[pkg].clear()
            mgr = TEN[pkg].HBMBudgetManager(budget_bytes=10_000)
            arrs = {}
            for t in ("cold", "warm", "pinned"):
                arrs[t] = np.ones((64, 8), dtype=np.float32)   # 2 KiB
                mgr.admit(t, [], pinned=(t == "pinned"))
                with DC[pkg].tenant_scope(t):
                    (port_put if pkg == "torch" else JDC.cached_put)(
                        arrs[t])
            mgr.admit("incoming", [rec_model(pkg, 128, 128)])
            mgr.touch("cold")
            time.sleep(0.01)
            mgr.touch("warm")
            n = mgr.ensure_room("incoming")
            out[pkg] = (n, {t: b for t, b in mgr.sizes().items() if b})
            DC[pkg].clear()
        assert out["torch"] == out["jax"]
        n, sizes = out["torch"]
        assert n >= 1 and "cold" not in sizes and sizes["pinned"] > 0

    def test_a_cold_tenant_is_projected_at_what_it_last_held(self):
        """The port's projection: a tenant evicted while it held more
        than its padded estimate (its fold's residency, say) makes room
        for that much before it comes back, so the budget holds after
        its re-upload."""
        TDC.clear()
        mgr = TT.HBMBudgetManager(budget_bytes=10_000)
        big = np.ones((96, 16), dtype=np.float32)      # 6 KiB, estimate 0
        arrs = {"n1": np.ones((32, 16), dtype=np.float32),
                "n2": np.ones((48, 16), dtype=np.float32)}
        mgr.admit("big", [])
        with TDC.tenant_scope("big"):
            port_put(big)
        assert mgr.evict("big")["bytesFreed"] == big.nbytes
        for t, arr in arrs.items():                    # 2 KiB and 3 KiB
            mgr.admit(t, [])
            with TDC.tenant_scope(t):
                port_put(arr)
        mgr.touch("n2")
        assert mgr.ensure_room("big") == 1
        with TDC.tenant_scope("big"):
            port_put(big)
        assert mgr.resident_bytes() <= mgr.budget_bytes
        assert mgr.sizes() == {"big": big.nbytes, "n1": 0,
                               "n2": arrs["n2"].nbytes}
        TDC.clear()

    @both
    def test_no_budget_means_accounting_only(self, pkg, mesh8):
        DC[pkg].clear()
        mgr = TEN[pkg].HBMBudgetManager(budget_bytes=None)
        mgr.admit("t", [rec_model(pkg, 4096, 4096)])
        assert mgr.ensure_room("t") == 0
        a = np.ones((8, 8), dtype=np.float32)
        with DC[pkg].tenant_scope("t"):
            (port_put if pkg == "torch" else JDC.cached_put)(a)
        assert mgr.evict("t")["bytesFreed"] == a.nbytes
        DC[pkg].clear()


# ---------------------------------------------------------------------------
# Routing and isolation
# ---------------------------------------------------------------------------

class TestServingHostRouting:
    @hosts
    def test_routes_by_key_and_isolates_results(self, host):
        pkg, h = host
        admit(pkg, h, "a", rec_model(pkg, const=1.0))
        admit(pkg, h, "b", rec_model(pkg, const=2.0))
        h.start()
        port = h.config.port
        q = {"user": "u1", "num": 3}
        _, out_a = call(port, "/engines/a/queries.json", q)
        _, out_b = call(port, "/engines/b/queries.json", q)
        assert {s["score"] for s in out_a["itemScores"]} == {RANK * 1.0}
        assert {s["score"] for s in out_b["itemScores"]} == {RANK * 2.0}
        # the byte-identical query again: each from its own namespace
        _, out_a2 = call(port, "/engines/a/queries.json", q)
        assert out_a2 == out_a and h.result_cache.stats()["hits"] >= 1
        _, out_b2 = call(port, "/engines/b/queries.json", q)
        assert out_b2 == out_b != out_a

    def test_same_queries_same_bytes_and_cache_keys(self, mesh8, tmp_env):
        """Seeded tables of two tenants through both hosts: every answer
        is the same bytes, and the shared caches hold the same
        tenant-prefixed keys in the same LRU order."""
        rng = np.random.default_rng(3)
        queries = [("a" if rng.random() < 0.5 else "b",
                    {"user": f"u{int(rng.integers(64))}",
                     "num": int(rng.integers(1, 6))}) for _ in range(24)]
        got = {}
        for pkg in PKGS:
            h = make_host(pkg)
            try:
                admit(pkg, h, "a", rec_model(pkg, seed=1))
                admit(pkg, h, "b", rec_model(pkg, seed=2))
                h.start()
                bodies = [raw_query(h.config.port, k, q) for k, q in queries]
                keys = list(h.result_cache._entries)
                got[pkg] = (bodies, keys)
            finally:
                h.stop()
        assert got["torch"] == got["jax"]
        assert all(k.split(TRC.NS_SEP)[0] in ("a", "b")
                   for k in got["torch"][1])

    @hosts
    def test_unknown_tenant_404(self, host):
        pkg, h = host
        h.start()
        with pytest.raises(urllib.error.HTTPError) as ei:
            call(h.config.port, "/engines/nope/queries.json",
                 {"user": "u1", "num": 1})
        assert ei.value.code == 404

    def test_stats_and_metrics_surfaces(self, mesh8, tmp_env):
        """Both hosts' /stats.json `tenants` rows carry the same keys and
        values where they are not bytes or clocks, and both /metrics
        carry the host's families with the same labels."""
        got = {}
        for pkg in PKGS:
            h = make_host(pkg)
            try:
                admit(pkg, h, "a")
                h.start()
                port = h.config.port
                call(port, "/engines/a/queries.json", {"user": "u1",
                                                       "num": 2})
                _, stats = call(port, "/stats.json")
                _, tl = call(port, "/tenants.json")
                _, mtx = call(port, "/metrics")
                _, ts = call(port, "/engines/a/stats.json")
                got[pkg] = (stats, tl, mtx, ts)
            finally:
                h.stop()
        (js, jtl, jm, jts), (ts_, ttl, tm, tts) = got["jax"], got["torch"]
        t, j = ts_["tenants"]["a"], js["tenants"]["a"]
        assert set(t) == set(j)
        for k in ("tenant", "engineId", "modelVersion", "requests",
                  "errors", "inflight", "cold", "scheduler", "priority",
                  "pinned", "evictions", "expectedPaddedBytes"):
            assert t[k] == j[k], k
        assert t["requests"] == 1 and t["hbmBytes"] > 0
        assert set(ts_["budget"]) == set(js["budget"]) == {
            "budgetBytes", "residentBytes"}
        assert set(ttl["tenants"]) == set(jtl["tenants"]) == {"a"}
        for m in (tm, jm):
            assert 'pio_tenant_requests_total{tenant="a"} 1' in m
            assert 'pio_engine_hbm_bytes{tenant="a"}' in m
            assert "pio_host_tenants 1" in m
            assert "pio_tenant_hbm_budget_bytes 0" in m
        assert tts["tenant"] == "a" and tts["requests"] == 1
        assert jts["tenant"] == "a"

    def test_hbm_gauge_sums_the_live_storages(self, mesh8, tmp_env):
        """The port's gauge for a tenant equals the bytes of the distinct
        storages it holds, computed here from its tagged tensors; the
        device tables its models read are views of those storages (no
        copy of their own)."""
        TDC.clear()
        h = make_host("torch")
        try:
            admit("torch", h, "a")
            admit("torch", h, "b", rec_model("torch", 32, 64))
            h.start()
            for k in ("a", "b"):
                call(h.config.port, f"/engines/{k}/queries.json",
                     {"user": "u1", "num": 2})
            sizes = h.budget.sizes()
            tagged = TDC.tenant_device_arrays()
            for k in ("a", "b"):
                with TDC.tenant_scope(k):
                    held = [t for m in h.slots[k].server.models
                            for t in m.als.tables()]
                assert sizes[k] == storages(tagged[k]) \
                    == storages(tagged[k] + held) > 0
            _, mtx = call(h.config.port, "/metrics")
            for k in ("a", "b"):
                assert f'pio_engine_hbm_bytes{{tenant="{k}"}} ' \
                    f'{float(sizes[k])}' in mtx
            assert sum(sizes.values()) == \
                h.budget.snapshot()["residentBytes"]
        finally:
            h.stop()

    @hosts
    def test_bad_tenant_keys_refused(self, host):
        pkg, h = host
        for bad in ("", "a/b", "a\x1fb"):
            with pytest.raises(ValueError):
                h.admit_server(TEN[pkg].TenantSpec(key=bad, engine_id="x"),
                               slot_server(pkg, h, bad or "x"))

    @hosts
    def test_admit_server_requires_matching_tenant_tag(self, host):
        pkg, h = host
        with pytest.raises(ValueError, match="tenant"):
            h.admit_server(TEN[pkg].TenantSpec(key="wrong", engine_id="x"),
                           slot_server(pkg, h, "right"))


# ---------------------------------------------------------------------------
# Eviction
# ---------------------------------------------------------------------------

class TestEvictionCorrectness:
    @hosts
    def test_evict_readmit_serves_byte_identical(self, host):
        pkg, h = host
        admit(pkg, h, "a", result_cache=False)
        h.start()
        port = h.config.port
        q = {"user": "u2", "num": 5}
        before = raw_query(port, "a", q)
        assert h.budget.sizes().get("a", 0) > 0
        out = h.evict_tenant("a")
        assert out["bytesFreed"] > 0
        assert h.budget.sizes().get("a", 0) == 0
        assert raw_query(port, "a", q) == before
        assert h.budget.sizes().get("a", 0) > 0
        _, mtx = call(port, "/metrics")
        assert ('pio_tenant_evictions_total{tenant="a",'
                'reason="operator"} 1') in mtx

    @hosts
    def test_eviction_waits_for_inflight_window(self, host):
        pkg, h = host
        release, entered = threading.Event(), threading.Event()
        base = JR.ALSAlgorithm if pkg == "jax" else TR.ALSAlgorithm

        class SlowAlgo(base):
            def predict(self, model, query):
                entered.set()
                release.wait(timeout=10)
                return super().predict(model, query)

        params = (JR.ALSAlgorithmParams(rank=RANK) if pkg == "jax"
                  else TR.ALSAlgorithmParams(rank=RANK, device="cpu"))
        h.admit_server(TEN[pkg].TenantSpec(key="a", engine_id="a"),
                       slot_server(pkg, h, "a", algo=SlowAlgo(params),
                                   result_cache=False, micro_batch=1))
        h.start()
        results = []
        t = threading.Thread(target=lambda: results.append(call(
            h.config.port, "/engines/a/queries.json",
            {"user": "u1", "num": 2})))
        t.start()
        assert entered.wait(timeout=10)
        # a window in flight: a short quiesce budget skips the drop
        h.config.evict_quiesce_timeout_s = 0.05
        assert h.evict_tenant("a")["bytesFreed"] == 0
        release.set()
        t.join(timeout=10)
        assert results and results[0][0] == 200
        h.config.evict_quiesce_timeout_s = 10.0
        held = h.budget.sizes().get("a", 0)
        assert h.evict_tenant("a")["bytesFreed"] == held > 0

    @hosts
    def test_neighbor_eviction_preserves_canary_state(self, host):
        pkg, h = host
        slot_a = admit(pkg, h, "a", rec_model(pkg, const=1.0),
                       canary_fraction=0.5, canary_window_s=3600,
                       canary_min_requests=10**6)
        admit(pkg, h, "b", rec_model(pkg, const=2.0))
        h.start()
        port = h.config.port
        slot_a.server.swap_models([rec_model(pkg, const=3.0)],
                                  version="cand-a")
        assert slot_a.server.canary.active
        call(port, "/engines/b/queries.json", {"user": "u1", "num": 2})
        h.evict_tenant("b")
        assert slot_a.server.canary.active
        assert slot_a.server.canary.stats()["candidateVersion"] == "cand-a"
        assert slot_a.server.last_good_version == "inst-a"
        scores = set()
        for _ in range(6):
            _, out = call(port, "/engines/a/queries.json",
                          {"user": "u1", "num": 1})
            scores |= {s["score"] for s in out["itemScores"]}
        assert scores <= {RANK * 1.0, RANK * 3.0}

    @hosts
    def test_fold_swap_invalidates_only_own_tenant(self, host):
        pkg, h = host
        slot_a = admit(pkg, h, "a", rec_model(pkg, const=1.0))
        admit(pkg, h, "b", rec_model(pkg, const=2.0))
        h.start()
        port = h.config.port
        q = {"user": "u1", "num": 2}
        call(port, "/engines/a/queries.json", q)
        call(port, "/engines/b/queries.json", q)
        hits0 = h.result_cache.stats()["hits"]
        slot_a.server.swap_models([rec_model(pkg, const=4.0)],
                                  version="v2-a",
                                  touched_entities={"user": ["u1"]})
        _, out_b = call(port, "/engines/b/queries.json", q)
        assert h.result_cache.stats()["hits"] == hits0 + 1
        assert {s["score"] for s in out_b["itemScores"]} == {RANK * 2.0}
        _, out_a = call(port, "/engines/a/queries.json", q)
        assert {s["score"] for s in out_a["itemScores"]} == {RANK * 4.0}

    def test_eviction_releases_captured_executables(self, tmp_env,
                                                    monkeypatch):
        """The port's eviction drops the tenant's executables (on the
        CPU the held callable; a CUDA graph on the card): their keys are
        gone, the next query is a miss that captures again, and it
        answers the same bytes. The neighbour's executables stay."""
        monkeypatch.delenv("PIO_AOT", raising=False)
        aot = get_aot()

        def keys(model):
            return [k for k, refs in list(aot._refs.items())
                    if any(r() is model.als for r in refs)
                    and k in aot._compiled]

        def settle():
            for t in list(aot._threads):
                t.join(timeout=30)

        def misses():
            return aot.snapshot()["dispatchMisses"].get(
                costmon.BATCH_PREDICT, 0)

        h = make_host("torch")
        try:
            admit("torch", h, "a", result_cache=False)
            admit("torch", h, "b", result_cache=False)
            h.start()
            port = h.config.port
            q = {"user": "u3", "num": 4}
            before = raw_query(port, "a", q)
            raw_query(port, "b", q)
            settle()
            model_a = h.slots["a"].server.models[0]
            model_b = h.slots["b"].server.models[0]
            assert keys(model_a) and keys(model_b)
            h.evict_tenant("a")
            assert keys(model_a) == [] and keys(model_b)
            assert "a" not in TDC.tenant_sizes()
            m0 = misses()
            assert raw_query(port, "a", q) == before
            assert misses() == m0 + 1
            settle()
            assert keys(model_a)
        finally:
            h.stop()


class TestRemoveTenant:
    @hosts
    def test_remove_frees_and_unroutes(self, host):
        pkg, h = host
        admit(pkg, h, "a")
        h.start()
        port = h.config.port
        call(port, "/engines/a/queries.json", {"user": "u1", "num": 2})
        assert h.budget.sizes().get("a", 0) > 0
        assert h.remove_tenant("a")
        assert h.budget.sizes().get("a", 0) == 0
        assert "a" not in h.budget.snapshot()["tenants"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            call(port, "/engines/a/queries.json", {"user": "u1", "num": 1})
        assert ei.value.code == 404
        assert not h.remove_tenant("a")


# ---------------------------------------------------------------------------
# The tenants CLI
# ---------------------------------------------------------------------------

def mask(text: str) -> str:
    """A CLI's lines with the host's URL, byte counts, clocks and
    versions' timestamps masked (the rest must match)."""
    text = re.sub(r"http://127\.0\.0\.1:\d+", "URL", text)
    text = re.sub(r"(hbm=|hbmBytes\": |Bytes\": |bytesFreed\": )\s*\d+",
                  r"\1N", text)
    text = re.sub(r"\d+ HBM bytes", "N HBM bytes", text)
    text = re.sub(r"(idleSec|admittedAt)\": [0-9.e+-]+", r"\1\": T", text)
    return text


class TestTenantsCLI:
    def test_list_status_evict_pin_lines_match(self, mesh8, tmp_env,
                                               capsys):
        """The same verbs against each package's host print the same
        lines (bytes, clocks and the URL masked) and exit alike."""
        got = {}
        for pkg, cli in (("jax", JCli), ("torch", TCli)):
            h = make_host(pkg)
            try:
                admit(pkg, h, "a")
                h.start()
                url = f"http://127.0.0.1:{h.config.port}"
                call(h.config.port, "/engines/a/queries.json",
                     {"user": "u1", "num": 2})
                runs = []
                for argv in (["tenants", "list"], ["tenants", "pin", "a"],
                             ["tenants", "unpin", "a"],
                             ["tenants", "evict", "a"],
                             ["tenants", "evict", "zz"],
                             ["tenants", "status", "nope"]):
                    rc = cli.main(argv + ["--url", url])
                    runs.append((rc, mask(capsys.readouterr().out)))
                assert h.budget.sizes().get("a", 0) == 0
                got[pkg] = runs
            finally:
                h.stop()
        assert got["torch"] == got["jax"]
        rcs = [rc for rc, _ in got["torch"]]
        assert rcs == [0, 0, 0, 0, 1, 1]
        assert "1 tenant(s)" in got["torch"][0][1]
        assert '"bytesFreed"' in got["torch"][3][1]

    def test_status_and_signals_of_one_tenant(self, tmp_env, capsys):
        h = make_host("torch")
        try:
            admit("torch", h, "a")
            h.start()
            url = f"http://127.0.0.1:{h.config.port}"
            call(h.config.port, "/engines/a/queries.json",
                 {"user": "u1", "num": 2})
            assert TCli.main(["tenants", "status", "a", "--url", url]) == 0
            assert '"modelVersion": "inst-a"' in capsys.readouterr().out
            assert TCli.main(["tenants", "signals", "--url", url]) == 0
            out = capsys.readouterr().out
            assert out.startswith(f"Serving host at {url}: 1 tenant(s)")
            assert re.search(r"^  a\s+\S+\s+rps=", out, re.M)
            assert TCli.main(["tenants", "signals", "a", "--url", url]) == 0
            row = json.loads(capsys.readouterr().out)
            assert row["requests"] == 1 and row["hbmBytes"] > 0
        finally:
            h.stop()


# ---------------------------------------------------------------------------
# Accounting dedup and the per-namespace fence
# ---------------------------------------------------------------------------

class TestAccountingDedup:
    def test_sizes_dedup_sizer_vs_residency(self):
        TDC.clear()
        key_arr = np.ones((16, 4), dtype=np.float32)
        dev = torch.from_numpy(key_arr.copy())
        with TDC.tenant_scope("td"):
            TDC.put_resident("fold:td", (key_arr,), {"U": dev})
        mgr = TT.HBMBudgetManager(budget_bytes=None)
        mgr.admit("td", [], sizer=lambda: [dev, dev[:8]])
        assert mgr.sizes()["td"] == key_arr.nbytes
        TDC.clear()

    def test_evict_tenant_freed_bytes_deduped(self):
        TDC.clear()
        key_arr = np.ones((16, 4), dtype=np.float32)
        with TDC.tenant_scope("td"):
            dev = port_put(key_arr)
            TDC.put_resident("fold:td", (key_arr,), {"U": dev})
        assert TDC.evict_tenant("td") == (2, key_arr.nbytes)
        TDC.clear()


class TestGenerationFenceIsolation:
    def test_neighbor_invalidation_does_not_refuse_store(self):
        """The reference's case, and the same sequence's answers, through
        both packages' `TenantResultCache`."""
        got = {}
        for pkg, RC in (("jax", JRC), ("torch", TRC)):
            inner = RC.ResultCache(max_entries=64, max_bytes=1 << 20)
            a = RC.TenantResultCache(inner, "ta")
            b = RC.TenantResultCache(inner, "tb")
            gen_b = b.generation
            log = [a.invalidate_entities(["user:u1"]),
                   a.invalidate_all("reload")]
            key = RC.query_key({"user": "u9", "num": 1})
            log.append(b.put(key, b"B", ("user:u9",), generation=gen_b,
                             raw=b'{"user":"u9"}'))
            log.append(b.get(key))
            log.append(a.get(key))
            log.append(b.get_raw(b'{"user":"u9"}'))
            gen_b2 = b.generation
            log.append(b.invalidate_entities(["user:u9"]))
            log.append(b.put(key, b"B2", (), generation=gen_b2))
            log.append((a.generation, b.generation, inner.generation))
            log.append({k: v for k, v in b.stats().items()})
            got[pkg] = log
        assert got["torch"] == got["jax"]
        assert got["torch"][2] is True and got["torch"][3] == b"B"
        assert got["torch"][4] is None and got["torch"][7] is False


# ---------------------------------------------------------------------------
# TestNoisyNeighborIsolation of tests/test_tenant_chaos.py, on the port
# ---------------------------------------------------------------------------

@pytest.fixture
def incidents_tmp(tmp_path):
    from predictionio_tpu_torch.obs import get_incidents
    inc = get_incidents()
    saved = (inc._dir_override, inc.cooldown_s)
    inc.configure(incidents_dir=str(tmp_path / "incidents"), cooldown_s=0.0)
    inc._last_by_kind.clear()
    yield inc
    inc._dir_override, inc.cooldown_s = saved


def wait_for_incident(inc, tenant, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = [r for r in inc.list_incidents()
                if r.get("kind") == "slo_breach"
                and r.get("tenant") == tenant]
        if rows and all(os.path.exists(os.path.join(
                inc.incidents_dir(), r["id"], "metrics.prom"))
                for r in rows):
            return rows
        time.sleep(0.1)
    return []


def drive(port, key, n):
    for i in range(n):
        call(port, f"/engines/{key}/queries.json",
             {"user": f"u{i % 64}", "num": 2})


class TestNoisyNeighborIsolation:
    def test_breach_in_a_flips_only_a(self, tmp_env, incidents_tmp,
                                      monkeypatch):
        monkeypatch.setenv("PIO_SLO_SERVE_P99_MS__A", "0.001")
        h = make_host("torch")
        try:
            admit("torch", h, "a")
            admit("torch", h, "b", rec_model("torch", const=2.0))
            h.start()
            port = h.config.port
            call(port, "/health.json")
            drive(port, "a", 8)
            drive(port, "b", 8)
            _, hh = call(port, "/health.json")
            a, b = hh["tenants"]["a"], hh["tenants"]["b"]
            assert a["tenant"] == "a" and b["tenant"] == "b"
            serve_a = next(s for s in a["slo"] if s["name"] == "serve_p99")
            serve_b = next(s for s in b["slo"] if s["name"] == "serve_p99")
            assert a["status"] == "breached" and serve_a["burnFast"] > 14
            assert b["status"] in ("ok", "no_data")
            assert serve_b["status"] in ("ok", "no_data")
            assert hh["status"] == "breached"
            _, sig = call(port, "/tenants/signals.json")
            assert sig["tenants"]["a"]["sloStatus"] == "breached"
            assert sig["tenants"]["a"]["burnFast"] > 14
            assert sig["tenants"]["b"]["sloStatus"] in ("ok", "no_data")
        finally:
            h.stop()

    def test_incident_names_a_and_slices_out_b(self, tmp_env,
                                               incidents_tmp, monkeypatch):
        monkeypatch.setenv("PIO_SLO_SERVE_P99_MS__A", "0.001")
        h = make_host("torch")
        try:
            admit("torch", h, "a")
            admit("torch", h, "b")
            h.start()
            port = h.config.port
            call(port, "/health.json")
            drive(port, "a", 6)
            drive(port, "b", 6)
            call(port, "/health.json")
            rows = wait_for_incident(incidents_tmp, "a")
            assert rows, "breach in tenant a captured no incident"
            assert not any(r.get("tenant") == "b"
                           for r in incidents_tmp.list_incidents())
            d = os.path.join(incidents_tmp.incidents_dir(), rows[0]["id"])
            with open(os.path.join(d, "incident.json")) as f:
                meta = json.load(f)
            assert meta["tenant"] == "a"
            assert meta["context"]["tenant"] == "a"
            assert "engine_server.a" in meta["providers"]
            assert "engine_server.b" not in meta["providers"]
            with open(os.path.join(d, "flight.jsonl")) as f:
                recs = [json.loads(line) for line in f if line.strip()]
            assert all(r.get("tenant") in ("a", None) for r in recs)
            with open(os.path.join(d, "traces.json")) as f:
                traces = json.load(f)["traces"]
            assert all(t.get("root", {}).get("attrs", {}).get("tenant")
                       != "b" for t in traces)
        finally:
            h.stop()
