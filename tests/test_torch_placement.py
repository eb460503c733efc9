"""Port parity: the fleet's tenant control plane (`tenancy/placement.py`,
`tenancy/controller.py`, `tenancy/props.py`, `tenancy/auth.py`, the
scheduler's `FoldTickGate` and the host's generation fence) against the
JAX package's, on the CPU.

The reference's seven classes of tests/test_placement.py run here: the
planner's golden tables run over both packages' planners, and seeded
random fleets must give equal decision lists from `plan_placement`,
`plan_failover` and `plan_rebalance` in both (exact). `FoldTickGate`
grants one scripted arrival order alike in both. The access-key gate,
fleet records, durable props, the generation fence and the controller
with its router run on the port's host (rank 8, 64 users, 128 items);
`placement status` and `plan` print the same lines from both packages'
CLIs over one fleet registry.
"""

import datetime as dt
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.online import scheduler as JSched
from predictionio_tpu.tenancy import placement as JP
from predictionio_tpu.tools import cli as JCli
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.obs import fleet
from predictionio_tpu_torch.obs.metrics import MetricsRegistry
from predictionio_tpu_torch.online import scheduler as TSched
from predictionio_tpu_torch.resilience import RetryPolicy
from predictionio_tpu_torch.serving import server as TSrv
from predictionio_tpu_torch.tenancy import (HostConfig, ServingHost,
                                            TenantSpec)
from predictionio_tpu_torch.tenancy import placement as TP
from predictionio_tpu_torch.tenancy import props as tenant_props
from predictionio_tpu_torch.tenancy.auth import AccessKeyGate
from predictionio_tpu_torch.tenancy.controller import (PlacementController,
                                                       TenantRouter)
from predictionio_tpu_torch.tools import cli as TCli
from predictionio_tpu_torch.weights import from_jax_model

RANK = 8
PLANNERS = {"jax": JP, "torch": TP}
planners = pytest.mark.parametrize("P", [JP, TP], ids=["jax", "torch"])


def rec_model(n_users=64, n_items=128, const=None):
    if const is not None:
        U = np.full((n_users, RANK), const, np.float32)
        V = np.ones((n_items, RANK), np.float32)
    else:
        rng = np.random.default_rng(0)
        U = rng.standard_normal((n_users, RANK)).astype(np.float32)
        V = rng.standard_normal((n_items, RANK)).astype(np.float32)
    return from_jax_model(U, V, [f"u{k}" for k in range(n_users)],
                          [f"i{k}" for k in range(n_items)], RANK,
                          device="cpu")


def slot_server(host, key, model=None, **cfg):
    srv = TSrv.EngineServer(
        TSrv.ServerConfig(port=0, **cfg),
        TR.RecommendationEngineFactory.apply(),
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[model or rec_model()], algorithms=[
            TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=RANK,
                                                  device="cpu"))]),
        tenant=key, shared_result_cache=host.result_cache)
    srv.model_version = srv.last_good_version = f"inst-{key}"
    return srv


def call(port, path, body=None, method=None, headers=None):
    """(status, parsed body), error statuses included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode() if body is not None else None,
        method=method or ("POST" if body is not None else "GET"),
        headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=15) as resp:
            raw, ct = resp.read(), resp.headers.get("Content-Type", "")
            status = resp.status
    except urllib.error.HTTPError as e:
        raw, ct = e.read(), e.headers.get("Content-Type", "")
        status = e.code
    return status, (json.loads(raw) if "json" in ct else raw.decode())


@pytest.fixture
def host(tmp_env):
    h = ServingHost(HostConfig(ip="127.0.0.1", port=0))
    yield h
    h.stop()


def tv(P, key, hbm, prio=0, pinned=False, traffic=0.0):
    return P.TenantView(key=key, hbm_bytes=hbm, priority=prio,
                        pinned=pinned, traffic_ewma=traffic)


def hv(P, mid, budget, tenants=(), alive=True):
    return P.HostView(member_id=mid, url=f"http://x/{mid}",
                      budget_bytes=budget, alive=alive,
                      tenants={t.key: t for t in tenants})


# ---------------------------------------------------------------------------
# The planner: the reference's golden tables over both, seeded parity
# ---------------------------------------------------------------------------

class TestPlacementPlanner:
    @planners
    def test_spread_picks_most_free_host(self, P):
        hosts = [hv(P, "h1", 100, [tv(P, "a", 60)]),
                 hv(P, "h2", 100, [tv(P, "b", 10)])]
        plan = P.plan_placement(hosts, [tv(P, "c", 30)])
        assert [d.as_dict() for d in plan.decisions] == [
            {"action": "admit", "tenant": "c", "host": "h2",
             "reason": "fits free budget"}]

    @planners
    def test_unbounded_host_always_fits(self, P):
        plan = P.plan_placement([hv(P, "h1", 10), hv(P, "h2", None)],
                                [tv(P, "big", 10 ** 12)])
        assert plan.admits[0].host == "h2" and not plan.refusals

    @planners
    def test_priority_then_size_ordering(self, P):
        plan = P.plan_placement([hv(P, "h1", 100)], [
            tv(P, "small-hi", 10, prio=5), tv(P, "big-lo", 80, prio=0),
            tv(P, "big-hi", 40, prio=5)])
        assert [d.tenant for d in plan.decisions] == [
            "big-hi", "small-hi", "big-lo"]
        assert plan.refusals[0].tenant == "big-lo"
        assert "no feasible host" in plan.refusals[0].reason

    @planners
    def test_preemption_evicts_coldest_lower_priority(self, P):
        hosts = [hv(P, "h1", 100, [tv(P, "cold", 40, traffic=0.1),
                                   tv(P, "hot", 40, traffic=50.0)]),
                 hv(P, "h2", 100, [tv(P, "z", 60)])]
        plan = P.plan_placement(hosts, [tv(P, "vip", 50, prio=9)])
        acts = {(d.action, d.tenant): d for d in plan.decisions}
        assert ("preempt", "cold") in acts
        assert ("preempt", "hot") not in acts
        assert acts[("admit", "vip")].host == "h1"
        assert acts[("admit", "cold")].host == "h2"

    @planners
    def test_preemption_never_touches_pinned_or_equal_priority(self, P):
        hosts = [hv(P, "h1", 100, [tv(P, "pinned", 60, pinned=True),
                                   tv(P, "peer", 40, prio=5)])]
        plan = P.plan_placement(hosts, [tv(P, "vip", 50, prio=5)])
        assert [d.action for d in plan.decisions] == ["refuse"]

    @planners
    def test_displaced_tenant_cannot_cascade(self, P):
        hosts = [hv(P, "h1", 100, [tv(P, "mid", 90, prio=5)]),
                 hv(P, "h2", 100, [tv(P, "low", 90, prio=1)])]
        plan = P.plan_placement(hosts, [tv(P, "vip", 90, prio=9)])
        acts = [(d.action, d.tenant) for d in plan.decisions]
        assert ("admit", "vip") in acts
        preempted = [t for a, t in acts if a == "preempt"]
        assert len(preempted) == 1 and ("refuse", preempted[0]) in acts

    @planners
    def test_refusal_is_honest_and_plan_pure(self, P):
        hosts = [hv(P, "h1", 10, [tv(P, "a", 5)])]
        plan = P.plan_placement(hosts, [tv(P, "big", 50, prio=9)])
        assert plan.refusals and "50 bytes" in plan.refusals[0].reason
        assert set(hosts[0].tenants) == {"a"}

    @planners
    def test_failover_places_only_on_survivors(self, P):
        dead = hv(P, "dead", 100, [tv(P, "a", 30), tv(P, "b", 30)],
                  alive=False)
        plan = P.plan_failover(
            [dead, hv(P, "s1", 100, [tv(P, "c", 80)]), hv(P, "s2", 100)],
            dead)
        assert {d.host for d in plan.admits} == {"s2"}
        assert {d.tenant for d in plan.admits} == {"a", "b"}

    @planners
    def test_rebalance_moves_coldest_unpinned_off_pressured_host(self, P):
        hosts = [hv(P, "h1", 100, [
            tv(P, "pinned-cold", 30, pinned=True),
            tv(P, "cold", 30, traffic=1.0), tv(P, "hot", 35, traffic=99.0)]),
            hv(P, "h2", 100, [tv(P, "z", 10)])]
        plan = P.plan_rebalance(hosts, pressure_ratio=0.9)
        (d,) = plan.decisions
        assert (d.action, d.tenant, d.from_host, d.host) == (
            "migrate", "cold", "h1", "h2")

    @planners
    def test_rebalance_quiet_fleet_plans_nothing(self, P):
        hosts = [hv(P, "h1", 100, [tv(P, "a", 30)]), hv(P, "h2", 100)]
        assert P.plan_rebalance(hosts).decisions == []


def random_fleet(seed: int):
    """A seeded fleet: 2-5 hosts (some dead, some unbounded), 0-6
    residents each and 1-8 pending tenants, with footprints,
    priorities, pins and traffic drawn (ties included on purpose)."""
    rng = np.random.default_rng(seed)
    hosts, pending, k = [], [], 0
    for h in range(int(rng.integers(2, 6))):
        tenants = []
        for _ in range(int(rng.integers(0, 7))):
            tenants.append(dict(
                key=f"t{k}", hbm=int(rng.choice([10, 20, 30, 40, 50])),
                prio=int(rng.integers(0, 3)), pinned=bool(rng.random()
                                                          < 0.2),
                traffic=float(rng.choice([0.0, 1.0, 5.0, 25.0]))))
            k += 1
        budget = (None if rng.random() < 0.15
                  else int(rng.choice([100, 150, 200, 300])))
        hosts.append(dict(mid=f"h{h}", budget=budget,
                          alive=bool(rng.random() > 0.2), tenants=tenants))
    for _ in range(int(rng.integers(1, 9))):
        pending.append(dict(key=f"p{k}", hbm=int(rng.choice(
            [10, 30, 60, 120, 400])), prio=int(rng.integers(0, 4)),
            pinned=False, traffic=float(rng.choice([0.0, 2.0]))))
        k += 1
    return hosts, pending


def build(P, fleet_spec):
    hosts_spec, pending_spec = fleet_spec

    def t(d):
        return tv(P, d["key"], d["hbm"], d["prio"], d["pinned"],
                  d["traffic"])
    hosts = [hv(P, h["mid"], h["budget"], [t(d) for d in h["tenants"]],
                h["alive"]) for h in hosts_spec]
    return hosts, [t(d) for d in pending_spec]


@pytest.mark.parametrize("seed", range(8))
def test_planners_decide_alike_on_seeded_fleets(seed):
    """`plan_placement` (with and without pre-emption), `plan_failover`
    of every dead host and `plan_rebalance` at two pressures give equal
    decision lists in both packages."""
    spec = random_fleet(seed)
    got = {}
    for name, P in PLANNERS.items():
        hosts, pending = build(P, spec)
        out = [P.plan_placement(hosts, pending).as_dict(),
               P.plan_placement(hosts, pending,
                                allow_preemption=False).as_dict()]
        for dead in hosts:
            if not dead.alive and dead.tenants:
                out.append(P.plan_failover(hosts, dead).as_dict())
        for ratio in (0.5, 0.9):
            out.append(P.plan_rebalance(hosts, pressure_ratio=ratio
                                        ).as_dict())
        got[name] = out
    assert got["torch"] == got["jax"]
    assert any(p["decisions"] for p in got["torch"])


# ---------------------------------------------------------------------------
# The fold-tick gate
# ---------------------------------------------------------------------------

def drain(gate, tenants, order):
    threads = []
    for name in tenants:
        def run(n=name):
            with gate.turn(n):
                order.append(n)
        t = threading.Thread(target=run)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if name in gate.stats()["waiting"] or not t.is_alive():
                break
            time.sleep(0.005)
    return threads


GATES = pytest.mark.parametrize(
    "mod", [JSched, TSched], ids=["jax", "torch"])


class TestFoldTickGate:
    def test_scripted_arrivals_are_granted_alike(self):
        """One scripted arrival order with set last grants: both gates
        grant in the same order (never granted first, then the oldest
        grant, then arrival)."""
        got = {}
        for name, mod in (("jax", JSched), ("torch", TSched)):
            gate = mod.FoldTickGate(registry=MetricsRegistry())
            order = []
            with gate.turn("holder"):
                gate._last_grant.update({"a": 100.0, "b": 50.0, "c": 75.0})
                threads = drain(gate, ["a", "new1", "b", "c", "new2"],
                                order)
            for t in threads:
                t.join(timeout=10)
            got[name] = order
        assert got["torch"] == got["jax"] == ["new1", "new2", "b", "c", "a"]

    @GATES
    def test_grants_go_to_stalest_tenant_first(self, mod):
        reg = MetricsRegistry()
        gate = mod.FoldTickGate(registry=reg)
        order = []
        with gate.turn("holder"):
            gate._last_grant.update({"a": 100.0, "b": 50.0})
            threads = drain(gate, ["a", "b"], order)
        for t in threads:
            t.join(timeout=10)
        assert order == ["b", "a"]
        if mod is TSched:
            out = reg.render()
            assert "pio_fold_tick_wait_seconds" in out
            assert 'tenant="b"' in out

    @GATES
    def test_never_granted_tenant_beats_recently_granted(self, mod):
        gate = mod.FoldTickGate(registry=MetricsRegistry())
        order = []
        with gate.turn("holder"):
            gate._last_grant["veteran"] = time.monotonic()
            threads = drain(gate, ["veteran", "newcomer"], order)
        for t in threads:
            t.join(timeout=10)
        assert order == ["newcomer", "veteran"]

    def test_contending_tenants_alternate(self):
        gate = TSched.FoldTickGate(registry=MetricsRegistry())
        order = []

        def run(name, n=6):
            for _ in range(n):
                with gate.turn(name):
                    order.append(name)
                    time.sleep(0.02)
        with gate.turn("holder"):
            ts = [threading.Thread(target=run, args=(n,))
                  for n in ("a", "b")]
            for t in ts:
                t.start()
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if set(gate.stats()["waiting"]) >= {"a", "b"}:
                    break
                time.sleep(0.005)
        for t in ts:
            t.join(timeout=30)
        runs = worst = 1
        for prev, cur in zip(order, order[1:]):
            runs = runs + 1 if prev == cur else 1
            worst = max(worst, runs)
        assert worst <= 2, order
        assert sorted(order) == ["a"] * 6 + ["b"] * 6


# ---------------------------------------------------------------------------
# The access-key gate
# ---------------------------------------------------------------------------

def seed_keys():
    from predictionio_tpu_torch.data.storage.base import AccessKey, App
    from predictionio_tpu_torch.data.storage.registry import Storage
    app_id = Storage.get_meta_data_apps().insert(App(0, "authapp"))
    keys = Storage.get_meta_data_access_keys()
    keys.insert(AccessKey("goodkey", app_id, ()))
    keys.insert(AccessKey("otherkey", app_id, ()))
    return app_id


class TestAccessKeyGate:
    def test_gate_armed_by_env_checks_dao(self, tmp_env, monkeypatch):
        seed_keys()
        monkeypatch.setenv("PIO_AUTH", "on")
        h = ServingHost(HostConfig(ip="127.0.0.1", port=0))
        try:
            h.admit_server(TenantSpec(key="a", engine_id="a"),
                           slot_server(h, "a"))
            h.start()
            port = h.config.port
            q = {"user": "u1", "num": 2}
            st, body = call(port, "/engines/a/queries.json", q)
            assert st == 401 and "access key required" in body["message"]
            st, body = call(port, "/engines/a/queries.json?accessKey=nope",
                            q)
            assert st == 401 and "invalid" in body["message"]
            st, out = call(port,
                           "/engines/a/queries.json?accessKey=goodkey", q)
            assert st == 200 and out["itemScores"]
            st, out = call(port, "/engines/a/queries.json", q,
                           headers={"X-PIO-Access-Key": "goodkey"})
            assert st == 200 and out["itemScores"]
        finally:
            h.stop()

    def test_tenant_scoped_key_must_match(self, tmp_env, monkeypatch):
        seed_keys()
        monkeypatch.setenv("PIO_AUTH", "on")
        h = ServingHost(HostConfig(ip="127.0.0.1", port=0))
        try:
            h.admit_server(TenantSpec(key="a", engine_id="a"),
                           slot_server(h, "a", accesskey="goodkey"))
            h.start()
            q = {"user": "u1", "num": 1}
            st, body = call(h.config.port,
                            "/engines/a/queries.json?accessKey=otherkey", q)
            assert st == 401
            assert "not authorized for this tenant" in body["message"]
            st, _ = call(h.config.port,
                         "/engines/a/queries.json?accessKey=goodkey", q)
            assert st == 200
        finally:
            h.stop()

    def test_auth_off_by_default(self, host):
        host.admit_server(TenantSpec(key="a", engine_id="a"),
                          slot_server(host, "a"))
        host.start()
        st, out = call(host.config.port, "/engines/a/queries.json",
                       {"user": "u1", "num": 1})
        assert st == 200 and out["itemScores"]

    def test_ttl_cache_bounds_dao_reads(self, monkeypatch):
        gate = AccessKeyGate(ttl_s=60.0)
        calls = []
        monkeypatch.setattr(gate, "_resolve", lambda key: calls.append(
            key) or (7 if key == "goodkey" else None))
        assert gate._lookup("badkey") is None
        assert gate._lookup("badkey") is None
        assert calls == ["badkey"]
        assert gate._lookup("goodkey") == gate._lookup("goodkey") == 7
        assert calls == ["badkey", "goodkey"]
        gate.invalidate("goodkey")
        assert gate._lookup("goodkey") == 7
        assert calls == ["badkey", "goodkey", "goodkey"]


# ---------------------------------------------------------------------------
# Fleet records, durable props, the generation fence
# ---------------------------------------------------------------------------

class TestFleetUrlAndRoster:
    def test_register_records_advertised_url(self, tmp_path):
        reg = fleet.FleetRegistry(fleet_dir=str(tmp_path / "fleet"))
        mid = reg.register("serving_host", port=8123)
        try:
            (m,) = [x for x in reg.members() if x["memberId"] == mid]
            assert m["url"] == "http://127.0.0.1:8123"
        finally:
            reg.deregister(mid)

    def test_member_url_prefers_record_over_derivation(self):
        assert fleet.member_url({"url": "http://10.0.0.9:77/", "host": "x",
                                 "port": 1}) == "http://10.0.0.9:77"
        assert fleet.member_url({"host": "10.0.0.9", "port": 77}) \
            == "http://10.0.0.9:77"
        assert fleet.member_url({"host": "10.0.0.9"}) is None

    def test_host_publishes_its_roster(self, host):
        host.admit_server(TenantSpec(key="a", engine_id="a", priority=2),
                          slot_server(host, "a"))
        host.start()
        (m,) = [x for x in fleet.get_fleet().members()
                if x["memberId"] == host.placement()["memberId"]]
        assert m["role"] == "serving_host"
        assert m["tenants"]["a"]["priority"] == 2
        assert m["tenants"]["a"]["generation"] == 0
        assert fleet.member_url(m) == f"http://127.0.0.1:{host.config.port}"


class TestDurableProps:
    def test_roundtrip_merge_and_index(self, tmp_env):
        assert tenant_props.load_props("a") is None
        rec = tenant_props.save_props("a", pinned=True)
        assert rec["pinned"] is True and "priority" not in rec
        tenant_props.save_props("a", priority=7)
        stored = tenant_props.load_props("a")
        assert stored["pinned"] is True and stored["priority"] == 7
        tenant_props.save_props("weird/key:x", pinned=True)
        idx = tenant_props.all_props()
        assert idx["a"]["priority"] == 7
        assert idx["weird/key:x"]["pinned"] is True

    def test_pin_survives_host_restart(self, tmp_env):
        h1 = ServingHost(HostConfig(ip="127.0.0.1", port=0))
        try:
            h1.admit_server(TenantSpec(key="a", engine_id="a"),
                            slot_server(h1, "a"))
            h1.start()
            st, body = call(h1.config.port, "/tenants/a/pin", {})
            assert st == 200 and body["pinned"] and body["persisted"]
        finally:
            h1.stop()
        assert tenant_props.load_props("a")["pinned"] is True
        h2 = ServingHost(HostConfig(ip="127.0.0.1", port=0))
        try:
            slot = h2.admit_server(TenantSpec(key="a", engine_id="a"),
                                   slot_server(h2, "a"))
            assert slot.spec.pinned is True
            assert h2.budget.snapshot()["tenants"]["a"]["pinned"]
        finally:
            h2.stop()


class TestGenerationFence:
    def test_stale_route_cannot_hit_evicted_tenant(self, host):
        host.admit_server(TenantSpec(key="a", engine_id="a"),
                          slot_server(host, "a"))
        host.start()
        port = host.config.port
        q = {"user": "u1", "num": 2}
        host._placement_gen["a"] = 5
        st, body = call(port, "/engines/a/queries.json", q,
                        headers={"X-PIO-Placement-Gen": "4"})
        assert st == 409 and body["message"] == "stale placement route"
        assert body["generation"] == 5
        st, out = call(port, "/engines/a/queries.json", q,
                       headers={"X-PIO-Placement-Gen": "5"})
        assert st == 200 and out["itemScores"]
        st, _ = call(port, "/engines/a/queries.json", q)
        assert st == 200
        st, body = call(port, "/tenants/a/remove", {"generation": 4})
        assert st == 409
        assert body["message"] == "stale placement generation"
        st, plc = call(port, "/placement.json")
        assert st == 200 and plc["tenants"]["a"]["generation"] == 5
        st, body = call(port, "/tenants/a/remove", {"generation": 6})
        assert st == 200 and body["removed"]
        st, _ = call(port, "/engines/a/queries.json", q,
                     headers={"X-PIO-Placement-Gen": "5"})
        assert st == 404

    def test_stale_admit_generation_409s(self, host):
        host.start()
        port = host.config.port
        host._placement_gen["a"] = 6
        st, body = call(port, "/tenants/a/admit", {"generation": 3})
        assert st == 409
        assert body["message"] == "stale placement generation"
        st, body = call(port, "/tenants/a/admit", {"generation": "wat"})
        assert st == 400


# ---------------------------------------------------------------------------
# The controller and the router
# ---------------------------------------------------------------------------

def fabricate(reg, member_id, port, tenants=None, pid=None):
    rec = {"memberId": member_id, "role": "serving_host",
           "pid": pid or os.getpid(), "host": "127.0.0.1", "port": port,
           "url": f"http://127.0.0.1:{port}", "node": os.uname().nodename,
           "startedAt": time.time() - 60, "heartbeatAt": time.time()}
    if tenants is not None:
        rec["tenants"] = tenants
    os.makedirs(reg.fleet_dir(), exist_ok=True)
    reg._write_record(rec)


class TestControllerAndRouter:
    def test_router_rides_generation_bump(self, host, monkeypatch,
                                          tmp_path):
        monkeypatch.setenv("PIO_FLEET_LIVENESS_S", "3600")
        host.admit_server(TenantSpec(key="a", engine_id="a"),
                          slot_server(host, "a", rec_model(const=1.0)))
        host.start()
        reg = fleet.FleetRegistry(fleet_dir=str(tmp_path / "ctlfleet"))
        fabricate(reg, "serving_host-one", host.config.port)
        ctl = PlacementController(registry=reg)
        hosts = ctl.observe()
        assert [h.member_id for h in hosts] == ["serving_host-one"]
        assert hosts[0].alive and "a" in hosts[0].tenants
        assert ctl.refresh_routes(hosts)["a"][1] == "serving_host-one"
        router = TenantRouter(ctl, policy=RetryPolicy(
            max_attempts=4, base_delay_s=0.01, max_delay_s=0.05,
            deadline_s=10.0))
        out = router.query("a", {"user": "u1", "num": 2})
        assert {s["score"] for s in out["itemScores"]} == {RANK * 1.0}
        host._placement_gen["a"] = 3
        assert router.query("a", {"user": "u1", "num": 2}) == out
        assert ctl.route_for("a")[2] == 3

    def test_step_handles_corpse_once_and_captures_incident(
            self, tmp_env, monkeypatch, tmp_path):
        monkeypatch.setenv("PIO_FLEET_LIVENESS_S", "3600")
        reg = fleet.FleetRegistry(fleet_dir=str(tmp_path / "ctlfleet"))
        fabricate(reg, "serving_host-dead", 1,
                  tenants={"a": {"engineId": "a", "engineVersion": "0",
                                 "generation": 2, "priority": 0}},
                  pid=999999)
        ctl = PlacementController(registry=reg)
        res = ctl.step()
        assert res["alive"] == 0
        assert [a["failover"] for a in res["actions"]] == [
            "serving_host-dead"]
        plan = res["actions"][0]["plan"]["decisions"]
        assert plan == [{"action": "refuse", "tenant": "a",
                         "reason": plan[0]["reason"]}]
        assert "no feasible host" in plan[0]["reason"]
        assert ctl.step()["actions"] == []
        from predictionio_tpu_torch.obs.incidents import get_incidents
        inc_dir = get_incidents().incidents_dir()
        bundles = []
        for name in os.listdir(inc_dir):
            p = os.path.join(inc_dir, name, "incident.json")
            if os.path.exists(p):
                with open(p) as f:
                    bundles.append(json.load(f))
        ours = [b for b in bundles if b["kind"] == "host_failover"]
        assert len(ours) == 1
        assert "serving_host-dead" in ours[0]["reason"]
        ctx = ours[0]["context"]
        assert ctx["deadMember"] == "serving_host-dead"
        assert ctx["failed"][0]["tenant"] == "a"
        st = ctl.status()
        assert st["hosts"][0]["alive"] is False
        assert st["slo"]["status"] in ("burning", "breached", "ok",
                                       "no_data")


def test_placement_cli_lines_match(tmp_env, monkeypatch, capsys):
    """`placement status` and `plan` print the same lines from both
    packages' CLIs over one fleet registry (a live port host with a
    tenant, and a corpse holding one); the bytes and the URL masked."""
    monkeypatch.setenv("PIO_FLEET_LIVENESS_S", "3600")
    h = ServingHost(HostConfig(ip="127.0.0.1", port=0,
                               budget_bytes=1 << 20))
    try:
        h.admit_server(TenantSpec(key="a", engine_id="a"),
                       slot_server(h, "a"))
        h.start()
        fabricate(fleet.get_fleet(), "serving_host-gone", 1,
                  tenants={"z": {"engineId": "z", "generation": 4,
                                 "priority": 1}}, pid=999999)
        got = {}
        for name, cli in (("jax", JCli), ("torch", TCli)):
            runs = []
            for argv in (["placement", "status"], ["placement", "plan"]):
                rc = cli.main(argv)
                out = re.sub(r"http://127\.0\.0\.1:\d+", "URL",
                             capsys.readouterr().out)
                runs.append((rc, re.sub(r"hbm=\s*\d+", "hbm=N", out)))
            got[name] = runs
        assert got["torch"] == got["jax"]
        (rc, status), (rc2, plan) = got["torch"]
        assert rc == 1 and "DEAD hosts still holding tenants" in status
        assert re.search(r"^    a\s+gen=0\s+prio=0", status, re.M)
        assert rc2 == 0 and plan.strip() == \
            "nothing to do: no live host is under budget pressure"
    finally:
        h.stop()
