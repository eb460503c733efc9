"""Port parity: the online plane (the store's entity-filtered read, the
scheduler, the quality gates, the registry, the server's hot swap and
`python -m predictionio_tpu_torch update`) vs the JAX reference.

Both packages read one SQLite/localfs store (the `tmp_env` variables).
Each trains its own instance of a variant; for the scheduler's parity the
port's server then serves the reference's trained tables (carried over by
`weights.py`), so both folds start from the same model and read the same
fresh events. Held exactly: rows of the entity-filtered read, touched
sets, read path and rows, counts, gate verdicts, served ids, report keys.
Held within tolerance: folded factors 1e-4 of the largest factor (lam =
0.1, as tests/test_torch_als.py), the fold's loss 1e-4 relative, and the
numbers of the gates' details 1e-3 relative (statistics of tables that
differ by that rounding, printed to four digits).
"""

import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.store import event_store as JES
from predictionio_tpu.guard import gates as JG
from predictionio_tpu.online import scheduler as JSched
from predictionio_tpu.serving import server as JServer
from predictionio_tpu.tools import cli as JCli
from predictionio_tpu.workflow import create_workflow as JW
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.store import event_store as TES
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.guard import gates as TG
from predictionio_tpu_torch.models import similarproduct as TS
from predictionio_tpu_torch.online import ModelVersionRegistry
from predictionio_tpu_torch.online import scheduler as TSched
from predictionio_tpu_torch.serving import server as TServer
from predictionio_tpu_torch.weights import (from_jax_model,
                                            from_jax_similarproduct_model)
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

FACTOR_TOL = 1e-4
LOSS_TOL = 1e-4
GATE_NUMBER_TOL = 1e-3
APP = "onlineapp"
N_USERS, N_ITEMS, N_RATE = 40, 30, 700
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STORAGE_ENV = {
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQLITE",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQLITE",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
    "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
}
ALGOS = {
    "recommendation": {"rank": 8, "num_iterations": 6, "lam": 0.1,
                       "seed": 1},
    "similarproduct": {"rank": 8, "num_iterations": 6, "lam": 0.1,
                       "alpha": 1.0, "seed": 1},
}
DATASOURCE = {"recommendation": {"app_name": APP, "read_items": True},
              "similarproduct": {"app_name": APP, "rate_as_view": True}}
# what the port's fold report adds to the reference's: the times of the
# reference's tracing spans, what the fold ran on its device and the
# process's device time by executable label
PORT_REPORT_KEYS = {"readS", "publishS", "reloadS", "tickS", "deviceTime"}
PORT_ALGO_KEYS = {"solverCalls", "launches"}


def storage_env(root) -> dict:
    return dict(STORAGE_ENV, PIO_FS_BASEDIR=str(root / "pio"),
                PIO_STORAGE_SOURCES_SQLITE_URL=str(root / "pio" / "pio.db"),
                PIO_STORAGE_SOURCES_LOCALFS_HOSTS=str(root / "pio" /
                                                      "models"))


def populate(seed: int = 0) -> int:
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    rng = np.random.default_rng(seed)
    u, i = rng.integers(0, N_USERS, N_RATE), rng.integers(0, N_ITEMS, N_RATE)
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        N_RATE, "rate", "user", [f"u{x}" for x in u], "item",
        [f"i{x}" for x in i],
        [{"rating": float(x)} for x in rng.integers(1, 6, N_RATE)],
        ["1970-01-01T00:00:%02d.%03dZ" % divmod(j, 1000)
         for j in range(N_RATE)]), app_id)
    cats = synthetic_item_categories(N_ITEMS, n_categories=4, seed=seed)
    ev.insert_columnar(ColumnarBatch(
        N_ITEMS, "$set", "item", [f"i{k}" for k in range(N_ITEMS)],
        properties=[{"categories": list(cats[k]),
                     "creationYear": 1990 + k % 11}
                    for k in range(N_ITEMS)],
        event_time="1970-01-01T01:00:00.000Z"), app_id)
    return app_id


def write_variant(path, template: str, port: bool) -> str:
    algo = dict(ALGOS[template], **({"device": "cpu"} if port else {}))
    path.write_text(json.dumps({
        "id": "default", "engineFactory": template,
        "datasource": {"params": DATASOURCE[template]},
        "algorithms": [{"name": "als", "params": algo}]}))
    return str(path)


def fresh_events(app_id: int, tag: str) -> int:
    """A tick's events, after every instance's start: 3 known users rate
    2 known items each, 2 new users rate 3 items, a new item gets a $set
    and 2 ratings, and an unseen item only a $set. Returns the count."""
    ev = TReg.Storage.get_events()
    users = ["u1", "u2", "u3"] * 2 + [f"{tag}nu0"] * 3 + [f"{tag}nu1"] * 3 \
        + ["u4", f"{tag}nu0"]
    items = ["i1", "i2", "i3", "i4", "i5", "i6", "i1", "i7", "i8", "i2",
             "i9", "i10", f"{tag}ni", f"{tag}ni"]
    # ratings seeded by the tag: two ticks' new entities never tie
    rng = np.random.default_rng(sum(map(ord, tag)))
    ev.insert_columnar(ColumnarBatch(
        len(users), "rate", "user", users, "item", items,
        [{"rating": float(r)} for r in rng.integers(1, 6, len(users))]),
        app_id)
    ev.insert_columnar(ColumnarBatch(
        2, "$set", "item", [f"{tag}ni", f"{tag}only"],
        properties=[{"categories": ["c1"], "creationYear": 2020},
                    {"categories": ["c2"]}]), app_id)
    return len(users) + 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One store; each template trained by both packages."""
    root = tmp_path_factory.mktemp("online")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in storage_env(root).items():
            mp.setenv(k, v)
        JReg.clear_cache()
        TReg.clear_cache()
        app_id = populate()
        paths = {}
        for template in ALGOS:
            pj = write_variant(root / f"{template}_jax.json", template, False)
            pt = write_variant(root / f"{template}_port.json", template, True)
            JW.create_workflow_main(JW.WorkflowConfig(engine_variant=pj))
            create_workflow_main(WorkflowConfig(engine_variant=pt))
            paths[template] = (pj, pt)
        yield dict(root=root, app_id=app_id, paths=paths, env=storage_env(
            root))
        JReg.clear_cache()
        TReg.clear_cache()


def carry(jax_model, template: str):
    """The reference's trained model as the port's, on the CPU."""
    if template == "recommendation":
        return from_jax_model(
            jax_model.als.user_factors, jax_model.als.item_factors,
            list(jax_model.user_ix._ids), list(jax_model.item_ix._ids),
            jax_model.als.rank, device="cpu",
            item_properties=jax_model.item_properties)
    items = {k: TS.Item(v.categories, v.properties)
             for k, v in jax_model.items.items()}
    return from_jax_similarproduct_model(
        jax_model.item_factors_normalized, list(jax_model.item_ix._ids),
        items, item_factors_raw=jax_model.item_factors_raw,
        user_factors=jax_model.user_factors,
        user_ids=list(jax_model.user_ix._ids), device="cpu")


def servers(world, template, **port_kw):
    """(the reference's server, the port's serving the same tables)."""
    pj, pt = world["paths"][template]
    js = JServer.EngineServer(JServer.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=pj, micro_batch=0)).load()
    ts = TServer.EngineServer(TServer.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=pt, **port_kw)).load()
    ts.models = [carry(js.models[0], template)]
    return js, ts


def post(url: str, body: bytes = b""):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def numbers(detail: str):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?",
                                         detail)]


def assert_gate_reports_agree(gj: dict, gt: dict):
    assert gj["passed"] == gt["passed"]
    assert [(g["gate"], g["verdict"]) for g in gj["gates"]] == \
        [(g["gate"], g["verdict"]) for g in gt["gates"]]
    for a, b in zip(gj["gates"], gt["gates"]):
        na, nb = numbers(a["detail"]), numbers(b["detail"])
        assert len(na) == len(nb), (a, b)
        for x, y in zip(na, nb):
            assert abs(x - y) <= GATE_NUMBER_TOL * max(abs(x), 1e-3), (a, b)


@pytest.mark.parametrize("case", ["entities", "targets", "both", "limit",
                                  "none"])
def test_find_columnar_by_entities_matches_reference(world, case):
    ids = {"entities": (["u1", "u7", "nobody"], None),
           "targets": (None, ["i3", "i9"]),
           "both": (["u1", "u2"], ["i1", "i2"]),
           "limit": (["u1", "u2"], ["i1", "i2"]),
           "none": ([], [])}[case]
    kw = dict(app_name=APP, entity_ids=ids[0], target_entity_ids=ids[1],
              property_field="rating", entity_type="user",
              target_entity_type="item", event_names=["rate"],
              limit=7 if case == "limit" else None)
    cj = JES.PEventStore.find_columnar_by_entities(**kw)
    ct = TES.PEventStore.find_columnar_by_entities(**kw)
    assert set(cj) == set(ct)
    for k in cj:
        assert np.array_equal(cj[k], ct[k], equal_nan=k == "prop"), k
    if case == "both":
        # a row matching both sides counts once
        pairs = list(zip(ct["entity_id"], ct["target_entity_id"], ct["t"]))
        assert len(pairs) == len(set(pairs)) or len(ct["t"]) == 0


def test_entity_read_equals_the_full_scan_filtered(world):
    """The port's pushdown returns the full scan's rows of the touched
    entities, in its order: equal event times (a batch written in one
    millisecond) in insertion order."""
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        6, "rate", "user", ["u5", "u6", "u5", "u6", "u7", "u5"], "item",
        ["i3", "i3", "i4", "i4", "i3", "i3"],
        [{"rating": float(r)} for r in (1, 2, 3, 4, 5, 2)],
        "2020-01-01T00:00:00.000Z"), world["app_id"])
    kw = dict(app_name=APP, property_field="rating", entity_type="user",
              target_entity_type="item", event_names=["rate"])
    full = TES.PEventStore.find_columnar(**kw)
    got = TES.PEventStore.find_columnar_by_entities(
        entity_ids=["u5", "u6"], target_entity_ids=["i3"], **kw)
    keep = (np.isin(full["entity_id"], ["u5", "u6"])
            | (full["target_entity_id"] == "i3"))
    for k in full:
        assert np.array_equal(full[k][keep], got[k], equal_nan=k == "prop")
    assert (got["t"] == 1_577_836_800_000).sum() == 6    # 2020-01-01


@pytest.mark.parametrize("template,max_entities", [
    ("recommendation", 1024), ("similarproduct", 1024),
    ("recommendation", 1)])     # past the cutover: the full scan
def test_scheduler_tick_matches_reference(world, template, max_entities):
    js, ts = servers(world, template)
    js.start()
    ts.start()
    try:
        cfg = dict(app_name=APP, filtered_read_max_entities=max_entities)
        sj = JSched.attach_scheduler(js, JSched.SchedulerConfig(**cfg))
        st = TSched.attach_scheduler(ts, TSched.SchedulerConfig(**cfg))
        n = fresh_events(world["app_id"], f"{template[:3]}{max_entities}")
        fj, ft = sj.poll_events(), st.poll_events()
        assert fj == ft >= n
        assert set(sj._user_deltas) == set(st._user_deltas)
        assert set(sj._item_deltas) == set(st._item_deltas)
        assert {k: d.count for k, d in sj._item_deltas.items()} == \
            {k: d.count for k, d in st._item_deltas.items()}
        rj, rt = sj.tick(force=True), st.tick(force=True)
        for k in ("foldIn", "touchedUsers", "touchedItems", "events",
                  "readPath", "readRows"):
            assert rj[k] == rt[k], k
        assert rt["readPath"] == ("entity_filtered" if max_entities > 1
                                  else "full_scan")
        (aj,), (at,) = rj["algorithms"], rt["algorithms"]
        for k in ("userRows", "itemRows", "newUsers", "newItems",
                  "residentHit", "sentinelRollback"):
            assert aj[k] == at[k], k
        assert abs(rj["loss"] - rt["loss"]) <= LOSS_TOL * rj["loss"]
        assert rt["anchorLoss"] == rt["loss"]
        assert_gate_reports_agree(rj["gateReport"], rt["gateReport"])
        assert rt["h2dBytes"] > 0 and at["solverCalls"] > 0
        # the folded tables, hot-swapped into both servers
        mj, mt = js.models[0], ts.models[0]
        if template == "recommendation":
            pairs = ((mj.als.user_factors, mt.als.user_factors),
                     (mj.als.item_factors, mt.als.item_factors))
            assert list(mt.item_ix.ids) == list(mj.item_ix._ids)
            assert mt.item_properties == mj.item_properties
        else:
            pairs = ((mj.user_factors, mt.user_factors),
                     (mj.item_factors_raw, mt.item_factors_raw))
            assert list(mt.item_ix.ids) == list(mj.item_ix._ids)
            assert mt.item_categories == mj.item_categories
        for a, b in pairs:
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= FACTOR_TOL * np.abs(a).max()
        stats = ts.stats()
        assert (stats["modelSwaps"], stats["foldIns"],
                stats["foldInEvents"]) == (1, 1, rt["events"])
        tag = f"{template[:3]}{max_entities}"
        queries = ([{"user": u, "num": 5} for u in
                    ("u1", "u4", f"{tag}nu0", f"{tag}nu1", "u30")]
                   + [{"user": "u2", "num": 5, "categories": ["c1"]}]
                   if template == "recommendation" else
                   [{"items": [i], "num": 5} for i in
                    ("i1", "i9", f"{tag}ni")]
                   + [{"items": ["i2"], "num": 5, "categories": ["c1"]}])
        for q in queries:
            body = json.dumps(q).encode()
            cj = post(f"http://127.0.0.1:{js.config.port}/queries.json",
                      body)
            ct = post(f"http://127.0.0.1:{ts.config.port}/queries.json",
                      body)
            assert cj[0] == ct[0] == 200
            assert [s["item"] for s in ct[1]["itemScores"]] == \
                [s["item"] for s in cj[1]["itemScores"]], q
            assert ct[1]["itemScores"], q     # new users and items answer
    finally:
        js.stop()
        ts.stop()


@pytest.mark.parametrize("failure", ["gate", "publish"])
def test_failed_tick_restores_the_deltas(world, failure):
    """A gate rejection or a failed publish restores the tick's deltas in
    both packages; the server keeps its models and says it is stale."""
    js, ts = servers(world, "recommendation", micro_batch=0)
    gate = {"gate_config": JG.GateConfig(max_norm_ratio=1e-9,
                                         norm_floor=0.0)}
    tgate = {"gate_config": TG.GateConfig(max_norm_ratio=1e-9,
                                          norm_floor=0.0)}

    class Broken:
        def publish(self, *a, **kw):
            raise OSError("registry down")
    fresh_events(world["app_id"], f"fail{failure}")
    out = {}
    for name, server, mod, extra in (("jax", js, JSched, gate),
                                     ("port", ts, TSched, tgate)):
        sched = mod.attach_scheduler(
            server, mod.SchedulerConfig(
                app_name=APP, **(extra if failure == "gate" else {})),
            registry=Broken() if failure == "publish" else None)
        before = server.models[0]
        pending = (sched.poll_events(), sched.pending_deltas())
        expect = JG.GateRejected if name == "jax" else TG.GateRejected
        with pytest.raises(expect if failure == "gate" else OSError):
            sched.fold_in()
        out[name] = (pending, sched.pending_deltas(),
                     sorted(sched._user_deltas), sorted(sched._item_deltas),
                     server.publish_degraded, server.models[0] is before,
                     sched.fold_in_count)
    assert out["jax"] == out["port"]
    (fresh, pending), restored, users, items, degraded, kept, folds = \
        out["port"]
    assert restored == pending == fresh > 0 and degraded and kept
    assert folds == 0 and users and items


@pytest.mark.parametrize("case", ["pass", "non_finite", "exploded",
                                  "negated", "same_object"])
def test_gates_match_reference_on_the_same_tables(world, case):
    """Both gatekeepers on the same live and candidate tables give the
    same report, word for word."""
    js, ts = servers(world, "recommendation", micro_batch=0)
    live_j, live_t = js.models[0], ts.models[0]
    U = live_j.als.user_factors.copy()
    V = live_j.als.item_factors.copy()
    if case == "non_finite":
        U[3, 1] = np.nan
    elif case == "exploded":
        V[2] *= 1e4
    elif case == "negated":    # same norms, scores flipped: score drift
        U = -U
    U[0] *= 1.01
    from predictionio_tpu.ops.als import ALSModel as JModel
    cand_j = type(live_j)(JModel(U, V, live_j.als.rank), live_j.user_ix,
                          live_j.item_ix, live_j.item_properties,
                          live_j.item_categories, live_j.item_years)
    cand_t = carry(cand_j, "recommendation")
    if case == "same_object":
        cand_j, cand_t = live_j, live_t
    rj = JG.QualityGatekeeper().evaluate([cand_j], [live_j], js.algorithms)
    rt = TG.QualityGatekeeper().evaluate([cand_t], [live_t], ts.algorithms)
    assert rj == rt
    assert rt["passed"] == (case in ("pass", "same_object"))
    if case == "non_finite":
        with pytest.raises(TG.GateRejected):
            TG.QualityGatekeeper().check_publishable([cand_t])


def test_registry_never_leaves_an_init_row(world):
    _, ts = servers(world, "recommendation", micro_batch=0)
    reg = ModelVersionRegistry()
    instances = TReg.Storage.get_meta_data_engine_instances()
    n0 = len(instances.get_all())
    with pytest.raises(Exception):
        reg.publish(ts.engine, ts.engine_params, ts.engine_instance,
                    [lambda: None])          # a model that cannot pickle
    rows = instances.get_all()
    assert len(rows) == n0 + 1
    assert [r.status for r in rows if r.status not in ("COMPLETED",)] == \
        ["ABORTED"]


def test_update_cli_publishes_and_reloads_like_pio_update(world, capsys):
    """`python -m predictionio_tpu_torch update` (a subprocess, one
    forced tick) against a deployed port server, and the reference's `pio
    update` against its own: the same report keys (the port's additions
    named in PORT_*_KEYS), a published online version that the deployed
    server serves after `/reload`, no INIT row."""
    pj, pt = world["paths"]["recommendation"]
    js = JServer.EngineServer(JServer.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=pj, micro_batch=0)).load()
    ts = TServer.EngineServer(TServer.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=pt)).load()
    js.start()
    ts.start()
    try:
        fresh_events(world["app_id"], "cli")
        assert JCli.main(["update", "--engine-json", pj, "--engine-port",
                          str(js.config.port)]) == 0
        rj = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        env = dict(os.environ, **world["env"])
        env.pop("PIO_SERVE_PACK", None)
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch", "update", "-v",
             pt, "--engine-port", str(ts.config.port)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        rt = json.loads(out.stdout.strip().splitlines()[-1])
        assert set(rt) == set(rj) | PORT_REPORT_KEYS
        assert set(rt["algorithms"][0]) == \
            set(rj["algorithms"][0]) | PORT_ALGO_KEYS
        assert rt["reloaded"] is True and rj["reloaded"] is True
        assert rt["readPath"] == rj["readPath"] == "entity_filtered"
        # 'auto' is LAPACK's Cholesky on the CPU: no kernel, no plain CG
        # (tests/test_torch_cuda.py holds the card's launches)
        assert rt["algorithms"][0]["launches"] == {}
        assert rt["algorithms"][0]["solverCalls"] > 0
        version = rt["publishedVersion"]
        assert ts.engine_instance.id == version
        assert ts.stats()["modelVersion"] == version
        assert ts.stats()["modelSwaps"] == 1
        online = ModelVersionRegistry().online_versions("default", "0", pt)
        assert [i.id for i in online] == [version]
        statuses = {i.status for i in TReg.Storage
                    .get_meta_data_engine_instances().get_all()}
        assert "INIT" not in statuses
        status, body = post(f"http://127.0.0.1:{ts.config.port}"
                            "/queries.json",
                            b'{"user": "clinu0", "num": 3}')
        assert status == 200 and len(body["itemScores"]) == 3
    finally:
        js.stop()
        ts.stop()


class _DownStore:
    def find(self, **kw):
        raise OSError("event store down")


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_tail_breaker_opens_after_failed_reads(pkg):
    """Three failed tail reads open the breaker; the next tick fails fast
    with CircuitOpenError, in both packages."""
    mod = JSched if pkg == "jax" else TSched
    sched = mod.DeltaTrainingScheduler(
        engine=None, engine_params=None, instance=None, algorithms=[],
        models=[], config=mod.SchedulerConfig(
            app_name=APP, event_names=["rate"], tail_breaker_failures=3),
        event_store=_DownStore())
    for _ in range(3):
        with pytest.raises(OSError) as e:
            sched.poll_events()
        assert type(e.value).__name__ != "CircuitOpenError"
    with pytest.raises(OSError) as e:
        sched.poll_events()
    assert type(e.value).__name__ == "CircuitOpenError"
    assert sched.stats()["tailBreaker"] == "open"
    assert sched.pending_deltas() == 0


def test_background_loop_folds_then_escalates(world, monkeypatch):
    """`start()`: the loop folds fresh events on its own; when every
    fold fails, it backs off and after `max_tick_failures` asks for a
    retrain (and keeps the deltas)."""
    _, ts = servers(world, "recommendation", micro_batch=0)
    sched = TSched.attach_scheduler(ts, TSched.SchedulerConfig(
        app_name=APP, max_deltas=1, poll_interval_s=0.05,
        max_tick_failures=2, failure_backoff_cap_s=0.2))
    fresh_events(world["app_id"], "loop")
    sched.start()
    try:
        deadline = time.time() + 60
        while sched.fold_in_count == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert sched.fold_in_count == 1 and ts.stats()["foldIns"] == 1

        def boom(*a, **kw):
            raise RuntimeError("fold failed")
        monkeypatch.setattr(ts.algorithms[0], "fold_in", boom)
        fresh_events(world["app_id"], "loop2")
        while not sched.retrain_requested and time.time() < deadline:
            time.sleep(0.05)
        stats = sched.stats()
        assert stats["retrainRequested"] and stats["consecutiveFailures"] >= 2
        assert "fold failed" in stats["lastError"]
        assert stats["pendingEvents"] > 0 and stats["foldIns"] == 1
    finally:
        sched.stop()
    assert sched._thread is None
