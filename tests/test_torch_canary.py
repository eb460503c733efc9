"""Port parity: guarded deploys (`guard/canary.py`, the server's canary,
the registry's last-good pin and rollback, the scheduler's canary hook
and `python -m predictionio_tpu_torch rollback`) vs the JAX reference, on
the CPU.

- `CanaryController`: with a fake clock and the same `stage`, `route`
  and `record` calls, both packages route the same turns and decide the
  same (promote; rollback on `nan_scores`, `error_rate`, `latency`; an
  idle candidate keeps the window open; a newer stage supersedes), with
  the same `stats()`; `count_nonfinite` counts alike.
- The server (each package's, on a model that is a number and scores it):
  a stage keeps the incumbent answering and tags the candidate's
  answers; a non-finite candidate rolls back and notifies; a clean one is
  promoted after its window; fraction 0 swaps at once; over HTTP the
  `X-PIO-Canary` answers number the candidate arm's requests, a
  micro-batch window never mixes the arms, the cache is bypassed while
  the canary runs, and a promote clears it.
- The registry on two copies of one store: `pin_last_good`,
  `rollback_to` (with a pin, without one, an unknown target, one
  version) and `demote_version` give the same demoted ids, statuses and
  pins; a pin either package writes the other reads. `load()` and
  `/reload` skip a demoted version in both servers.
- `rollback --engine-port 0` prints the reference's lines, and "nothing
  to roll back to" exits 1 in both.
- The port in process: a fold ticked by `attach_scheduler` with a
  registry is staged, promoted (the cache cleared, the version pinned),
  and a planted candidate (non-finite item properties past the gates)
  rolls back on `nan_scores`, is demoted and asks for a retrain; without
  a scheduler the server makes the verdict durable itself.
"""

import dataclasses
import datetime as dt
import json
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.guard import canary as JC
from predictionio_tpu.obs import MetricsRegistry
from predictionio_tpu.online import registry as JOR
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu.serving.plugins import EngineServerPluginContext
from predictionio_tpu.tools import cli as JCli
from predictionio_tpu.workflow import create_workflow as JW
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App, EngineInstance
from predictionio_tpu_torch.guard import canary as TC
from predictionio_tpu_torch.online import (ROLLEDBACK_STATUS,
                                           ModelVersionRegistry,
                                           SchedulerConfig, attach_scheduler)
from predictionio_tpu_torch.online import registry as TOR
from predictionio_tpu_torch.serving import server as TSrv
from predictionio_tpu_torch.tools import cli as TCli
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

PKGS = ("jax", "torch")
APP = "canaryapp"
N_USERS, N_ITEMS, N_RATE = 30, 20, 500
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


# ---------------------------------------------------------------------------
# CanaryController
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def controllers(**kw):
    """The reference's controller and the port's, each on its own fake
    clock, configured alike."""
    cfg = {"fraction": 0.25, "window_s": 10.0, "min_requests": 4,
           "nan_tolerance": 0, **kw}
    cj, ct = _Clock(), _Clock()
    return ((JC.CanaryController(JC.CanaryConfig(**cfg),
                                 registry=MetricsRegistry(), clock=cj), cj),
            (TC.CanaryController(TC.CanaryConfig(**cfg), clock=ct), ct))


def drive(c, clock, scenario: str) -> dict:
    """One scenario's calls; returns what the controller answered."""
    out = {"staged": c.stage(["cand"], "v2", fold_in_events=7)}
    if scenario == "routing":
        out["routes"] = [c.route() is not None for _ in range(100)]
    elif scenario == "nan":
        c.record("candidate", nonfinite=3, latency_s=0.01)
    elif scenario == "error_rate":
        for _ in range(20):
            c.record("incumbent", latency_s=0.01)
        for _ in range(4):
            c.record("candidate", error=True, latency_s=0.01)
    elif scenario in ("promote", "latency"):
        for _ in range(6):
            c.record("incumbent", latency_s=0.010)
            c.record("candidate", n=2, latency_s=0.010 if scenario ==
                     "promote" else 0.200)
        out["early"] = c.take_decision()
        clock.t += 11.0
    elif scenario == "idle":
        clock.t += 100.0
    elif scenario == "supersede":
        c.stage(["cand3"], "v3")
        out["routes"] = [c.route() for _ in range(8)]
    d = c.take_decision()
    out["decision"] = d
    out["stats"] = c.stats()
    out["active"] = c.active
    return out


@pytest.mark.parametrize("scenario,decision,reason", [
    ("routing", None, None), ("nan", "rollback", "nan_scores"),
    ("error_rate", "rollback", "error_rate"),
    ("promote", "promote", "window_clean"),
    ("latency", "rollback", "latency"), ("idle", None, None),
    ("supersede", None, None)])
def test_the_controller_routes_and_decides_as_the_reference(
        scenario, decision, reason):
    (cj, kj), (ct, kt) = controllers()
    j, t = drive(cj, kj, scenario), drive(ct, kt, scenario)
    assert t == j
    assert t["staged"] is True
    if decision is None:
        assert t["decision"] is None and t["active"]
    else:
        assert (t["decision"]["decision"], t["decision"]["reason"]) == \
            (decision, reason)
        assert t["decision"]["foldInEvents"] == 7
        assert not t["active"]
        assert t["stats"]["lastDecision"]["decision"] == decision
    if scenario == "routing":
        # exactly a quarter of the turns, never two in a row
        assert sum(t["routes"]) == 25
        assert not any(a and b for a, b in zip(t["routes"],
                                                t["routes"][1:]))
    if scenario == "supersede":
        assert t["stats"]["superseded"] == 1
        assert t["stats"]["candidateVersion"] == "v3"


def test_a_disabled_controller_stages_nothing():
    (cj, _), (ct, _) = controllers(fraction=0.0)
    for c in (cj, ct):
        assert c.stage(["m"], "v1") is False
        assert not c.active and c.route() is None
    assert ct.stats() == cj.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_nonfinite_counts_alike(seed):
    rng = np.random.default_rng(seed)
    pool = [1.0, float("nan"), float("inf"), -float("inf"), 2, "x", None]

    def build(depth):
        if depth > 7 or rng.random() < 0.3:
            return pool[rng.integers(len(pool))]
        if rng.random() < 0.5:
            return [build(depth + 1) for _ in range(rng.integers(0, 4))]
        return {f"k{i}": build(depth + 1) for i in range(rng.integers(4))}
    for _ in range(40):
        obj = build(0)
        assert TC.count_nonfinite(obj) == JC.count_nonfinite(obj)


# ---------------------------------------------------------------------------
# the server's canary: a model that is a number, scored as it is
# ---------------------------------------------------------------------------

class _FakeServing:
    def supplement(self, q):
        return q

    def serve(self, q, predictions):
        return predictions[0]


class _ScoreAlgo:
    """Scores every query with the model's value: a NaN model answers a
    NaN score, as poisoned factors would reach a response."""
    query_class = None

    def predict(self, model, q):
        return {"itemScores": [{"item": "i1", "score": float(model)}]}

    def batch_predict(self, model, indexed):
        return [(i, self.predict(model, q)) for i, q in indexed]


class _FakeInstance:
    id = "fake-instance"
    engine_factory = "fake"


def guarded(pkg, micro_batch=0, **kw):
    """A canary-enabled server on `_ScoreAlgo`. The latency breach is
    held by the controller's tests on a fake clock; here it is set out of
    reach, so a promote does not hang on a scheduler's hiccup in
    microsecond-long answers."""
    kw = {"canary_fraction": 0.5, "canary_window_s": 1.0,
          "canary_min_requests": 2, "canary_max_latency_ratio": 1e6,
          "micro_batch_wait_ms": 1.0, **kw}
    if pkg == "jax":
        s = JSrv.EngineServer(JSrv.ServerConfig(
            ip="127.0.0.1", port=0, micro_batch=micro_batch, **kw),
            plugin_context=EngineServerPluginContext())
    else:
        s = TSrv.EngineServer(TSrv.ServerConfig(
            ip="127.0.0.1", port=0, micro_batch=micro_batch, **kw))
    s.algorithms = [_ScoreAlgo()]
    s.models = [1.0]
    s.serving = _FakeServing()
    s.engine_instance = _FakeInstance()
    return s


@pytest.fixture()
def no_env(monkeypatch):
    for k in ("PIO_SERVE_CACHE", "PIO_SERVE_CACHE_STRICT"):
        monkeypatch.delenv(k, raising=False)


def test_a_stage_keeps_the_incumbent_and_tags_the_candidate(no_env):
    tags = {}
    for pkg in PKGS:
        s = guarded(pkg)
        s.swap_models([2.0], version="v2")
        assert s.models == [1.0] and s.canary.active
        outs = [s.handle_query({"q": 1}) for _ in range(8)]
        tags[pkg] = [o.get("_pioCanary") for o in outs]
        for o in outs:
            assert o["itemScores"][0]["score"] == (
                2.0 if "_pioCanary" in o else 1.0)
    assert tags["torch"] == tags["jax"]
    assert tags["torch"].count("v2") == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_a_nonfinite_candidate_rolls_back_and_notifies(pkg, no_env):
    s = guarded(pkg)
    decisions = []
    s.on_canary_decision = decisions.append
    s.swap_models([float("nan")], version="v-bad")
    served = [s.handle_query({"q": i}) for i in range(8)]
    assert not s.canary.active and s.models == [1.0]
    assert [(d["decision"], d["reason"]) for d in decisions] == \
        [("rollback", "nan_scores")]
    assert all("_pioCanary" not in s.handle_query({"q": 99})
               for _ in range(4))
    for d in served:
        if not np.isfinite(d["itemScores"][0]["score"]):
            assert "_pioCanary" in d


@pytest.mark.parametrize("pkg", PKGS)
def test_a_clean_candidate_is_promoted_after_its_window(pkg, no_env):
    s = guarded(pkg, canary_window_s=0.2)
    decisions = []
    s.on_canary_decision = decisions.append
    swaps = s.swap_count
    s.swap_models([2.0], version="v2", fold_in_events=5)
    for _ in range(8):
        s.handle_query({"q": 1})
    time.sleep(0.25)
    s.handle_query({"q": 1})       # the decision lands on the query path
    assert s.models == [2.0] and s.model_version == "v2"
    assert s.last_good_version == "v2"
    assert s.swap_count == swaps + 1 and s.fold_in_events == 5
    assert decisions[-1]["decision"] == "promote"
    assert "models" not in decisions[-1]


@pytest.mark.parametrize("pkg", PKGS)
def test_fraction_zero_swaps_at_once(pkg, no_env):
    s = guarded(pkg, canary_fraction=0.0)
    s.swap_models([3.0], version="v3")
    assert s.models == [3.0] and s.model_version == "v3"
    assert not s.canary.enabled


def http(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read()), r.headers.get("X-PIO-Canary")


@pytest.mark.parametrize("micro_batch", [0, 4])
@pytest.mark.parametrize("pkg", PKGS)
def test_over_http_the_header_counts_the_arm_and_the_cache_steps_aside(
        pkg, micro_batch, no_env):
    s = guarded(pkg, micro_batch=micro_batch, canary_window_s=1.0)
    s.start()
    try:
        port = s.config.port
        for _ in range(2):
            http(port, "/queries.json", {"q": 0})
        assert s.result_cache.stats()["entries"] == 1
        assert s.result_cache.hits == 1
        s.swap_models([2.0], version="v2")
        tagged = 0
        for k in range(8):
            body, tag = http(port, "/queries.json", {"q": k % 2})
            assert "_pioCanary" not in body
            assert body["itemScores"][0]["score"] == (2.0 if tag else 1.0)
            assert tag in (None, "v2")
            tagged += tag == "v2"
        stats, _ = http(port, "/stats.json")
        assert stats["canary"]["active"]
        assert stats["canary"]["arms"]["candidate"]["requests"] == tagged > 0
        # bypassed: no hit, no miss, no store while the canary runs
        assert stats["resultCache"]["entries"] == 1
        assert (stats["resultCache"]["hits"],
                stats["resultCache"]["misses"]) == (1, 1)
        time.sleep(1.05)
        stats, _ = http(port, "/stats.json")   # the poll lands the verdict
        assert stats["canary"]["lastDecision"]["decision"] == "promote"
        assert stats["lastGoodVersion"] == "v2"
        assert stats["resultCache"]["entries"] == 0
        assert stats["resultCache"]["invalidations"] == {"canary_promote": 1}
        body, tag = http(port, "/queries.json", {"q": 0})
        assert tag is None and body["itemScores"][0]["score"] == 2.0
    finally:
        s.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_a_window_answers_from_one_arm(pkg, no_env):
    """Four clients at once (under the reference listener's backlog of 5)
    through the micro-batcher (4 a window, 2 windows in flight): the arm
    is chosen once a window, so every answer of the candidate's model is
    tagged and no other; the tags number the candidate arm's requests."""
    s = guarded(pkg, micro_batch=4, canary_fraction=0.25,
                canary_window_s=60.0, canary_min_requests=10 ** 6)
    s.start()
    try:
        port = s.config.port
        s.swap_models([2.0], version="v2")
        results = []
        lock = threading.Lock()

        def client(c):
            for k in range(12):
                body, tag = http(port, "/queries.json", {"c": c, "k": k})
                with lock:
                    results.append((body["itemScores"][0]["score"], tag))
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 48
        assert all((score == 2.0) == (tag == "v2") for score, tag in results)
        arms = s.canary.stats()["arms"]
        tagged = sum(tag == "v2" for _, tag in results)
        assert arms["candidate"]["requests"] == tagged
        assert arms["incumbent"]["requests"] == 48 - tagged
    finally:
        s.stop()


# ---------------------------------------------------------------------------
# the registry, the CLI and the servers on a store
# ---------------------------------------------------------------------------

def storage_env(root) -> dict:
    return dict(STORAGE_ENV, PIO_FS_BASEDIR=str(root / "pio"),
                PIO_STORAGE_SOURCES_SQLITE_URL=str(root / "pio" / "pio.db"),
                PIO_STORAGE_SOURCES_LOCALFS_HOSTS=str(root / "pio" /
                                                      "models"))


def use(mp, root) -> None:
    for k, v in storage_env(root).items():
        mp.setenv(k, v)
    JReg.clear_cache()
    TReg.clear_cache()


def copy_store(src, dst):
    shutil.copytree(src / "pio", dst / "pio")
    return dst


def seed_versions(n, engine_id="guard", variant="v1"):
    instances = TReg.Storage.get_meta_data_engine_instances()
    t0 = dt.datetime.now(dt.timezone.utc)
    ids = []
    for k in range(n):
        iid = instances.insert(EngineInstance(
            id="", status="INIT", start_time=t0 + dt.timedelta(seconds=k),
            end_time=t0 + dt.timedelta(seconds=k), engine_id=engine_id,
            engine_version="1", engine_variant=variant,
            engine_factory="recommendation"))
        instances.update(instances.get(iid).with_(status="COMPLETED"))
        ids.append(iid)
    return ids


REGISTRIES = {"jax": JOR.ModelVersionRegistry, "torch": ModelVersionRegistry}


def registry_case(pkg, case, ids):
    """One case on the current store; (result or error, statuses, pin)."""
    reg = REGISTRIES[pkg]()
    out = None
    try:
        if case == "pin":
            reg.pin_last_good("guard", "1", "v1", ids[0])
            out = reg.rollback_to("guard", "1", "v1")
        elif case == "no_pin":
            out = reg.rollback_to("guard", "1", "v1")
        elif case == "explicit":
            out = reg.rollback_to("guard", "1", "v1", target_id=ids[1])
        elif case == "unknown":
            out = reg.rollback_to("guard", "1", "v1", target_id="nope")
        elif case == "one_version":
            out = reg.rollback_to("guard", "1", "v1")
        elif case == "demote":
            out = [reg.demote_version(ids[1]), reg.demote_version(ids[1]),
                   reg.demote_version("nope")]
    except ValueError as e:
        out = ("ValueError", str(e))
    instances = TReg.Storage.get_meta_data_engine_instances()
    statuses = [instances.get(i).status for i in ids]
    latest = instances.get_latest_completed("guard", "1", "v1")
    return out, statuses, latest.id if latest else None, reg.last_good(
        "guard", "1", "v1")


@pytest.mark.parametrize("case,n", [("pin", 3), ("no_pin", 3),
                                    ("explicit", 3), ("unknown", 2),
                                    ("one_version", 1), ("demote", 3)])
def test_the_registry_rolls_back_as_the_reference(case, n, tmp_path,
                                                  monkeypatch):
    seeded = tmp_path / "seeded"
    use(monkeypatch, seeded)
    ids = seed_versions(n)
    got = {}
    for pkg in PKGS:
        use(monkeypatch, copy_store(seeded, tmp_path / pkg))
        got[pkg] = registry_case(pkg, case, ids)
    assert got["torch"] == got["jax"]
    out, statuses, latest, pin = got["torch"]
    if case == "pin":
        assert out == {"target": ids[0], "demoted": [ids[2], ids[1]]}
        assert statuses == ["COMPLETED", ROLLEDBACK_STATUS,
                            ROLLEDBACK_STATUS] and latest == ids[0]
    elif case == "no_pin":
        assert out == {"target": ids[1], "demoted": [ids[2]]}
        assert pin == ids[1]
    elif case in ("unknown", "one_version"):
        assert out[0] == "ValueError" and pin is None
        assert set(statuses) == {"COMPLETED"}
    elif case == "demote":
        assert out == [True, False, False]
        assert statuses[1] == ROLLEDBACK_STATUS and latest == ids[2]


@pytest.mark.parametrize("writer", PKGS)
def test_a_pin_written_by_one_package_is_read_by_the_other(
        writer, tmp_env):
    variant = str(tmp_env / "some dir" / "engine.json")
    REGISTRIES[writer]().pin_last_good("default", "0", variant, "abc123")
    for pkg in PKGS:
        assert REGISTRIES[pkg]().last_good("default", "0", variant) == \
            "abc123"
    assert TOR.ModelVersionRegistry._pin_path("default", "0", variant) == \
        JOR.ModelVersionRegistry._pin_path("default", "0", variant)


CLI_MAIN = {"jax": JCli.main, "torch": TCli.main}


@pytest.mark.parametrize("args,n,rc", [
    ([], 2, 0), (["--to", "FIRST"], 3, 0), ([], 1, 1),
    (["--to", "nope"], 2, 1)])
def test_rollback_cli_says_what_the_reference_says(args, n, rc, tmp_path,
                                                   monkeypatch, capsys):
    seeded = tmp_path / "seeded"
    use(monkeypatch, seeded)
    ids = seed_versions(n, engine_id="cliguard", variant="engine.json")
    args = [ids[0] if a == "FIRST" else a for a in args]
    said = {}
    for pkg in PKGS:
        use(monkeypatch, copy_store(seeded, tmp_path / pkg))
        capsys.readouterr()
        assert CLI_MAIN[pkg](["rollback", "--engine-id", "cliguard",
                              "--engine-version", "1", "--engine-port",
                              "0", *args]) == rc
        said[pkg] = capsys.readouterr().out.splitlines()
        latest = TReg.Storage.get_meta_data_engine_instances(
            ).get_latest_completed("cliguard", "1", "engine.json")
        assert latest.id == (ids[-1] if rc else ids[0] if args else
                             ids[-2])
    assert said["torch"] == said["jax"]
    if rc:
        assert said["torch"][0].startswith("Rollback failed: ")
    else:
        target = ids[0] if args else ids[-2]
        assert said["torch"] == (
            [f"Rolled back to instance {target}."]
            + [f"  demoted {i} -> ROLLEDBACK"
               for i in reversed(ids[ids.index(target) + 1:])]
            + ["No engine server to reload (--engine-port 0)."])


def populate() -> None:
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    rng = np.random.default_rng(3)
    u, i = rng.integers(0, N_USERS, N_RATE), rng.integers(0, N_ITEMS, N_RATE)
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        N_RATE, "rate", "user", [f"u{x}" for x in u], "item",
        [f"i{x}" for x in i],
        [{"rating": float(x)} for x in rng.integers(1, 6, N_RATE)],
        ["1970-01-01T00:00:%02d.%03dZ" % divmod(j, 1000)
         for j in range(N_RATE)]), app_id)
    ev.insert_columnar(ColumnarBatch(
        N_ITEMS, "$set", "item", [f"i{k}" for k in range(N_ITEMS)],
        properties=[{"categories": [f"c{k % 3}"],
                     "creationYear": 1990 + k % 11}
                    for k in range(N_ITEMS)],
        event_time="1970-01-01T01:00:00.000Z"), app_id)


def write_variant(path, port: bool) -> str:
    algo = {"rank": 4, "num_iterations": 4, "lam": 0.1, "seed": 1,
            "return_properties": ["creationYear"]}
    if port:
        algo["device"] = "cpu"
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": APP, "read_items": True}},
        "algorithms": [{"name": "als", "params": algo}]}))
    return str(path)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """One store; the recommendation variant trained twice by each
    package (the second instance the latest)."""
    root = tmp_path_factory.mktemp("canary_store")
    with pytest.MonkeyPatch.context() as mp:
        use(mp, root)
        populate()
        paths, iids = {}, {}
        for pkg in PKGS:
            paths[pkg] = write_variant(root / f"{pkg}.json", pkg == "torch")
            iids[pkg] = []
            for _ in range(2):
                if pkg == "jax":
                    iids[pkg].append(JW.create_workflow_main(
                        JW.WorkflowConfig(engine_variant=paths[pkg])))
                else:
                    iids[pkg].append(create_workflow_main(
                        WorkflowConfig(engine_variant=paths[pkg])))
        JReg.clear_cache()
        TReg.clear_cache()
    yield dict(root=root, paths=paths, iids=iids)


def engine_server(pkg, path, **cfg):
    if pkg == "jax":
        return JSrv.EngineServer(JSrv.ServerConfig(
            ip="127.0.0.1", port=0, engine_variant=path, **cfg))
    return TSrv.EngineServer(TSrv.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=path, **cfg))


@pytest.mark.parametrize("pkg", PKGS)
def test_load_and_reload_skip_a_demoted_version(pkg, store, tmp_path,
                                                monkeypatch, no_env):
    root = copy_store(store["root"], tmp_path)
    use(monkeypatch, root)
    first, second = store["iids"][pkg]
    s = engine_server(pkg, store["paths"][pkg]).load()
    assert s.engine_instance.id == second
    assert s.last_good_version == second
    s.start()
    try:
        port = s.config.port
        for u in ("u1", "u2"):
            http(port, "/queries.json", {"user": u, "num": 3})
        assert s.result_cache.stats()["entries"] == 2
        assert REGISTRIES[pkg]().demote_version(second)
        http(port, "/reload", {})
        assert s.engine_instance.id == first == s.last_good_version
        stats, _ = http(port, "/stats.json")
        assert stats["resultCache"]["entries"] == 0
        assert stats["resultCache"]["invalidations"] == {"reload": 2}
    finally:
        s.stop()
    assert engine_server(pkg, store["paths"][pkg]).load(
        ).engine_instance.id == first


def fresh_rates(users, k: int = 3) -> None:
    app = TReg.Storage.get_meta_data_apps().get_by_name(APP)
    subj = [u for u in users for _ in range(k)]
    rng = np.random.default_rng(len(subj))
    TReg.Storage.get_events().insert_columnar(ColumnarBatch(
        len(subj), "rate", "user", subj, "item",
        [f"i{x}" for x in rng.integers(0, N_ITEMS, len(subj))],
        [{"rating": float(r)} for r in rng.integers(1, 6, len(subj))]),
        app.id)


def planted(model):
    """The served model with a non-finite creationYear on every item:
    its factor tables pass every gate, its answers carry NaN."""
    return dataclasses.replace(model, item_properties=[
        dict(p or {}, creationYear=float("nan"))
        for p in model.item_properties])


def ask_until(port, pred, tries=16):
    for k in range(tries):
        body, tag = http(port, "/queries.json", {"user": f"u{k % 5}",
                                                 "num": 3})
        if pred():
            return
    raise AssertionError("the watchdog did not decide")


@pytest.mark.parametrize("attached", [True, False])
def test_a_guarded_fold_is_promoted_then_a_planted_one_rolled_back(
        attached, store, tmp_path, monkeypatch, no_env):
    root = copy_store(store["root"], tmp_path)
    use(monkeypatch, root)
    path = store["paths"]["torch"]
    s = engine_server("torch", path, canary_fraction=0.5,
                      canary_window_s=0.3, canary_min_requests=2,
                      canary_max_latency_ratio=1e6).load()
    incumbent = s.engine_instance
    reg = ModelVersionRegistry()
    s.start()
    try:
        port = s.config.port
        for u in ("u1", "u2", "u3"):
            http(port, "/queries.json", {"user": u, "num": 3})
        if attached:
            sched = attach_scheduler(s, SchedulerConfig(app_name=APP),
                                     registry=reg)
            fresh_rates(["u1", "u7"])
            report = sched.tick(force=True)
            version = report["publishedVersion"]
        else:
            version = reg.publish(s.engine, s.engine_params, incumbent,
                                  s.models)
            s.swap_models(list(s.models), version=version)
        candidate = s.canary._candidate_models[0]
        assert s.canary.active and s.model_version == incumbent.id
        time.sleep(0.35)
        ask_until(port, lambda: not s.canary.active)
        assert s.models[0] is candidate and s.model_version == version
        assert s.result_cache.stats()["entries"] == 0
        assert s.result_cache.invalidations == {"canary_promote": 3}
        assert reg.last_good(incumbent.engine_id, incumbent.engine_version,
                             incumbent.engine_variant) == version
        bad = planted(s.models[0])
        bad_version = reg.publish(s.engine, s.engine_params, incumbent,
                                  [bad])
        s.swap_models([bad], version=bad_version)
        ask_until(port, lambda: not s.canary.active)
        last = s.canary.stats()["lastDecision"]
        assert (last["decision"], last["reason"]) == ("rollback",
                                                      "nan_scores")
        assert s.models[0] is candidate
        instances = TReg.Storage.get_meta_data_engine_instances()
        assert instances.get(bad_version).status == ROLLEDBACK_STATUS
        assert instances.get_latest_completed(
            incumbent.engine_id, incumbent.engine_version,
            incumbent.engine_variant).id == version
        if attached:
            assert sched.retrain_requested
            assert sched.stats()["retrainRequested"]
            assert [id(m) for m in sched.models] == [id(m) for m in s.models]
        body, tag = http(port, "/queries.json", {"user": "u1", "num": 3})
        assert tag is None and body["itemScores"]
        assert all(np.isfinite(x["creationYear"])
                   for x in body["itemScores"])
    finally:
        s.stop()


@pytest.mark.parametrize("argv", [
    ["rollback"],
    ["rollback", "-v", "e.json", "--engine-id", "x", "--engine-version",
     "3", "--to", "abc", "--engine-ip", "10.0.0.1", "--engine-port", "0"],
    ["deploy"], ["deploy", "--canary-fraction", "0.25",
                 "--canary-window", "5"]])
def test_the_parsers_take_the_reference_flags(argv):
    keys = {"rollback": ("engine_json", "engine_id", "engine_version", "to",
                         "engine_ip", "engine_port"),
            "deploy": ("canary_fraction", "canary_window")}[argv[0]]
    j = vars(JCli.build_parser().parse_args(argv))
    t = vars(TCli.build_parser().parse_args(argv))
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    assert t["func"] is {"rollback": TCli.cmd_rollback,
                         "deploy": TCli.cmd_deploy}[argv[0]]


def test_deploy_hands_the_canary_flags_to_the_server(monkeypatch):
    seen = {}

    class _Server:
        def __init__(self, config):
            seen["config"] = config

        def load(self):
            return self

        def bind(self):
            return self

    monkeypatch.setattr(TSrv, "EngineServer", _Server)
    monkeypatch.setattr(TCli, "_serve_foreground", lambda server, label: 0)
    assert TCli.main(["deploy", "--port", "0", "--canary-fraction", "0.25",
                      "--canary-window", "5"]) == 0
    cfg = seen["config"]
    assert (cfg.canary_fraction, cfg.canary_window_s) == (0.25, 5.0)
    assert cfg.result_cache is True


@pytest.mark.parametrize("pkg", PKGS)
def test_rollback_cli_reloads_the_deployed_server(pkg, store, tmp_path,
                                                  monkeypatch, capsys,
                                                  no_env):
    root = copy_store(store["root"], tmp_path)
    use(monkeypatch, root)
    first, second = store["iids"][pkg]
    path = store["paths"][pkg]
    s = engine_server(pkg, path).load()
    s.start()
    try:
        port = s.config.port
        http(port, "/queries.json", {"user": "u1", "num": 3})
        capsys.readouterr()
        assert CLI_MAIN[pkg](["rollback", "-v", path, "--engine-port",
                              str(port)]) == 0
        said = capsys.readouterr().out.splitlines()
        assert said == [f"Rolled back to instance {first}.",
                        f"  demoted {second} -> ROLLEDBACK",
                        f"Reloaded engine server at http://127.0.0.1:"
                        f"{port}/reload."]
        assert s.engine_instance.id == first
        assert s.result_cache.stats()["entries"] == 0
    finally:
        s.stop()
    # the server is gone: the registry changes, the reload fails loudly
    assert CLI_MAIN[pkg](["rollback", "-v", path, "--to", second,
                          "--engine-port", str(port)]) == 1
    said = capsys.readouterr().out.splitlines()
    assert said[0] == f"Rollback failed: rollback target {second} is not " \
        f"a COMPLETED version of engine default 0 {path}"
    assert CLI_MAIN[pkg](["rollback", "-v", path, "--to", first,
                          "--engine-port", str(port)]) == 1
    said = capsys.readouterr().out.splitlines()
    assert said[0] == f"Rolled back to instance {first}."
    assert said[-1].startswith("Reload failed (")
    assert said[-1].endswith("the server keeps its current model until "
                             "it restarts or /reload succeeds.")
