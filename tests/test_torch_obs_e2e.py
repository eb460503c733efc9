"""Port parity: the diagnostics plane end to end, both packages' servers
on the CPU.

Both packages' engine servers serve the same recommendation tables (the
port's carried by `weights.from_jax_model`, `device="cpu"`), micro-batched
with two windows in flight, and get the same queries, each carrying its
own `X-PIO-Trace-Id`:

- each inbound id is adopted: `/traces.json?trace_id=` returns the query
  trace under it and the `batch_predict` window it links, whose span
  trees (names, nesting) equal the reference's, and the window links the
  query back;
- with `PIO_SLOW_QUERY_MS=0`, `/slow.json` holds one waterfall a query
  with the reference's stage names (`device_sync` apart: it shows where
  the window's dispatch was a sampled one, which depends on each
  process's dispatch count);
- `/health.json` has the reference's keys and SLO names, and
  `/flight.json` holds the same record kinds with the same keys after the
  same hot swap;
- `/metrics?exemplars=1` carries `# {trace_id=...}` on a
  `pio_engine_query_seconds` bucket, and the id resolves in
  `/traces.json`.

Both packages' event servers (`--stats`) answer a single, a batch and a
columnar write; the 201 bodies carry a `traceId` that `/traces.json`
resolves to a trace with the reference's spans. With feedback on, each
engine server's `predict` events land under the trace they were answered
in: the event server's ingest trace ids (`/traces.json?event_ids=`) are
the query traces' ids unbatched, and the ids of the windows the query
traces link, batched. Then each package trains the
recommendation template on an app of its own in one store, loads it in
an in-process server, takes 12 rating events through its own event
server and folds them in one forced tick: the `fold_tick` trace links
every ingest trace and each ingest trace links the tick back, and the
tick's span tree equals the reference's.
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core import FirstServing as JFirstServing
from predictionio_tpu.data.api import event_server as JES
from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.online import scheduler as JSched
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu.workflow import create_workflow as JW
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.data.api import event_server as TES
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.online import scheduler as TSched
from predictionio_tpu_torch.serving import server as TSrv
from predictionio_tpu_torch.weights import from_jax_model
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

RANK, N_USERS, N_ITEMS = 8, 8, 30
TIMEOUT_S = 30
N_QUERIES = 12


def call(url, body=None, headers=None, method=None, raw=False):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method or ("POST" if data else
                                                   "GET"))
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            out = r.read()
            return r.status, (out.decode() if raw else json.loads(out))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def names(node):
    """A span tree's names and nesting."""
    kids = [names(c) for c in node.get("children", ())]
    return [node["name"], kids] if kids else [node["name"]]


def tid(k: int, salt: int = 0) -> str:
    return f"{0xe2e0000 + salt * 1000 + k:016x}"


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    ui = JMap.build([f"u{k}" for k in range(N_USERS)])
    ii = JMap.build([f"i{k}" for k in range(N_ITEMS)])
    props = [{"categories": [f"c{k % 3}"]} for k in range(N_ITEMS)]
    c, y = JR.RecommendationModel.derive_filters(props)
    mj = JR.RecommendationModel(JALS.ALSModel(U, V, RANK), ui, ii,
                                item_properties=props, item_categories=c,
                                item_years=y)
    mt = from_jax_model(U, V, list(ui._ids), list(ii._ids), RANK,
                        device="cpu", item_properties=props)
    return mj, mt


def engine_pair(models, **cfg):
    mj, mt = models
    inst = types.SimpleNamespace(id="inst-obs", batch="",
                                 engine_factory="recommendation")
    j = JSrv.EngineServer(JSrv.ServerConfig(ip="127.0.0.1", port=0, **cfg),
                          engine=JR.RecommendationEngineFactory.apply())
    j.algorithms = [JR.ALSAlgorithm(JR.ALSAlgorithmParams(rank=RANK))]
    j.models, j.serving, j.model_version = [mj], JFirstServing(), "v0"
    j.engine_instance = inst
    t = TSrv.EngineServer(
        TSrv.ServerConfig(ip="127.0.0.1", port=0, **cfg),
        TR.RecommendationEngineFactory.apply(),
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[mt], algorithms=[TR.ALSAlgorithm(
            TR.ALSAlgorithmParams(rank=RANK, device="cpu"))]))
    t.model_version = "v0"
    t.engine_instance = inst
    j.start(background=True)
    t.start()
    return {"jax": j, "port": t}


def burst(port: int, salt: int, n: int = N_QUERIES):
    """n concurrent queries, query k under trace id tid(k, salt)."""
    import threading
    out = [None] * n

    def one(k):
        q = {"user": f"u{k % N_USERS}", "num": 3 + k % 4}
        if k % 3 == 1:
            q["categories"] = [f"c{k % 3}"]
        out[k] = call(f"http://127.0.0.1:{port}/queries.json", q,
                      {"X-PIO-Trace-Id": tid(k, salt)})
    threads = [threading.Thread(target=one, args=(k,)) for k in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert all(o[0] == 200 for o in out), out
    return out


@pytest.fixture(scope="module")
def served(models):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PIO_SLOW_QUERY_MS", "0")
        mp.setenv("PIO_SERVE_CACHE", "off")
        servers = engine_pair(models)
        try:
            for salt, srv in enumerate(servers.values()):
                burst(srv.config.port, salt)
            yield servers
        finally:
            for s in servers.values():
                s.stop()


def base(srv):
    return f"http://127.0.0.1:{srv.config.port}"


def traces_of(srv, salt: int):
    """{kind: [span trees]} of every query's trace and its window."""
    out = {"query": [], "batch_predict": []}
    for k in range(N_QUERIES):
        _, body = call(f"{base(srv)}/traces.json?trace_id={tid(k, salt)}")
        by_kind = {}
        for t in body["traces"]:
            by_kind.setdefault(t["kind"], []).append(t)
        (q,) = by_kind["query"]
        assert q["traceId"] == tid(k, salt)     # the inbound id adopted
        (b,) = [w for w in by_kind["batch_predict"]
                if w["traceId"] in q["links"]]
        assert tid(k, salt) in b["links"]
        out["query"].append(names(q["root"]))
        out["batch_predict"].append(names(b["root"]))
    return out


def test_query_and_window_traces_match(served):
    got = {name: traces_of(srv, salt)
           for salt, (name, srv) in enumerate(served.items())}
    for kind in ("query", "batch_predict"):
        assert sorted(map(json.dumps, got["port"][kind])) == \
            sorted(map(json.dumps, got["jax"][kind])), kind
    assert got["port"]["query"][0] == ["query", [["batch_wait"]]]


def test_slow_json_stage_names_match(served):
    got = {}
    for name, srv in served.items():
        _, body = call(f"{base(srv)}/slow.json?n=100")
        assert body["thresholdMs"] == 0.0
        rows = [r for r in body["slow"] if r["traceId"].startswith("0000")]
        assert len(rows) >= N_QUERIES
        got[name] = sorted({tuple(s["stage"] for s in r["stages"]
                                  if s["stage"] != "device_sync")
                            for r in rows})
        for r in rows:
            assert r["batchTraceId"] and r["totalMs"] >= 0
    assert got["port"] == got["jax"]
    assert ("queue_wait", "batch_formation", "supplement", "dispatch",
            "completion_wait", "d2h_wait", "unpack", "post_process",
            "serialize") in got["port"]


def test_health_and_flight_match(served, models):
    got = {}
    for salt, (name, srv) in enumerate(served.items()):
        _, h1 = call(f"{base(srv)}/health.json")
        srv.swap_models([models[0] if name == "jax" else models[1]],
                        version="v1")
        burst(srv.config.port, 10 + salt, n=2)
        _, h2 = call(f"{base(srv)}/health.json")
        _, fl = call(f"{base(srv)}/flight.json?n=500")
        kinds = {}
        for r in fl["records"]:
            # a record's metrics block depends on when it landed
            kinds.setdefault(r["kind"], sorted(set(r) - {"metrics"}))
        got[name] = (sorted(h1), [s["name"] for s in h2["slo"]],
                     {k: kinds.get(k) for k in
                      ("hot_swap", "first_query_after_swap")},
                     sorted(fl))
    assert got["port"] == got["jax"]
    assert got["port"][2]["hot_swap"] is not None


def test_an_exemplar_names_a_trace_that_resolves(served):
    import re
    for name, srv in served.items():
        status, text = call(f"{base(srv)}/metrics?exemplars=1", raw=True)
        assert status == 200
        ids = re.findall(r'^pio_engine_query_seconds_bucket\{[^}]*\} \S+ '
                         r'# \{trace_id="([0-9a-f]+)"\}', text, re.M)
        assert ids, name
        _, body = call(f"{base(srv)}/traces.json?trace_id={ids[-1]}")
        assert any(t["traceId"] == ids[-1] for t in body["traces"]), name
        _, stats = call(f"{base(srv)}/stats.json")
        assert stats["queryLatency"]["exemplars"], name


@pytest.fixture()
def receivers(tmp_env):
    """Each package's event server (`--stats`) over one store, with an
    app and key each."""
    TReg.clear_cache()
    JReg.clear_cache()
    apps = TReg.Storage.get_meta_data_apps()
    out = {}
    for name, mod in (("jax", JES), ("port", TES)):
        app_id = apps.insert(App(0, f"obs-{name}"))
        TReg.Storage.get_meta_data_access_keys().insert(
            AccessKey(f"{name}-key", app_id, ()))
        es = mod.EventServer(mod.EventServerConfig(ip="127.0.0.1", port=0,
                                                   stats=True))
        es.start()
        out[name] = (es, app_id)
    try:
        yield out
    finally:
        for es, _ in out.values():
            es.stop()
        TReg.clear_cache()
        JReg.clear_cache()


EV = {"event": "rate", "entityType": "user", "entityId": "u1",
      "targetEntityType": "item", "targetEntityId": "i1",
      "properties": {"rating": 4.0}}


def test_event_bodies_carry_trace_ids_that_resolve(receivers):
    got = {}
    for name, (es, _) in receivers.items():
        url = f"http://127.0.0.1:{es.config.port}"
        key = f"?accessKey={name}-key"
        s1, single = call(f"{url}/events.json{key}", EV)
        s2, batch = call(f"{url}/batch/events.json{key}", [EV, EV])
        s3, col = call(f"{url}/events/columnar.json{key}", {
            "event": "rate", "entityType": "user",
            "entityId": ["u1", "u2"], "targetEntityType": "item",
            "targetEntityId": ["i1", "i2"],
            "properties": [{"rating": 1.0}, {"rating": 2.0}]})
        assert (s1, s2, s3) == (201, 200, 201)
        trees = []
        for body in (single, col):
            _, tr = call(f"{url}/traces.json?trace_id={body['traceId']}")
            (t,) = [t for t in tr["traces"]
                    if t["traceId"] == body["traceId"]]
            trees.append((t["kind"], names(t["root"])))
            assert t["root"]["attrs"]
        _, tb = call(f"{url}/traces.json?kind=event_batch&n=1")
        trees.append(names(tb["traces"][0]["root"]))
        got[name] = (trees, sorted(single), sorted(batch[0]), sorted(col))
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == ("event_ingest",
                                 ["event_ingest", [["storage_write"]]])


@pytest.mark.parametrize("micro_batch", [1, 16])
def test_feedback_lands_under_the_answering_trace(receivers, models,
                                                 micro_batch):
    """The feedback POST carries the trace context it was sent from: the
    query's trace unbatched, the window's (which links the query)
    batched, as the reference's does."""
    got = {}
    for salt, (name, (es, app_id)) in enumerate(receivers.items()):
        salt += 20 + 2 * micro_batch
        servers = engine_pair(models, feedback=True, accesskey=f"{name}-key",
                              event_server_ip="127.0.0.1",
                              event_server_port=es.config.port,
                              micro_batch=micro_batch)
        srv = servers[name]
        servers["port" if name == "jax" else "jax"].stop()
        try:
            out = burst(srv.config.port, salt, n=4)
            ev = TReg.Storage.get_events()
            deadline = time.time() + 20
            while True:
                landed = list(ev.find(app_id, event_names=["predict"]))
                if len(landed) >= 4 or time.time() > deadline:
                    break
                time.sleep(0.05)
            es_url = f"http://127.0.0.1:{es.config.port}"
            _, m = call(f"{es_url}/traces.json?event_ids="
                        + ",".join(e.event_id for e in landed))
            ingest = set(m["eventTraces"].values())
            answering = set()
            for k in range(4):
                _, tr = call(f"{base(srv)}/traces.json?trace_id="
                             f"{tid(k, salt)}")
                (q,) = [t for t in tr["traces"] if t["kind"] == "query"]
                answering |= ({q["traceId"]} if micro_batch == 1
                              else set(q["links"]))
            _, ing = call(f"{es_url}/traces.json?kind=event_ingest&n=50")
            kinds = sorted({t["root"]["attrs"]["event"]
                            for t in ing["traces"]
                            if t["traceId"] in ingest})
            got[name] = (len(landed), ingest == answering, kinds,
                         [o[0] for o in out])
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    assert got["port"][:3] == (4, True, ["predict"])


FOLD_APP = "obsfold"


@pytest.fixture(scope="module")
def fold_world(tmp_path_factory):
    """One store, an app for each package with the same ratings, each
    package's recommendation instance trained on its own app."""
    root = tmp_path_factory.mktemp("obsfold")
    env = {
        "PIO_FS_BASEDIR": str(root / "pio"),
        "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQLITE",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQLITE",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
        "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
        "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
        "PIO_STORAGE_SOURCES_SQLITE_URL": str(root / "pio" / "pio.db"),
        "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
        "PIO_STORAGE_SOURCES_LOCALFS_HOSTS": str(root / "pio" / "models")}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        JReg.clear_cache()
        TReg.clear_cache()
        rng = np.random.default_rng(0)
        u, i = rng.integers(0, 20, 300), rng.integers(0, 15, 300)
        r = rng.integers(1, 6, 300)
        out = {}
        for name in ("jax", "port"):
            app_id = TReg.Storage.get_meta_data_apps().insert(
                App(0, f"{FOLD_APP}{name}"))
            TReg.Storage.get_meta_data_access_keys().insert(
                AccessKey(f"fold-{name}", app_id, ()))
            TReg.Storage.get_events().insert_columnar(ColumnarBatch(
                300, "rate", "user", [f"u{x}" for x in u], "item",
                [f"i{x}" for x in i], [{"rating": float(x)} for x in r],
                "2000-01-01T00:00:00.000Z"), app_id)
            params = {"rank": 4, "num_iterations": 4, "lam": 0.1,
                      "seed": 1}
            if name == "port":
                params["device"] = "cpu"
            path = root / f"{name}.json"
            path.write_text(json.dumps({
                "id": "default", "engineFactory": "recommendation",
                "datasource": {"params": {"app_name":
                                          f"{FOLD_APP}{name}"}},
                "algorithms": [{"name": "als", "params": params}]}))
            if name == "jax":
                JW.create_workflow_main(JW.WorkflowConfig(
                    engine_variant=str(path)))
            else:
                create_workflow_main(WorkflowConfig(
                    engine_variant=str(path)))
            out[name] = (str(path), app_id)
        yield out
        JReg.clear_cache()
        TReg.clear_cache()


def test_a_fold_tick_links_the_ingest_traces_both_ways(fold_world):
    pkgs = {"jax": (JSrv, JES, JSched), "port": (TSrv, TES, TSched)}
    got = {}
    for name, (Srv, ES, Sched) in pkgs.items():
        path, _ = fold_world[name]
        srv = Srv.EngineServer(Srv.ServerConfig(
            ip="127.0.0.1", port=0, engine_variant=path)).load()
        es = ES.EventServer(ES.EventServerConfig(ip="127.0.0.1", port=0,
                                                 stats=True))
        es.start()
        try:
            sched = Sched.attach_scheduler(srv, Sched.SchedulerConfig(
                app_name=f"{FOLD_APP}{name}"))
            ingest = []
            for k in range(12):
                ev = dict(EV, entityId=f"u{k % 5}",
                          targetEntityId=f"i{k % 7}",
                          properties={"rating": float(1 + k % 5)})
                status, body = call(
                    f"http://127.0.0.1:{es.config.port}/events.json"
                    f"?accessKey=fold-{name}", ev)
                assert status == 201
                ingest.append(body["traceId"])
            report = sched.tick(force=True)
            assert report["events"] == 12
            tracer = (JSrv.TRACER if name == "jax" else TSrv.TRACER)
            (tick,) = [t for t in tracer.snapshot(limit=20,
                                                  kind="fold_tick")
                       if set(ingest) <= set(t["links"])]
            for t in ingest:
                _, body = call(f"http://127.0.0.1:{es.config.port}"
                               f"/traces.json?trace_id={t}")
                own = [x for x in body["traces"] if x["traceId"] == t]
                assert tick["traceId"] in own[0]["links"]
            got[name] = (names(tick["root"]), len(tick["links"]))
        finally:
            es.stop()
    assert got["port"] == got["jax"]
    assert got["port"][1] == 12
