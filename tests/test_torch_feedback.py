"""Port parity: deploy's feedback loop and output plugins vs the JAX
reference's engine server, on the CPU.

Both packages' engine servers serve the same recommendation tables (the
port's carried by `weights.from_jax_model`), with `feedback` on and one
receiver: the port's event server over a temporary store, where each
server posts under its own access key into its own app. The tables are
exact in f32 and f16 (user k is (k + 1) e0, item i has (i + 1) / 8 in its
first coordinate), so every score, and with it every answer and every
event, must be equal, exactly, with no tolerance: the `predict` events'
entity type, entity id (the prId: the query's, else the engine instance
id) and properties (the query as sent, and the prediction with its prId
before the output blocker ran), and the responses (after it). Both
query paths are held: the micro-batched window (`micro_batch` 16) and
`micro_batch=1`. Each server has an output blocker (adds a field) and a
sniffer (counts); both servers' `/plugins.json` are equal. Under the
feedback loop, and under a plugin without it, neither server's result
cache takes an entry or a hit, while without either it does. Both
servers' HTTP layers answer an unknown path, a wrong method and a
malformed body alike. Every HTTP call carries a timeout and every server
binds port 0.
"""

import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.core import FirstServing as JFirstServing
from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.serving import plugins as JP
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.data.api.event_server import (EventServer,
                                                          EventServerConfig)
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import AccessKey, App
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.serving import plugins as TP
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.weights import from_jax_model

RANK, N_USERS, N_ITEMS = 8, 8, 30
INSTANCE = "inst-feedback"
TIMEOUT_S = 10


def post(url: str, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url: str):
    with urllib.request.urlopen(url, timeout=TIMEOUT_S) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def models():
    """Tables whose scores (k + 1)(i + 1) / 8 are exact in f16: the
    reference's model and the port's carrying the same tables."""
    U = np.zeros((N_USERS, RANK), np.float32)
    U[:, 0] = np.arange(1, N_USERS + 1)
    V = np.zeros((N_ITEMS, RANK), np.float32)
    V[:, 0] = np.arange(1, N_ITEMS + 1) / 8.0
    cats = synthetic_item_categories(N_ITEMS, n_categories=3, seed=3)
    user_ix = JMap.build([f"u{k}" for k in range(N_USERS)])
    item_ix = JMap.build([f"i{k}" for k in range(N_ITEMS)])
    props = [{"categories": list(cats[int(item_ix.id_of(ix)[1:])])}
             for ix in range(N_ITEMS)]
    c, y = JR.RecommendationModel.derive_filters(props)
    mj = JR.RecommendationModel(JALS.ALSModel(U, V, RANK), user_ix, item_ix,
                                item_properties=props, item_categories=c,
                                item_years=y)
    mt = from_jax_model(U, V, list(user_ix._ids), list(item_ix._ids), RANK,
                        device="cpu", item_properties=props)
    return mj, mt


def queries():
    out = []
    for k in range(12):
        q = {"user": f"u{k % N_USERS}", "num": 2 + k % 5}
        if k % 3 == 1:
            q["categories"] = [f"c{k % 3}"]
        if k % 2:
            q["prId"] = f"pr-{k}"
        out.append(q)
    out.append({"user": "nobody", "num": 3})
    return out


def plugin_pair(pkg):
    """An output blocker that adds a field and a sniffer that counts."""
    class Tagger(pkg.EngineServerPlugin):
        plugin_name = "tagger"
        plugin_description = "adds servedBy"
        output_type = pkg.OUTPUT_BLOCKER

        def process(self, engine_instance, query, prediction, context):
            return dict(prediction, servedBy=engine_instance.id)

    class Counter(pkg.EngineServerPlugin):
        plugin_name = "counter"
        plugin_description = "counts answers"
        output_type = pkg.OUTPUT_SNIFFER
        seen = 0

        def process(self, engine_instance, query, prediction, context):
            type(self).seen += 1

    ctx = pkg.EngineServerPluginContext()
    ctx.register(Tagger())
    ctx.register(Counter())
    return ctx, Counter


@pytest.fixture()
def receiver(tmp_env):
    """The port's event server over the test's store, with one app and
    key for each package's engine server."""
    TReg.clear_cache()
    apps = TReg.Storage.get_meta_data_apps()
    ids = {}
    for name in ("jax", "port"):
        ids[name] = apps.insert(App(0, f"fb-{name}"))
        TReg.Storage.get_meta_data_access_keys().insert(
            AccessKey(f"{name}-key", ids[name], ()))
    es = EventServer(EventServerConfig(ip="127.0.0.1", port=0))
    es.start()
    try:
        yield es, ids
    finally:
        es.stop()
        TReg.clear_cache()


def engine_servers(models, port: int, micro_batch: int, feedback: bool,
                   plugins: bool):
    """(JAX server, its sniffer class, port server, its sniffer class),
    started, serving the same tables."""
    mj, mt = models
    inst = types.SimpleNamespace(id=INSTANCE,
                                 engine_factory="recommendation")
    jctx, jcount = (plugin_pair(JP) if plugins
                    else (JP.EngineServerPluginContext(), None))
    tctx, tcount = (plugin_pair(TP) if plugins
                    else (TP.EngineServerPluginContext(), None))
    fb = dict(feedback=feedback, event_server_ip="127.0.0.1",
              event_server_port=port)
    j = JSrv.EngineServer(JSrv.ServerConfig(
        ip="127.0.0.1", port=0, micro_batch=micro_batch,
        accesskey="jax-key", **fb),
        engine=JR.RecommendationEngineFactory.apply(), plugin_context=jctx)
    j.algorithms = [JR.ALSAlgorithm(JR.ALSAlgorithmParams(rank=RANK))]
    j.models = [mj]
    j.serving = JFirstServing()
    j.engine_instance = inst
    engine = TR.RecommendationEngineFactory.apply()
    t = EngineServer(
        ServerConfig(ip="127.0.0.1", port=0, micro_batch=micro_batch,
                     accesskey="port-key", **fb), engine,
        TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData([], [], [])),
        TrainResult(models=[mt], algorithms=[TR.ALSAlgorithm(
            TR.ALSAlgorithmParams(rank=RANK, device="cpu"))]),
        plugin_context=tctx)
    t.engine_instance = inst
    j.start(background=True)
    t.start()
    return j, jcount, t, tcount


def stop(*servers):
    for s in servers:
        s.stop()


def landed(app_id: int, n: int) -> list:
    """The app's `predict` events once `n` have landed (10 s at most)."""
    ev = TReg.Storage.get_events()
    deadline = time.time() + 10
    while True:
        got = list(ev.find(app_id, event_names=["predict"]))
        if len(got) >= n or time.time() > deadline:
            return got
        time.sleep(0.05)


@pytest.mark.parametrize("micro_batch", [16, 1])
def test_both_servers_post_the_same_predict_events(models, receiver,
                                                   micro_batch, monkeypatch):
    monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    es, ids = receiver
    j, jcount, t, tcount = engine_servers(models, es.config.port,
                                          micro_batch, feedback=True,
                                          plugins=True)
    qs = queries()
    try:
        answers = {}
        for name, srv in (("jax", j), ("port", t)):
            url = f"http://127.0.0.1:{srv.config.port}/queries.json"
            answers[name] = [post(url, q) for q in qs]
        assert answers["port"] == answers["jax"]
        assert all(code == 200 and body["servedBy"] == INSTANCE
                   for code, body in answers["port"])
        assert t.stats()["resultCache"]["entries"] == 0
        assert jcount.seen == tcount.seen == len(qs)
        plugins = [get(f"http://127.0.0.1:{s.config.port}/plugins.json")
                   for s in (j, t)]
        assert plugins[0] == plugins[1]
        assert set(plugins[1]["plugins"]["outputblocker"]) == {"tagger"}
        assert set(plugins[1]["plugins"]["outputsniffer"]) == {"counter"}
    finally:
        stop(j, t)
    events = {name: landed(ids[name], len(qs)) for name in ("jax", "port")}

    def by_query(evs):
        return sorted((json.dumps(e.properties.fields, sort_keys=True),
                       e.entity_type, e.entity_id, e.target_entity_type)
                      for e in evs)

    assert len(events["port"]) == len(qs)
    assert by_query(events["port"]) == by_query(events["jax"])
    for q, (_, body) in zip(qs, answers["port"]):
        want = {k: v for k, v in body.items() if k != "servedBy"}
        assert want["prId"] == q.get("prId", INSTANCE)
        match = [e for e in events["port"]
                 if e.properties.fields["query"] == q]
        assert len(match) == 1 and match[0].entity_id == want["prId"]
        assert match[0].properties.fields["prediction"] == want


@pytest.mark.parametrize("feedback,plugins,cached", [
    (True, False, False), (False, True, False), (False, False, True)])
def test_the_cache_stores_nothing_under_feedback_or_a_plugin(
        models, receiver, feedback, plugins, cached):
    """Each query twice: with feedback or a plugin no entry is stored and
    no answer comes from the cache, in both servers (and every query
    posts its event); with neither, the second asking hits."""
    es, ids = receiver
    j, _, t, _ = engine_servers(models, es.config.port, 16,
                                feedback=feedback, plugins=plugins)
    qs = queries()[:6]
    try:
        for srv in (j, t):
            url = f"http://127.0.0.1:{srv.config.port}/queries.json"
            for q in qs + qs:
                assert post(url, q)[0] == 200
        stats = {"jax": j.result_cache.stats(),
                 "port": t.stats()["resultCache"]}
    finally:
        stop(j, t)
    for name, st in stats.items():
        assert (st["entries"] > 0) == cached, (name, st)
        assert (st["hits"] > 0) == cached, (name, st)
    if feedback:
        for name in ("jax", "port"):
            assert len(landed(ids[name], 2 * len(qs))) == 2 * len(qs)


def send(url: str, method: str, data: bytes = None):
    """(status, JSON body) of one request, an error status included."""
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("method,path,data", [
    ("GET", "/nope.json", None),
    ("GET", "/queries.json", None),
    ("DELETE", "/stats.json", None),
    ("POST", "/queries.json", b"{"),
    ("POST", "/queries.json", b"[1]"),
    ("POST", "/queries.json", b'{"user": "u1", "num": 2}'),
], ids=["unknown", "get-queries", "delete-stats", "bad-json", "not-object",
        "answered"])
def test_the_http_layer_answers_as_the_jax_engine_server(
        models, receiver, method, path, data):
    """Both engine servers serve through their package's `utils/http`
    router: an unknown path, a known path asked with another method and a
    malformed body answer the same status and body in both."""
    es, _ = receiver
    j, _, t, _ = engine_servers(models, es.config.port, 16,
                                feedback=False, plugins=False)
    try:
        got = [send(f"http://127.0.0.1:{s.config.port}{path}", method, data)
               for s in (j, t)]
    finally:
        stop(j, t)
    assert got[1] == got[0]
