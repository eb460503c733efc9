"""Port parity: the deployed serve plane (the micro-batched, pipelined,
packed-readback `EngineServer`) vs the JAX reference's server, on the
CPU.

Both servers run at their defaults (`micro_batch` 16, two windows in
flight, `PIO_SERVE_PACK` unset, so f16 scores) on the same f32 tables
(carried by `weights.from_jax_model`) and answer the same 24 concurrent
queries: ids equal, each score within f16 rounding of the float64 score
(2^-11 |s| plus the f32 dot bound), the two servers' scores at most one
f16 step apart (2^-10 |s|); the port's through HTTP, the reference's
through its micro-batcher (its listener's backlog of 5 resets some of 24
simultaneous connects). A deployed port server hot-swaps on
`/reload` with windows in flight and every answer equals one version's
answer (ids exactly, scores to one f16 step); its warm-up (the executable
registry's captures over the batch ladder, eager callables on the CPU)
is recorded in `/stats.json` `aotWarm` and `aot`, and a failed capture
fails `load()`.
`X-PIO-Deadline-Ms` sheds with 503 and `Retry-After`, and a malformed
value answers 400, in both servers; `micro_batch=1` answers through
`predict` on the request thread.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from predictionio_tpu.core import FirstServing as JFirstServing
from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.compile import aot
from predictionio_tpu_torch.compile.buckets import batch_ladder
from predictionio_tpu_torch.weights import from_jax_model
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

RANK, N_USERS, N_ITEMS = 8, 40, 60
APP = "planeapp"


def post(url: str, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode()
                                 if not isinstance(body, bytes) else body,
                                 method="POST", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def models():
    """Random f32 tables with item categories and years: the reference's
    model and the port's carrying the same tables."""
    rng = np.random.default_rng(7)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    cats = synthetic_item_categories(N_ITEMS, n_categories=4, seed=7)
    user_ix = JMap.build([f"u{k}" for k in range(N_USERS)])
    item_ix = JMap.build([f"i{k}" for k in range(N_ITEMS)])
    props = [{"categories": list(cats[int(item_ix.id_of(ix)[1:])]),
              "creationYear": 1990 + ix % 11} for ix in range(N_ITEMS)]
    c, y = JR.RecommendationModel.derive_filters(props)
    mj = JR.RecommendationModel(JALS.ALSModel(U, V, RANK), user_ix, item_ix,
                                item_properties=props, item_categories=c,
                                item_years=y)
    mt = from_jax_model(U, V, list(user_ix._ids), list(item_ix._ids), RANK,
                        device="cpu", item_properties=props)
    return mj, mt


def queries(n=24):
    out = []
    for k in range(n):
        q = {"user": f"u{(5 * k) % N_USERS}", "num": 3 + k % 9}
        if k % 4 == 1:
            q["categories"] = [f"c{k % 4}"]
        if k % 4 == 2:
            q["creationYear"] = 1993 + k % 5
        if k % 4 == 3:
            q.update(categories=["c0", "c2"], creationYear=1992)
        out.append(q)
    out[-1] = {"user": "nobody", "num": 4}
    return out


@pytest.fixture()
def both_servers(models, tmp_env, monkeypatch):
    monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    monkeypatch.delenv("PIO_SERVE_INFLIGHT", raising=False)
    mj, mt = models
    j = JSrv.EngineServer(JSrv.ServerConfig(ip="127.0.0.1", port=0),
                          engine=JR.RecommendationEngineFactory.apply())
    j.algorithms = [JR.ALSAlgorithm(JR.ALSAlgorithmParams(rank=RANK))]
    j.models = [mj]
    j.serving = JFirstServing()
    j.model_version = "v0"
    engine = TR.RecommendationEngineFactory.apply()
    t = EngineServer(ServerConfig(port=0), engine,
                     TR.RecommendationEngineFactory.engine_params(
                         TR.RatingsData([], [], [])),
                     TrainResult(models=[mt], algorithms=[TR.ALSAlgorithm(
                         TR.ALSAlgorithmParams(rank=RANK, device="cpu"))]))
    j.start(background=True)
    t.start()
    try:
        yield j, t
    finally:
        t.stop()
        j.stop()


def test_default_servers_answer_concurrent_queries_alike(both_servers,
                                                         models):
    j, t = both_servers
    mj, _ = models
    assert t.batcher is not None and t.batcher.pipelined
    assert j.batcher is not None and j.batcher.pipelined
    qs = queries()
    url = f"http://127.0.0.1:{t.config.port}/queries.json"
    with ThreadPoolExecutor(24) as ex:
        # the reference's listener keeps the standard library's backlog
        # of 5, which resets some of 24 simultaneous connects: its
        # queries enter at its micro-batcher, the HTTP handler's call
        answers_j = list(ex.map(j.batcher.submit, qs))
        answers_t = list(ex.map(lambda q: post(url, q), qs))
    U64 = mj.als.user_factors.astype(np.float64)
    V64 = mj.als.item_factors.astype(np.float64)
    for q, bj, (st, bt, _) in zip(qs, answers_j, answers_t):
        assert st == 200
        items = [s["item"] for s in bt["itemScores"]]
        assert items == [s["item"] for s in bj["itemScores"]]
        if q["user"] == "nobody":
            assert items == []
            continue
        assert len(items) == q["num"]
        ix = mj.item_ix.to_indices(items)
        uix = mj.user_ix[q["user"]]
        s64 = V64[ix] @ U64[uix]
        bound = RANK * 2.0 ** -24 * (np.abs(V64[ix]) @ np.abs(U64[uix]))
        got = np.array([s["score"] for s in bt["itemScores"]])
        ref = np.array([s["score"] for s in bj["itemScores"]])
        assert (np.abs(got - s64) <= 2.0 ** -11 * np.abs(s64) + bound).all()
        assert (np.abs(got - ref) <= 2.0 ** -10 * np.abs(s64)
                + 2 * bound).all()
        # the default readback is the f16 payload's
        np.testing.assert_array_equal(
            got.astype(np.float16).astype(np.float64), got)
    st = get(f"http://127.0.0.1:{t.config.port}/stats.json")
    assert st["batchedQueries"] == len(qs) and st["batches"] >= 1
    assert st["readback"]["windows"] > 0 and st["readback"]["bytes"] > 0


@pytest.mark.parametrize("which", ["jax", "port"])
def test_deadline_header_sheds_and_rejects_like_the_reference(
        both_servers, which, monkeypatch):
    j, t = both_servers
    srv = j if which == "jax" else t
    url = f"http://127.0.0.1:{srv.config.port}/queries.json"
    # a fresh query each time: the reference answers a repeated body from
    # its result cache before it reads the header
    q = iter({"user": f"u{k}", "num": 3} for k in range(10))
    assert post(url, next(q), {"X-PIO-Deadline-Ms": "5000"})[0] == 200
    for bad in ("soon", "-5", "0"):
        status, body, _ = post(url, next(q), {"X-PIO-Deadline-Ms": bad})
        assert status == 400 and "deadline" in body["message"]
    # a queue whose wait bound exceeds the deadline sheds at admission
    monkeypatch.setattr(srv.batcher, "queue_wait_bound_s", lambda: 2.4)
    status, body, headers = post(url, next(q), {"X-PIO-Deadline-Ms": "50"})
    assert status == 503 and "overloaded" in body["message"]
    assert headers["Retry-After"] == "2"
    assert post(url, next(q))[0] == 200      # no deadline, no shedding
    assert srv.batcher.n_shed == 1


def populate():
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    rng = np.random.default_rng(3)
    n = 700
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        n, "rate", "user", [f"u{x}" for x in rng.integers(0, 30, n)],
        "item", [f"i{x}" for x in rng.integers(0, 25, n)],
        [{"rating": float(x)} for x in rng.integers(1, 6, n)],
        ["1970-01-01T00:00:%02d.%03dZ" % divmod(k, 1000)
         for k in range(n)]), app_id)
    ev.insert_columnar(ColumnarBatch(
        25, "$set", "item", [f"i{k}" for k in range(25)],
        properties=[{"categories": [f"c{k % 3}"], "creationYear": 1990 + k}
                    for k in range(25)],
        event_time="1970-01-01T01:00:00.000Z"), app_id)


def write_variant(path, seed: int) -> str:
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": APP, "read_items": True}},
        "algorithms": [{"name": "als", "params": {
            "rank": 6, "num_iterations": 2, "lam": 0.1, "seed": seed,
            "device": "cpu"}}]}))
    return str(path)


@pytest.fixture()
def deployed(tmp_env, tmp_path, monkeypatch):
    """Two instances trained from one store; a server deployed on the
    first, pinned by id, warming its executables at every load as a
    deploy does (the suite turns the warm off by default)."""
    monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    monkeypatch.setenv("PIO_AOT_WARM", "on")
    TReg.clear_cache()
    populate()
    path = write_variant(tmp_path / "engine.json", 1)
    first = create_workflow_main(WorkflowConfig(engine_variant=path))
    write_variant(tmp_path / "engine.json", 2)
    second = create_workflow_main(WorkflowConfig(engine_variant=path))
    srv = EngineServer(ServerConfig(port=0, engine_variant=path,
                                    engine_instance_id=first,
                                    serve_inflight=2))
    srv.load().start()
    try:
        yield srv, first, second
    finally:
        srv.stop()
        TReg.clear_cache()
        JReg.clear_cache()


def test_stats_carry_the_batching_block_and_the_warm_up(deployed):
    srv, first, _ = deployed
    st = get(f"http://127.0.0.1:{srv.config.port}/stats.json")
    for key in ("batches", "batchedQueries", "avgBatchSize", "maxBatchSize",
                "immediateBatches", "exitFullBatch", "exitDrainGate",
                "exitWindow", "exitAdaptive", "shedQueries",
                "queueWaitBoundSec", "pipelined", "inflightWindows",
                "pipelineStalls", "stageSeconds", "readback"):
        assert key in st, key
    assert st["pipelined"] is True and st["inflightWindows"] == 2
    warm = st["aotWarm"]
    assert warm["version"] == first and warm["wallS"] > 0
    ladder = batch_ladder(16)
    assert ladder == [1, 2, 4, 8, 16]
    # the plain and the masked top-k, each over the ladder
    assert warm["specs"] == warm["compiled"] == 2 * len(ladder)
    captured = st["aot"]["versions"][first]
    assert sorted(captured) == ["batch_predict", "batch_predict_masked"]
    assert sorted(int(b.split("-")[0][1:])
                  for b in captured["batch_predict"]) == ladder
    assert st["aot"]["failedBuckets"] == 0
    assert st["microBatch"] == 16


def test_no_version_mixing_across_reload_with_windows_in_flight(deployed):
    srv, first, second = deployed
    users = [f"u{k}" for k in range(8)]
    qs = [{"user": u, "num": 5, **({"categories": ["c1"]} if k % 2 else {})}
          for k, u in enumerate(users)]
    expected = {}
    for iid in (second, first):     # ends loaded on the first again
        srv.config.engine_instance_id = iid
        srv.reload()
        ((algo, model),) = zip(srv.algorithms, srv.models)
        expected[iid] = [algo.batch_predict(
            model, [(0, TR.Query.from_dict(q))])[0][1].to_dict()
            for q in qs]
    assert expected[first] != expected[second]

    def matches(got, want):
        a, b = got["itemScores"], want["itemScores"]
        return [s["item"] for s in a] == [s["item"] for s in b] and all(
            abs(x["score"] - y["score"]) <= 2.0 ** -10 * abs(y["score"])
            for x, y in zip(a, b))

    stop, failures, seen = threading.Event(), [], set()

    def hammer(tid):
        n = 0
        while not stop.is_set() or n < 5:
            k = (tid + n) % len(qs)
            got = srv.answer(qs[k])
            hits = [iid for iid in expected if matches(got, expected[iid][k])]
            if len(hits) != 1:
                failures.append((qs[k], got))
            seen.update(hits)
            n += 1

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for r in range(6):
        srv.config.engine_instance_id = (second, first)[r % 2]
        srv.reload()
    stop.set()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not failures, failures[:3]
    assert seen == {first, second}
    assert srv.batcher._inflight == 0 and srv.batcher._inflight_batches == 0
    assert srv.batcher.stats()["avgBatchSize"] >= 1.0


def test_a_failed_warm_up_fails_load_and_keeps_the_old_models(
        deployed, monkeypatch):
    srv, first, second = deployed
    old = srv.models

    def broken(fn, example_args):
        raise RuntimeError("warm-up capture failed")

    monkeypatch.setattr(aot, "_make_executable", broken)
    srv.config.engine_instance_id = second
    with pytest.raises(RuntimeError, match="warm-up capture failed"):
        srv.reload()
    assert srv.models is old and srv.engine_instance.id == first


def test_micro_batch_one_answers_through_predict(models, monkeypatch):
    monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    _, mt = models
    algo = TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=RANK, device="cpu"))
    engine = TR.RecommendationEngineFactory.apply()
    srv = EngineServer(ServerConfig(port=0, micro_batch=1), engine,
                       TR.RecommendationEngineFactory.engine_params(
                           TR.RatingsData([], [], [])),
                       TrainResult(models=[mt], algorithms=[algo]))
    assert srv.batcher is None
    srv.start()
    try:
        url = f"http://127.0.0.1:{srv.config.port}"
        for q in queries(8):
            status, body, _ = post(url + "/queries.json", q)
            assert status == 200
            assert body == algo.predict(mt, TR.Query.from_dict(q)).to_dict()
        st = get(url + "/stats.json")
        assert "batches" not in st and st["requests"] == 8
        assert st["microBatch"] == 1
    finally:
        srv.stop()
