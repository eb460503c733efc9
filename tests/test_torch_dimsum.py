"""Port parity: the similar-product template's DIMSUM algorithm and
`ops/similarity.item_cosine_similarities` vs the JAX reference, on the
CPU.

- `item_cosine_similarities` on seeded (user, item) pairs with duplicate
  pairs, items nobody viewed, several chunk sizes and thresholds: the
  table within 1e-6 absolute of the reference's (float32 counts are
  exact, the normalization is the same float32 arithmetic), the diagonal
  0, and wherever the unthresholded similarity lies farther than 1e-6
  from the threshold, the two agree on whether the entry was zeroed.
- The template from one seeded store (items' `$set` categories, years
  and titles, `view` events, `rate` events under `rate_as_view`): the
  trained table as above, the id maps and metadata equal; the JAX model
  carried over (`weights.from_jax_dimsum_model`) answers every query
  (categories, white and black lists, `recommendFromYear`, unknown
  items, `return_properties`) with the JAX answer's ids and scores
  within 1e-5 relative.
- The manual persistence: the engine instance stores only a manifest,
  the model writes `similarities.npy` and `maps.pkl` under
  `<PIO_FS_BASEDIR>/dimsum/<instance_id>`, and a deploy restores the
  same table and answers; a directory the JAX package wrote is refused.
"""

import json
import os

import numpy as np
import pytest

from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import similarproduct as JS
from predictionio_tpu.ops.similarity import \
    item_cosine_similarities as j_cosine
from predictionio_tpu.workflow.core_workflow import run_train as j_run_train
from predictionio_tpu_torch.core import EngineParams
from predictionio_tpu_torch.core.persistence import PersistentModelManifest
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import similarproduct as TS
from predictionio_tpu_torch.ops.similarity import \
    item_cosine_similarities as t_cosine
from predictionio_tpu_torch.weights import from_jax_dimsum_model
from predictionio_tpu_torch.workflow.core_workflow import run_train

APP = "dimsumapp"
N_USERS, N_ITEMS = 40, 30
TABLE_ATOL = 1e-6
SCORE_RTOL = 1e-5


def time_str(ms: int) -> str:
    sec, ms = divmod(ms, 1000)
    return "1970-01-01T00:%02d:%02d.%03dZ" % (sec // 60, sec % 60, ms)


def assert_tables_agree(S_t, S_j, raw, threshold):
    """S within TABLE_ATOL; away from the threshold the zeroing agrees;
    `raw` is the unthresholded reference table."""
    assert S_t.dtype == np.float32 and S_t.shape == S_j.shape
    assert np.abs(S_t - S_j).max() <= TABLE_ATOL
    assert (np.diag(S_t) == 0).all()
    if threshold > 0:
        far = np.abs(raw - threshold) > TABLE_ATOL
        assert ((S_t == 0) == (S_j == 0))[far].all()
        assert (S_t[far & (raw < threshold)] == 0).all()


@pytest.mark.parametrize("chunk", [7, 16, 4096])
@pytest.mark.parametrize("threshold", [0.0, 0.25, 0.5])
def test_item_cosine_similarities_match_the_reference(chunk, threshold):
    rng = np.random.default_rng(chunk)
    n_users, n_items = 57, 23
    ui = rng.integers(0, n_users, 700)
    ii = rng.integers(0, n_items - 3, 700)   # three items nobody viewed
    ui = np.concatenate([ui, ui[:50]])       # duplicate pairs
    ii = np.concatenate([ii, ii[:50]])
    tel = {}
    S_t = t_cosine(ui, ii, n_users, n_items, threshold=threshold,
                   chunk_users=chunk, device="cpu", telemetry=tel)
    S_j = j_cosine(ui, ii, n_users, n_items, threshold=threshold,
                   chunk_users=chunk)
    raw = j_cosine(ui, ii, n_users, n_items, chunk_users=chunk)
    assert_tables_agree(S_t, S_j, raw, threshold)
    assert tel["chunks"] == -(-n_users // chunk)
    assert (S_t[-3:] == 0).all() and (S_t[:, -3:] == 0).all()


@pytest.fixture()
def store(tmp_env):
    TReg.clear_cache()
    JReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    ev = TReg.Storage.get_events()
    rng = np.random.default_rng(12)
    t = iter(range(10, 10 ** 6, 7))
    ev.insert_columnar(ColumnarBatch(
        N_ITEMS, "$set", "item", [f"i{k}" for k in range(N_ITEMS)],
        properties=[dict({"categories": [f"c{k % 3}", f"c{k % 4}"]}
                         if k % 7 else {}, year=1990 + k, title=f"T{k}")
                    for k in range(N_ITEMS)],
        event_time=time_str(next(t))), app_id)
    for name, n in (("view", 400), ("rate", 120)):
        # users prefer items of their own third of the catalog
        users = rng.integers(0, N_USERS, n)
        items = (users % 3) * 9 + rng.integers(0, 11, n)
        ev.insert_columnar(ColumnarBatch(
            n, name, "user", [f"u{u}" for u in users], "item",
            [f"i{k}" for k in items],
            [{"rating": 4.0}] * n if name == "rate" else None,
            [time_str(next(t)) for _ in range(n)]), app_id)
    yield app_id
    TReg.clear_cache()
    JReg.clear_cache()


def j_params(threshold=0.0):
    return JEngineParams(
        data_source_params=("", JS.DataSourceParams(app_name=APP,
                                                    rate_as_view=True)),
        preparator_params=("", None),
        algorithm_params_list=[("dimsum", JS.DIMSUMAlgorithmParams(
            threshold=threshold, return_properties=("title",)))],
        serving_params=("", None))


def t_params(threshold=0.0):
    return EngineParams(
        data_source_params=("", TS.DataSourceParams(app_name=APP,
                                                    rate_as_view=True)),
        preparator_params=("", None),
        algorithm_params_list=[("dimsum", TS.DIMSUMAlgorithmParams(
            threshold=threshold, return_properties=("title",),
            device="cpu"))],
        serving_params=("", None))


QUERIES = [
    dict(items=["i1"], num=5),
    dict(items=["i2", "i12"], num=8, categories=["c1"]),
    dict(items=["i3"], num=4, whiteList=["i4", "i5", "i20", "i3"]),
    dict(items=["i9", "i10"], num=6, blackList=["i11", "i13"]),
    dict(items=["i20"], num=30, recommendFromYear=2010),
    dict(items=["i0", "nope"], num=40),
    dict(items=["nope"], num=3),
]


def answer(res):
    return [(s.item, s.score, s.properties) for s in res.item_scores]


@pytest.mark.parametrize("threshold", [0.0, 0.3])
def test_the_template_matches_the_reference(store, threshold):
    jr = JS.SimilarProductEngineFactory.apply().train(j_params(threshold))
    tr = TS.SimilarProductEngineFactory.apply().train(t_params(threshold))
    jm, tm = jr.models[0], tr.models[0]
    assert list(tm.item_ix._ids) == list(jm.item_ix._ids)
    assert tm.item_categories == jm.item_categories
    np.testing.assert_array_equal(tm.item_years, jm.item_years)
    raw = JS.SimilarProductEngineFactory.apply().train(j_params()).models[
        0].similarities
    assert_tables_agree(tm.similarities, jm.similarities, raw, threshold)
    tel = tr.algorithms[0].last_train_telemetry
    assert tel["views"] == 520 and tel["items"] == N_ITEMS


def test_the_carried_model_answers_as_the_reference(store):
    jr = JS.SimilarProductEngineFactory.apply().train(j_params())
    ja, jm = jr.algorithms[0], jr.models[0]
    tm = from_jax_dimsum_model(
        jm.similarities, list(jm.item_ix._ids),
        {k: TS.Item(v.categories, v.properties)
         for k, v in jm.items.items()})
    ta = TS.DIMSUMAlgorithm(TS.DIMSUMAlgorithmParams(
        return_properties=("title",), device="cpu"))
    for q in QUERIES:
        got = answer(ta.predict(tm, TS.Query.from_dict(q)))
        want = answer(ja.predict(jm, JS.Query.from_dict(q)))
        assert [(g[0], g[2]) for g in got] == [(w[0], w[2]) for w in want]
        np.testing.assert_allclose([g[1] for g in got],
                                   [w[1] for w in want], rtol=SCORE_RTOL)
    assert answer(ta.predict(tm, TS.Query(("nope",), 3))) == []
    res = answer(ta.predict(tm, TS.Query(("i1",), 30)))
    assert res and all(s > 0 for _, s, _ in res)
    assert "i1" not in [r[0] for r in res]


def test_the_model_persists_itself(store):
    engine = TS.SimilarProductEngineFactory.apply()
    ep = t_params()
    iid = run_train(engine, ep, engine_id="dimsum-test")
    blob = TReg.Storage.get_model_data_models().get(iid).models
    (persisted,) = engine.deserialize_models(blob, iid)
    assert persisted == PersistentModelManifest(
        "predictionio_tpu_torch.models.similarproduct.DIMSUMModel")
    d = os.path.join(os.environ["PIO_FS_BASEDIR"], "dimsum", iid)
    assert sorted(os.listdir(d)) == ["maps.pkl", "similarities.npy"]
    restored = engine.prepare_deploy(ep, [persisted], iid)
    trained = engine.train(ep)
    np.testing.assert_array_equal(restored.models[0].similarities,
                                  trained.models[0].similarities)
    assert list(restored.models[0].item_ix._ids) == list(
        trained.models[0].item_ix._ids)
    for q in QUERIES:
        q = TS.Query.from_dict(q)
        assert answer(restored.algorithms[0].predict(
            restored.models[0], q)) == answer(
                trained.algorithms[0].predict(trained.models[0], q))


def test_a_directory_the_jax_package_wrote_is_refused(store):
    iid = j_run_train(JS.SimilarProductEngineFactory.apply(), j_params(),
                      engine_id="dimsum-jax")
    assert os.path.exists(os.path.join(os.environ["PIO_FS_BASEDIR"],
                                       "dimsum", iid, "maps.pkl"))
    with pytest.raises(ValueError, match="written by the JAX package"):
        TS.DIMSUMModel.load(iid, None)


def test_engine_json_trains_and_deploys(store, tmp_path):
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "similarproduct",
        "datasource": {"params": {"app_name": APP, "rate_as_view": True}},
        "algorithms": [{"name": "dimsum", "params": {
            "threshold": 0.0, "return_properties": ["year"],
            "device": "cpu"}}]}))
    iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)))
    server = EngineServer(ServerConfig(port=0, engine_variant=str(path)
                                       )).load()
    try:
        assert server.engine_instance.id == iid
        body, _ = server.queries(b'{"items": ["i1"], "num": 3}')
        got = json.loads(body)["itemScores"]
        assert len(got) == 3 and all(
            s["year"] == 1990 + int(s["item"][1:]) for s in got)
        body, _ = server.queries(b'{"items": ["nope"], "num": 3}')
        assert json.loads(body) == {"itemScores": []}
    finally:
        server.batcher.stop()


def test_no_view_events_is_refused(store):
    td = TS.TrainingData(users={}, items={"i0": TS.Item()},
                         view_events=TS.RatingsData([], [], []))
    with pytest.raises(ValueError, match="No view events"):
        TS.DIMSUMAlgorithm().train(TS.PreparedData(td))
