"""Port parity: the recommended-user template vs the JAX reference, on
the CPU.

Both packages read one seeded SQLite store: users' `$set`s and `follow`
events in two communities (even users follow even users, odd follow
odd), some pairs followed more than once, and `follow` events between
items (wrong target type) that both data sources skip.

- The training data is held array for array.
- Train (rank 4, 10 iterations, the solver at 'auto', Cholesky on the
  CPU in both packages): the followed users' normalized table within
  1e-4 of its largest entry at lam 0.1 and 4e-4 at lam 0.01 (the bounds
  of tests/test_torch_als.py), the id maps equal.
- Served answers: the JAX model carried over (`weights.
  from_jax_recommendeduser_model`) answers with the JAX answer's ids,
  scores within 1e-5 relative; the port's `batch_predict` equals its own
  `predict` (exact readback: ids and scores 1e-5 relative; f16: ids and
  scores within f16 rounding); query users are excluded, white and black
  lists apply, an unknown user gets an empty answer, `to_dict` gives
  `similarUserScores`; the serialization round trip; the engine through
  `create_workflow_main` and a loaded server.
"""

import dataclasses
import json

import numpy as np
import pytest

from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import recommendeduser as JU
from predictionio_tpu_torch.core import EngineParams
from predictionio_tpu_torch.core.params import params_from_dict
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import recommendeduser as TU
from predictionio_tpu_torch.weights import from_jax_recommendeduser_model

APP = "followapp"
RANK = 4
N_USERS = 16
FACTOR_TOL = {0.1: 1e-4, 0.01: 4e-4}
SCORE_RTOL = 1e-5
F16_REL = 2.0 ** -11


def time_str(ms: int) -> str:
    sec, ms = divmod(ms, 1000)
    return "1970-01-01T00:%02d:%02d.%03dZ" % (sec // 60, sec % 60, ms)


@pytest.fixture()
def store(tmp_env):
    TReg.clear_cache()
    JReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    ev = TReg.Storage.get_events()
    rng = np.random.default_rng(4)
    t = iter(range(10, 10 ** 6, 7))
    ev.insert_columnar(ColumnarBatch(
        N_USERS, "$set", "user", [f"u{u}" for u in range(N_USERS)],
        properties=[{"name": f"n{u}"} for u in range(N_USERS)],
        event_time=time_str(next(t))), app_id)
    rows = [(f"u{u}", f"u{v}") for u in range(N_USERS)
            for v in range(N_USERS)
            if u != v and u % 2 == v % 2 and rng.random() < 0.7]
    rows += rows[:5]                           # followed twice
    ev.insert_columnar(ColumnarBatch(
        len(rows), "follow", "user", [r[0] for r in rows], "user",
        [r[1] for r in rows], None, [time_str(next(t)) for _ in rows]),
        app_id)
    ev.insert_columnar(ColumnarBatch(
        2, "follow", "user", ["u0", "u1"], "item", ["i0", "i1"], None,
        time_str(next(t))), app_id)
    yield app_id
    TReg.clear_cache()
    JReg.clear_cache()


def algo_kw(**kw):
    return dict(dict(rank=RANK, num_iterations=10, lam=0.01, seed=1), **kw)


def j_params(**kw):
    return JEngineParams(
        data_source_params=("", JU.DataSourceParams(app_name=APP)),
        preparator_params=("", None),
        algorithm_params_list=[("als", JU.ALSAlgorithmParams(
            **algo_kw(**kw)))],
        serving_params=("", None))


def t_params(**kw):
    return EngineParams(
        data_source_params=("", TU.DataSourceParams(app_name=APP)),
        preparator_params=("", None),
        algorithm_params_list=[("als", TU.ALSAlgorithmParams(
            **algo_kw(device="cpu", **kw)))],
        serving_params=("", None))


QUERIES = [
    dict(users=["u0"], num=3),
    dict(users=["u0", "u2"], num=5),
    dict(users=["u1"], num=8, whiteList=["u3", "u5", "u0"]),
    dict(users=["u2"], num=6, blackList=["u4", "u6"]),
    dict(users=["u3", "nobody"], num=20),
    dict(users=["nobody"], num=3),
]


def pairs(res):
    return [(s.user, s.score) for s in res.similar_user_scores]


def test_read_training_matches_the_reference(store):
    td_j = JU.RecommendedUserDataSource(
        JU.DataSourceParams(app_name=APP)).read_training()
    td_t = TU.RecommendedUserDataSource(
        TU.DataSourceParams(app_name=APP)).read_training()
    assert td_t.users == td_j.users and len(td_t.users) == N_USERS
    for name in ("users", "items", "vals", "ts"):
        a = getattr(td_t.follow_events, name)
        b = getattr(td_j.follow_events, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert not any(str(x).startswith("i") for x in td_t.follow_events.items)


@pytest.mark.parametrize("lam", [0.1, 0.01])
def test_train_matches_the_reference(store, lam):
    jr = JU.RecommendedUserEngineFactory.apply().train(j_params(lam=lam))
    tr = TU.RecommendedUserEngineFactory.apply().train(t_params(lam=lam))
    jm, tm = jr.models[0], tr.models[0]
    assert list(tm.followed_ix._ids) == list(jm.followed_ix._ids)
    a, b = jm.followed_factors_normalized, tm.followed_factors_normalized
    assert a.shape == b.shape and b.dtype == np.float32
    assert np.abs(a - b).max() <= FACTOR_TOL[lam] * np.abs(a).max()
    tel = tr.algorithms[0].last_train_telemetry
    fe = TU.RecommendedUserDataSource(TU.DataSourceParams(
        app_name=APP)).read_training().follow_events
    # a pair followed twice is one entry (summed)
    assert tel["solver_calls"] > 0
    assert tel["ratings"] == len(set(zip(fe.users, fe.items))) < len(fe)


def test_the_carried_model_answers_as_the_reference(store):
    jr = JU.RecommendedUserEngineFactory.apply().train(j_params())
    ja, jm = jr.algorithms[0], jr.models[0]
    tm = from_jax_recommendeduser_model(
        jm.followed_factors_normalized, list(jm.followed_ix._ids),
        device="cpu")
    ta = TU.RecommendedUserALSAlgorithm(TU.ALSAlgorithmParams(
        **algo_kw(device="cpu")))
    for q in QUERIES:
        got = pairs(ta.predict(tm, TU.Query.from_dict(q)))
        want = pairs(ja.predict(jm, JU.Query.from_dict(q)))
        assert [x[0] for x in got] == [x[0] for x in want], q
        np.testing.assert_allclose([x[1] for x in got],
                                   [x[1] for x in want], rtol=SCORE_RTOL)


@pytest.mark.parametrize("pack", ["exact", "f16"])
def test_batch_predict_matches_predict(store, pack, monkeypatch):
    if pack == "exact":
        monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    else:
        monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    tr = TU.RecommendedUserEngineFactory.apply().train(t_params())
    algo, model = tr.algorithms[0], tr.models[0]
    queries = [TU.Query.from_dict(q) for q in QUERIES]
    batched = dict(algo.batch_predict(model, list(enumerate(queries))))
    for ix, q in enumerate(queries):
        b, s = pairs(batched[ix]), pairs(algo.predict(model, q))
        assert [x[0] for x in b] == [x[0] for x in s], q
        sb, ss = np.array([x[1] for x in b]), np.array([x[1] for x in s])
        tol = (SCORE_RTOL if pack == "exact" else F16_REL) * np.abs(ss)
        assert (np.abs(sb - ss) <= tol).all(), q


def test_the_query_filters(store):
    tr = TU.RecommendedUserEngineFactory.apply().train(t_params())
    algo, model = tr.algorithms[0], tr.models[0]

    def users(**q):
        return [u for u, _ in pairs(algo.predict(
            model, TU.Query.from_dict(dict(num=20, **q))))]
    got = users(users=["u0", "u2"])
    assert got and not {"u0", "u2"} & set(got)
    # the community dominates the ranking
    assert sum(int(u[1:]) % 2 == 0 for u in got[:3]) >= 2
    assert "u4" not in users(users=["u0"], blackList=["u4"])
    assert set(users(users=["u1"], whiteList=["u3", "u5", "u1"])) <= {
        "u3", "u5"}
    assert users(users=["nobody"]) == []
    assert all(s > 0 for _, s in pairs(algo.predict(
        model, TU.Query(("u0",), 20))))


def test_the_model_survives_serialization(store):
    engine = TU.RecommendedUserEngineFactory.apply()
    ep = t_params()
    tr = engine.train(ep)
    blob = engine.serialize_models(
        engine.make_serializable_models(tr, "inst", ep))
    (host,) = engine.deserialize_models(blob, "inst")
    assert host.device is None and host._table is None
    deployed = engine.prepare_deploy(ep, [host], "inst")
    for q in QUERIES:
        q = TU.Query.from_dict(q)
        assert pairs(deployed.algorithms[0].predict(
            deployed.models[0], q)) == pairs(
                tr.algorithms[0].predict(tr.models[0], q))


def test_engine_json_trains_and_deploys(store, tmp_path):
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "recommendeduser",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "als", "params": algo_kw(
            device="cpu")}]}))
    iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)))
    server = EngineServer(ServerConfig(port=0, engine_variant=str(path)
                                       )).load()
    try:
        assert server.engine_instance.id == iid
        body, _ = server.queries(b'{"users": ["u0"], "num": 3}')
        got = json.loads(body)["similarUserScores"]
        assert len(got) == 3 and "u0" not in {s["user"] for s in got}
        body, _ = server.queries(b'{"users": ["nobody"], "num": 3}')
        assert json.loads(body) == {"similarUserScores": []}
        with pytest.raises((KeyError, ValueError)):
            server.queries(b'{"num": 3}')
    finally:
        server.batcher.stop()


def test_wire_format_and_params_match():
    d = {"users": ["u1", "u2"], "num": 3, "blackList": ["u9"],
         "whiteList": ["u3"]}
    assert dataclasses.astuple(TU.Query.from_dict(d)) == \
        dataclasses.astuple(JU.Query.from_dict(d))
    r = TU.UserScoreResult((TU.UserScore("u3", 0.5),))
    assert r.to_dict() == JU.UserScoreResult(
        (JU.UserScore("u3", 0.5),)).to_dict() == {
        "similarUserScores": [{"user": "u3", "score": 0.5}]}
    # fuse_iteration, once refused, is a field as in the reference's
    assert params_from_dict(TU.ALSAlgorithmParams,
                            {"fuse_iteration": True}).fuse_iteration
    names = {f.name for f in dataclasses.fields(JU.ALSAlgorithmParams)}
    port = {f.name for f in dataclasses.fields(TU.ALSAlgorithmParams)}
    assert port == names | {"device"}
