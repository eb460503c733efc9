"""Port parity: the recommendation template (preparator, ALSAlgorithm
train/predict/batch_predict, `from_jax_model`, the engine server) vs the
JAX reference on the same `RatingsData`.

Ranked ids must match exactly and scores within 1e-5. Scores of two
independently trained models are compared to 1e-5 relative (SCORE_RTOL):
they inherit the factor tables' f32 difference (sums in another order
over three iterations), which is ~2e-6 relative at scores of ~5; a model
carried across by `from_jax_model` has the reference's exact tables and
is held to 1e-5 absolute. The reference's
batched serve path is held in exact mode (`PIO_SERVE_PACK=exact`), so its
f16 score packing does not enter the comparison.

The query wire format (`Query.from_dict` with and without `categories`
and `creationYear`, nulls, malformed fields) and the engine.json params'
JSON round trip are held exactly.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.models import common as JC
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu_torch.models import common as TC
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.weights import from_jax_model

SCORE_TOL = 1e-5
SCORE_RTOL = 1e-5
FACTOR_TOL = 1e-4


def ratings_arrays(seed=11, n_u=70, n_i=45, nnz=1500):
    rng = np.random.default_rng(seed)
    users = np.char.add("u", rng.integers(0, n_u, nnz).astype(str))
    items = np.char.add("i", rng.integers(0, n_i, nnz).astype(str))
    vals = rng.integers(1, 6, nnz).astype(np.float32)
    ts = rng.integers(0, 1000, nnz).astype(np.int64)
    return users, items, vals, ts


@pytest.fixture(scope="module")
def trained():
    users, items, vals, ts = ratings_arrays()
    pd_j = JR.RecommendationPreparator().prepare(
        JR.TrainingData(JC.RatingsData(users, items, vals, ts)))
    pd_t = TR.RecommendationPreparator().prepare(
        TR.TrainingData(TC.RatingsData(users, items, vals, ts)))
    kw = dict(rank=8, num_iterations=3, lam=0.05, seed=3)
    algo_j = JR.ALSAlgorithm(JR.ALSAlgorithmParams(**kw))
    algo_t = TR.ALSAlgorithm(TR.ALSAlgorithmParams(device="cpu", **kw))
    return (pd_j, algo_j, algo_j.train(pd_j), pd_t, algo_t,
            algo_t.train(pd_t), users)


def assert_same_result(res_t, res_j, rtol=0.0):
    items_t = [s.item for s in res_t.item_scores]
    items_j = [s.item for s in res_j.item_scores]
    assert items_t == items_j
    np.testing.assert_allclose([s.score for s in res_t.item_scores],
                               [s.score for s in res_j.item_scores],
                               rtol=rtol, atol=SCORE_TOL)


def test_preparator_builds_identical_coo_and_vocab(trained):
    pd_j, _, _, pd_t, _, _, _ = trained
    for name in ("user_idx", "item_idx", "rating"):
        np.testing.assert_array_equal(getattr(pd_t.ratings_coo, name),
                                      getattr(pd_j.ratings_coo, name))
    assert list(pd_t.user_ix.ids) == list(pd_j.user_ix._ids)
    assert list(pd_t.item_ix.ids) == list(pd_j.item_ix._ids)


def test_trained_factors_match(trained):
    _, _, mj, _, _, mt, _ = trained
    for a, b in ((mj.als.user_factors, mt.als.user_factors),
                 (mj.als.item_factors, mt.als.item_factors)):
        assert np.abs(a - b).max() <= FACTOR_TOL * np.abs(a).max()


def test_predict_matches_reference(trained):
    _, algo_j, mj, _, algo_t, mt, users = trained
    for user in sorted(set(users))[:20]:
        q_j, q_t = JR.Query(user=user, num=10), TR.Query(user=user, num=10)
        assert_same_result(algo_t.predict(mt, q_t),
                           algo_j.predict(mj, q_j), rtol=SCORE_RTOL)
    assert algo_t.predict(mt, TR.Query("nobody", 5)).to_dict() == \
        {"itemScores": []}


def test_batch_predict_matches_reference_exact_mode(trained, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    _, algo_j, mj, _, algo_t, mt, users = trained
    picks = sorted(set(users))[:12] + ["nobody"]
    nums = [3, 10, 7] * 5
    got_j = dict(algo_j.batch_predict(
        mj, [(k, JR.Query(u, n)) for k, (u, n) in enumerate(zip(picks,
                                                                 nums))]))
    got_t = dict(algo_t.batch_predict(
        mt, [(k, TR.Query(u, n)) for k, (u, n) in enumerate(zip(picks,
                                                                 nums))]))
    assert sorted(got_t) == sorted(got_j)
    for k in got_j:
        assert_same_result(got_t[k], got_j[k], rtol=SCORE_RTOL)


def carried(mj):
    return from_jax_model(mj.als.user_factors, mj.als.item_factors,
                          list(mj.user_ix._ids), list(mj.item_ix._ids),
                          mj.als.rank, device="cpu")


def test_from_jax_model_serves_the_same_topk(trained, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    _, algo_j, mj, _, algo_t, _, users = trained
    m = carried(mj)
    np.testing.assert_array_equal(m.als.user_factors, mj.als.user_factors)
    picks = sorted(set(users))[:15]
    for user in picks:
        assert_same_result(algo_t.predict(m, TR.Query(user, 10)),
                           algo_j.predict(mj, JR.Query(user, 10)))
    got_j = dict(algo_j.batch_predict(
        mj, [(k, JR.Query(u, 6)) for k, u in enumerate(picks)]))
    got_t = dict(algo_t.batch_predict(
        m, [(k, TR.Query(u, 6)) for k, u in enumerate(picks)]))
    for k in got_j:
        assert_same_result(got_t[k], got_j[k])


def test_from_jax_model_rejects_mismatched_ids(trained):
    mj = trained[2]
    with pytest.raises(ValueError):
        from_jax_model(mj.als.user_factors, mj.als.item_factors,
                       list(mj.user_ix._ids)[:-1], list(mj.item_ix._ids),
                       mj.als.rank, device="cpu")


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def server(trained):
    _, _, mj, _, algo_t, _, _ = trained
    engine = TR.RecommendationEngineFactory.apply()
    ep = TR.RecommendationEngineFactory.engine_params(
        TC.RatingsData([], [], []))
    from predictionio_tpu_torch.core import TrainResult
    srv = EngineServer(ServerConfig(ip="127.0.0.1", port=0), engine, ep,
                       TrainResult(models=[carried(mj)],
                                   algorithms=[algo_t]))
    srv.start(background=True)
    yield f"http://127.0.0.1:{srv.config.port}"
    srv.stop()


def test_server_answers_like_reference(server, trained, monkeypatch):
    # f32 scores against the reference's predict: the default f16
    # readback is held in tests/test_torch_serve_plane.py
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    _, algo_j, mj, _, _, _, users = trained
    for user in sorted(set(users))[:5]:
        status, body = _post(server + "/queries.json",
                             json.dumps({"user": user, "num": 4}).encode())
        want = algo_j.predict(mj, JR.Query(user, 4)).to_dict()
        assert status == 200
        assert [s["item"] for s in body["itemScores"]] == \
            [s["item"] for s in want["itemScores"]]
        np.testing.assert_allclose(
            [s["score"] for s in body["itemScores"]],
            [s["score"] for s in want["itemScores"]], rtol=0,
            atol=SCORE_TOL)
        assert set(body) == set(want) == {"itemScores"}


@pytest.mark.parametrize("body", [b'{"user": ', b"[1, 2]", b'{"num": 3}',
                                  b'{"user": "u1", "num": "many"}'])
def test_server_rejects_malformed_bodies(server, body):
    status, resp = _post(server + "/queries.json", body)
    assert status == 400 and "message" in resp


def test_server_unknown_user_and_status(server):
    assert _post(server + "/queries.json",
                 b'{"user": "nobody", "num": 3}') == \
        (200, {"itemScores": []})
    with urllib.request.urlopen(server + "/", timeout=30) as r:
        assert r.status == 200 and json.loads(r.read())["status"] == "alive"


QUERY_BODIES = [
    {"user": "u1", "num": 4},
    {"user": "u1", "num": 4, "categories": ["c1", "c2"]},
    {"user": "u1", "num": 4, "creationYear": 1995},
    {"user": "u1", "num": 4, "categories": ["c1"], "creationYear": 1995.0},
    {"user": "u1", "num": 4, "categories": None, "creationYear": None},
    {"user": "u1", "num": 4, "categories": []},
    {"user": 7, "num": "4", "creationYear": "2001"},
    {"user": "u1", "num": 4, "categories": "ab"},
]
MALFORMED_BODIES = [
    {"num": 4}, {"user": "u1"}, {"user": "u1", "num": "four"},
    {"user": "u1", "num": 4, "creationYear": "recent"},
    {"user": "u1", "num": 4, "categories": 3},
    {"user": "u1", "num": 4, "creationYear": [1990]},
]


@pytest.mark.parametrize("body", QUERY_BODIES)
def test_query_wire_format_matches_reference(body):
    q_t, q_j = TR.Query.from_dict(body), JR.Query.from_dict(body)
    assert (q_t.user, q_t.num, q_t.categories, q_t.creation_year) == \
        (q_j.user, q_j.num, q_j.categories, q_j.creation_year)


@pytest.mark.parametrize("body", MALFORMED_BODIES)
def test_malformed_query_field_raises_like_reference_and_answers_400(
        server, body):
    errors = []
    for Q in (TR.Query, JR.Query):
        with pytest.raises((KeyError, ValueError, TypeError)) as e:
            Q.from_dict(body)
        errors.append(e.type)
    assert errors[0] is errors[1]
    status, resp = _post(server + "/queries.json", json.dumps(body).encode())
    assert status == 400 and "message" in resp


def test_engine_params_json_round_trips():
    engine = TR.RecommendationEngineFactory.apply()
    variant = {
        "datasource": {"params": {"app_name": "a", "channel_name": "ch",
                                  "event_names": ["rate"], "buy_rating": 3,
                                  "read_items": True}},
        "preparator": {"params": {"exclude_items_file": "x.txt"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 8, "num_iterations": 2, "lam": 0.1, "seed": 3,
            "return_properties": ["creationYear"], "device": "cpu"}}]}
    ep = engine.json_to_engine_params(variant)
    assert ep.data_source_params[1].event_names == ("rate",)
    assert ep.data_source_params[1].buy_rating == 3.0
    recorded = json.loads(json.dumps(engine.engine_params_to_json(ep)))
    back = engine.json_to_engine_params(recorded)
    assert back.algorithm_params_list == ep.algorithm_params_list
    assert back.preparator_params == ep.preparator_params
    assert vars(back.data_source_params[1]) == vars(ep.data_source_params[1])
    # the reference reads the same variant into the same values
    from predictionio_tpu.models import get_engine_factory
    ep_j = get_engine_factory("recommendation").apply() \
        .json_to_engine_params({**variant, "algorithms": [{
            "name": "als", "params": {
                k: v for k, v in variant["algorithms"][0]["params"].items()
                if k != "device"}}]})
    for slot in ("data_source_params", "preparator_params"):
        j, t = vars(getattr(ep_j, slot)[1]), vars(getattr(ep, slot)[1])
        assert {k: t[k] for k in t if k in j} == {k: j[k] for k in t
                                                  if k in j}
    with pytest.raises(ValueError, match="Unknown parameter"):
        engine.json_to_engine_params({"algorithms": [{
            "name": "als", "params": {"rank": 2, "numIterations": 3}}]})
