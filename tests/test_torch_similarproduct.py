"""Port parity: the similar-product template (view counts -> implicit ALS ->
cosine top-k under business-rule filters) vs the JAX reference on the same
training data, plus its id maps, similarity ops, model carry-over and
engine server.

Tolerances: the COO, vocabularies and filter masks are held array for
array. The trained tables to 1.5e-5 of the largest factor (the implicit
parity bar of tests/test_torch_implicit.py: 4x the f32-vs-f64 reading).
Ranked ids must match exactly and scores within 1e-5: the tables' f32
difference moves a cosine sum of a few unit vectors by ~1e-6. The
reference's batched path is held in exact mode (`PIO_SERVE_PACK=exact`),
so its f16 score packing does not enter the comparison.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.models import common as JC
from predictionio_tpu.models import similarproduct as JS
from predictionio_tpu.ops import similarity as JSim
from predictionio_tpu_torch.core import TrainResult
from predictionio_tpu_torch.data.bimap import EntityIdIxMap as TMap
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.models import common as TC
from predictionio_tpu_torch.models import similarproduct as TS
from predictionio_tpu_torch.ops import similarity as TSim
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.weights import from_jax_similarproduct_model

FACTOR_TOL = 1.5e-5
SCORE_TOL = 1e-5
N_USERS, N_ITEMS, N_VIEWS = 60, 40, 900


def fixture_data(seed=3):
    """Views with repeats (so the sum-dedup matters), $set items with
    categories, years on some and a title on others, a few $set items
    never viewed, and like/dislike events with re-decisions over time."""
    rng = np.random.default_rng(seed)
    cats = synthetic_item_categories(N_ITEMS, n_categories=4, seed=seed)
    items = {}
    for k in range(N_ITEMS):
        props = {"categories": list(cats[k])}
        if k % 3 == 0:
            props["year"] = 1990 + k % 7
        if k % 4 == 1:
            props["title"] = f"Item {k}"
        items[f"i{k}"] = props
    w = rng.lognormal(0.0, 1.0, N_USERS)
    users = np.char.add("u", rng.choice(N_USERS, N_VIEWS,
                                        p=w / w.sum()).astype(str))
    viewed = np.char.add("i", rng.integers(0, N_ITEMS - 3,
                                           N_VIEWS).astype(str))
    ts = rng.integers(0, 1000, N_VIEWS).astype(np.int64)
    like_vals = np.where(rng.random(N_VIEWS) < 0.7, 1.0, -1.0)
    return items, users, viewed, ts, like_vals.astype(np.float32)


def training_data(pkg, items, users, viewed, ts, like_vals):
    common = JC if pkg is JS else TC
    return pkg.TrainingData(
        users={},
        items={k: pkg.Item(tuple(p["categories"]), properties=p)
               for k, p in items.items()},
        view_events=common.RatingsData(users, viewed,
                                       np.ones(len(users), np.float32), ts),
        like_events=common.RatingsData(users, viewed, like_vals, ts))


PARAMS = dict(rank=8, num_iterations=5, lam=0.01, alpha=2.0, seed=4)


@pytest.fixture(scope="module")
def trained():
    data = fixture_data()
    td_j, td_t = training_data(JS, *data), training_data(TS, *data)
    out = {}
    for name, j_cls, t_cls in (("als", JS.ALSAlgorithm, TS.ALSAlgorithm),
                               ("like", JS.LikeAlgorithm,
                                TS.LikeAlgorithm)):
        aj = j_cls(JS.ALSAlgorithmParams(**PARAMS,
                                         return_properties=("title",)))
        at = t_cls(TS.ALSAlgorithmParams(**PARAMS, solver="chol_cuda",
                                         device="cpu",
                                         return_properties=("title",)))
        out[name] = (aj, aj.train(JS.PreparedData(td_j)), at,
                     at.train(TS.PreparedData(td_t)))
    return td_j, td_t, out


def assert_same_result(res_t, res_j, atol=SCORE_TOL):
    d_t, d_j = res_t.to_dict(), res_j.to_dict()
    assert [s["item"] for s in d_t["itemScores"]] == \
        [s["item"] for s in d_j["itemScores"]]
    np.testing.assert_allclose([s["score"] for s in d_t["itemScores"]],
                               [s["score"] for s in d_j["itemScores"]],
                               rtol=0, atol=atol)
    for a, b in zip(d_t["itemScores"], d_j["itemScores"]):
        assert set(a) == set(b)
        assert {k: v for k, v in a.items() if k != "score"} == \
            {k: v for k, v in b.items() if k != "score"}


def test_bimap_build_and_lookups_match_reference():
    ids = np.array(["b", "a", "c", "a", "z10", "z9"])
    jm, tm = JMap.build(list(ids)), TMap.build(ids)
    assert list(tm.ids) == list(jm._ids)
    assert list(TMap.build(list(ids)).ids) == list(jm._ids)
    probe = ["c", "nope", "a", "z9"]
    np.testing.assert_array_equal(tm.to_indices(probe),
                                  jm.to_indices(probe))
    np.testing.assert_array_equal(tm.to_indices_array(np.array(probe)),
                                  jm.to_indices_array(np.array(probe)))
    assert tm.to_indices_array(np.array([], dtype=str)).size == 0


@pytest.mark.parametrize("algo", ["als", "like"])
def test_build_ratings_identical_coo_and_vocabularies(trained, algo):
    td_j, td_t, out = trained
    aj, _, at, _ = out[algo]
    uj, ij, cj = aj._build_ratings(td_j)
    ut, it, ct = at._build_ratings(td_t)
    assert list(ut.ids) == list(uj._ids)
    assert list(it.ids) == list(ij._ids)
    assert len(it) == N_ITEMS     # the never-viewed $set items resolve
    for name in ("user_idx", "item_idx", "rating"):
        np.testing.assert_array_equal(getattr(ct, name), getattr(cj, name))
    assert (ct.n_users, ct.n_items) == (cj.n_users, cj.n_items)


@pytest.mark.parametrize("algo", ["als", "like"])
def test_trained_tables_match_reference(trained, algo):
    _, _, out = trained
    _, mj, _, mt = out[algo]
    for a, b in ((mj.item_factors_raw, mt.item_factors_raw),
                 (mj.user_factors, mt.user_factors),
                 (mj.item_factors_normalized, mt.item_factors_normalized)):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= FACTOR_TOL * np.abs(a).max()
    assert list(mt.user_ix.ids) == list(mj.user_ix._ids)
    assert mt.item_categories == mj.item_categories
    np.testing.assert_array_equal(mt.item_years, mj.item_years)
    assert torch.equal(mt.table(), torch.from_numpy(
        mt.item_factors_normalized))


QUERIES = [
    {"items": ["i1"], "num": 10},
    {"items": ["i2", "i7"], "num": 5},
    {"items": ["i3", "i11", "i20"], "num": 10},
    {"items": ["i4"], "num": 10, "categories": ["c1"]},
    {"items": ["i5"], "num": 10, "categories": ["c0", "c3"]},
    {"items": ["i6"], "num": 10, "whiteList": ["i1", "i8", "i9", "i30"]},
    {"items": ["i8"], "num": 10, "blackList": ["i1", "i2", "i3"]},
    {"items": ["i9"], "num": 10, "recommendFromYear": 1993},
    {"items": ["i10", "nope"], "num": 4},
    {"items": ["nope"], "num": 3},
    {"items": ["i39"], "num": 10},            # a $set item never viewed
]


@pytest.mark.parametrize("algo", ["als", "like"])
@pytest.mark.parametrize("q", QUERIES, ids=lambda q: json.dumps(q))
def test_predict_matches_reference(trained, algo, q):
    _, _, out = trained
    aj, mj, at, mt = out[algo]
    assert_same_result(at.predict(mt, TS.Query.from_dict(q)),
                       aj.predict(mj, JS.Query.from_dict(q)))


@pytest.mark.parametrize("algo", ["als", "like"])
def test_batch_predict_matches_reference_and_single(trained, algo,
                                                    monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    _, _, out = trained
    aj, mj, at, mt = out[algo]
    got_j = dict(aj.batch_predict(mj, [(k, JS.Query.from_dict(q))
                                       for k, q in enumerate(QUERIES)]))
    got_t = dict(at.batch_predict(mt, [(k, TS.Query.from_dict(q))
                                       for k, q in enumerate(QUERIES)]))
    assert sorted(got_t) == sorted(got_j) == list(range(len(QUERIES)))
    for k, q in enumerate(QUERIES):
        assert_same_result(got_t[k], got_j[k])
        assert_same_result(got_t[k],
                           at.predict(mt, TS.Query.from_dict(q)))


def test_unknown_items_answer_empty(trained):
    _, _, out = trained
    _, _, at, mt = out["als"]
    assert at.predict(mt, TS.Query(("nope", "zip"), 5)).to_dict() == \
        {"itemScores": []}
    assert dict(at.batch_predict(mt, [(0, TS.Query(("nope",), 5))])) \
        [0].to_dict() == {"itemScores": []}


def test_result_carries_requested_properties_only(trained):
    _, _, out = trained
    _, _, at, mt = out["als"]
    d = at.predict(mt, TS.Query(("i1",), 10)).to_dict()
    assert d["itemScores"] and all(set(s) == {"item", "score", "title"}
                                   for s in d["itemScores"])
    plain = TS.ALSAlgorithm(TS.ALSAlgorithmParams(device="cpu"))
    assert all(set(s) == {"item", "score"} for s in
               plain.predict(mt, TS.Query(("i1",), 10)).to_dict()
               ["itemScores"])


def carried(mj, td_t):
    return from_jax_similarproduct_model(
        mj.item_factors_normalized, list(mj.item_ix._ids), td_t.items,
        item_factors_raw=mj.item_factors_raw, user_factors=mj.user_factors,
        user_ids=list(mj.user_ix._ids), device="cpu")


def test_from_jax_model_answers_identically(trained, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    _, td_t, out = trained
    aj, mj, at, _ = out["als"]
    m = carried(mj, td_t)
    np.testing.assert_array_equal(m.item_factors_normalized,
                                  mj.item_factors_normalized)
    assert m.item_categories == mj.item_categories
    for q in QUERIES:
        assert_same_result(at.predict(m, TS.Query.from_dict(q)),
                           aj.predict(mj, JS.Query.from_dict(q)))
    got_j = dict(aj.batch_predict(mj, [(k, JS.Query.from_dict(q))
                                       for k, q in enumerate(QUERIES)]))
    got_t = dict(at.batch_predict(m, [(k, TS.Query.from_dict(q))
                                      for k, q in enumerate(QUERIES)]))
    for k in got_j:
        assert_same_result(got_t[k], got_j[k])


def test_from_jax_model_rejects_mismatched_ids(trained):
    _, td_t, out = trained
    mj = out["als"][1]
    with pytest.raises(ValueError):
        from_jax_similarproduct_model(mj.item_factors_normalized,
                                      list(mj.item_ix._ids)[:-1],
                                      td_t.items, device="cpu")
    with pytest.raises(ValueError):
        from_jax_similarproduct_model(
            mj.item_factors_normalized, list(mj.item_ix._ids), td_t.items,
            user_factors=mj.user_factors, device="cpu")


def test_similarity_ops_match_reference():
    rng = np.random.default_rng(1)
    raw = rng.standard_normal((50, 6)).astype(np.float32)
    raw[7] = 0.0
    tj, tt = JSim.normalize_rows(raw), TSim.normalize_rows(raw)
    np.testing.assert_array_equal(tt, tj)
    cats = [set(c) for c in synthetic_item_categories(50, 5, seed=1)]
    cats[3] = None
    kw = dict(exclude=[1, 2, 60], white_list=None, item_categories=cats,
              categories={"c2"})
    np.testing.assert_array_equal(TSim.build_filter_mask(50, **kw),
                                  JSim.build_filter_mask(50, **kw))
    kw = dict(exclude=[4], white_list=[4, 5, 6, -1, 99])
    mask = TSim.build_filter_mask(50, **kw)
    np.testing.assert_array_equal(mask, JSim.build_filter_mask(50, **kw))
    q = tt[[3, 9]]
    s_j, i_j = JSim.cosine_top_k(tj, q, 8, mask)
    s_t, i_t = TSim.cosine_top_k(torch.from_numpy(tt), q, 8, mask)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)
    s, i = TSim.masked_top_k_batch(torch.from_numpy(tt), q,
                                   np.stack([mask, ~mask]), 5)
    # k pads to its pow2 bucket (at least 16), as the reference's does
    assert s.shape == i.shape == (2, 16)
    ref = tt @ q[1]
    want = np.argsort(-np.where(~mask & (ref > 0), ref, -np.inf))[:5]
    keep_s, keep_i = TSim.unpack_top_k_rows(s[1], i[1], 5)
    np.testing.assert_array_equal(keep_i, want[:len(keep_i)])
    assert np.isfinite(keep_s).all() and (keep_s > 0).all()


def test_query_from_dict_reads_camel_case():
    q = TS.Query.from_dict({"items": ["a", "b"], "num": "3",
                            "categories": ["x"], "whiteList": ["w"],
                            "blackList": ["k"], "recommendFromYear": 1990})
    assert q == TS.Query(("a", "b"), 3, ("x",), ("w",), ("k",), 1990)
    assert q == TS.Query(**JS.Query.from_dict(
        {"items": ["a", "b"], "num": 3, "categories": ["x"],
         "whiteList": ["w"], "blackList": ["k"],
         "recommendFromYear": 1990}).__dict__)


def test_engine_trains_both_algorithms():
    items, users, viewed, ts, like_vals = fixture_data(seed=5)
    td = training_data(TS, items, users, viewed, ts, like_vals)
    engine = TS.SimilarProductEngineFactory.apply()
    ep = TS.SimilarProductEngineFactory.engine_params(
        td.items, td.view_events,
        TS.ALSAlgorithmParams(rank=4, num_iterations=2, device="cpu"),
        like_events=td.like_events)
    ep = TS.EngineParams(
        data_source_params=ep.data_source_params,
        preparator_params=ep.preparator_params,
        algorithm_params_list=[*ep.algorithm_params_list,
                               ("likealgo", TS.ALSAlgorithmParams(
                                   rank=4, num_iterations=2,
                                   device="cpu"))],
        serving_params=ep.serving_params)
    tr = engine.train(ep)
    assert [type(a).__name__ for a in tr.algorithms] == \
        ["ALSAlgorithm", "LikeAlgorithm"]
    for algo, model in zip(tr.algorithms, tr.models):
        assert model.item_factors_normalized.shape == (N_ITEMS, 4)
        assert algo.predict(model, TS.Query(("i1",), 3)).item_scores
    # array params read no store: items without view events are refused
    with pytest.raises(ValueError, match="view_events"):
        TS.SimilarProductDataSource(
            TS.DataSourceParams(items=td.items)).read_training()


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def server(trained):
    _, td_t, out = trained
    _, mj, at, _ = out["als"]
    engine = TS.SimilarProductEngineFactory.apply()
    ep = TS.SimilarProductEngineFactory.engine_params(td_t.items,
                                                      td_t.view_events)
    srv = EngineServer(ServerConfig(ip="127.0.0.1", port=0), engine, ep,
                       TrainResult(models=[carried(mj, td_t)],
                                   algorithms=[at]))
    srv.start(background=True)
    yield f"http://127.0.0.1:{srv.config.port}"
    srv.stop()


def test_server_answers_like_reference(server, trained, monkeypatch):
    # f32 scores against the reference's predict: the default f16
    # readback is held in tests/test_torch_serve_plane.py
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    _, _, out = trained
    aj, mj, _, _ = out["als"]
    for q in QUERIES:
        status, body = _post(server + "/queries.json",
                             json.dumps(q).encode())
        assert status == 200
        want = aj.predict(mj, JS.Query.from_dict(q)).to_dict()
        assert [s["item"] for s in body["itemScores"]] == \
            [s["item"] for s in want["itemScores"]]
        np.testing.assert_allclose(
            [s["score"] for s in body["itemScores"]],
            [s["score"] for s in want["itemScores"]], rtol=0,
            atol=SCORE_TOL)
    assert _post(server + "/queries.json",
                 b'{"items": ["nope"], "num": 3}') == \
        (200, {"itemScores": []})


@pytest.mark.parametrize("body", [b'{"items": ', b"[1, 2]",
                                  b'{"num": 3}', b'{"items": ["i1"]}',
                                  b'{"items": ["i1"], "num": "many"}',
                                  b'{"items": 5, "num": 3}'])
def test_server_rejects_malformed_bodies(server, body):
    status, resp = _post(server + "/queries.json", body)
    assert status == 400 and "message" in resp
