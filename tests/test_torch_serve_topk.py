"""Port parity: the serve path's batched top-k (`ops/als.users_topk_serve`,
`ops/similarity.masked_top_k_batch_begin`) and the templates'
`batch_predict_begin` vs the JAX reference's `users_topk_serve`,
`masked_top_k_batch` and `batch_predict`, on the CPU.

Both packages score the same f32 tables (the port's carried from the
reference's by `weights.from_jax_model` / `from_jax_similarproduct_model`)
under both pack modes of `PIO_SERVE_PACK`. Each row is cut to its query's
num and its finite slots. Ids are held exactly, between the packages and
against a float64 top-k. Scores are held against the float64 scores:
within the f32 dot product's rounding bound (n 2^-24 sum|a_i b_i|) in
`exact`, and within f16 rounding on top of it (2^-11 |s|) in `on`; the
two packages' f16 scores differ by at most one f16 step (2^-10 |s|).
"""

import numpy as np
import pytest

from predictionio_tpu.data.bimap import EntityIdIxMap as JMap
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.models import similarproduct as JS
from predictionio_tpu.ops import als as JALS
from predictionio_tpu.ops import similarity as JSim
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.models import similarproduct as TS
from predictionio_tpu_torch.ops import als as TALS
from predictionio_tpu_torch.ops import similarity as TSim
from predictionio_tpu_torch.weights import (from_jax_model,
                                            from_jax_similarproduct_model)

RANK, N_USERS, N_ITEMS = 8, 40, 50
MODES = ["on", "exact"]


def dot_bound(a64: np.ndarray, B64: np.ndarray, n: int) -> np.ndarray:
    """The f32 rounding bound of B @ a, per row of B."""
    return n * 2.0 ** -24 * (np.abs(B64) @ np.abs(a64))


def hold_scores(got, s64, bound, mode, what):
    got = np.asarray(got, dtype=np.float64)
    tol = bound + (2.0 ** -11 * np.abs(s64) if mode == "on" else 0.0)
    assert (np.abs(got - s64) <= tol).all(), (what, got, s64)


def hold_pair(t_scores, j_scores, s64, mode):
    """The two packages' served scores: one f16 step apart at most."""
    step = 2.0 ** -10 * np.abs(s64) if mode == "on" else 0.0
    np.testing.assert_array_less(
        np.abs(np.asarray(t_scores, np.float64) - np.asarray(j_scores)),
        step + 2 * 2.0 ** -24 * RANK * np.abs(s64) + 1e-30)


@pytest.fixture(scope="module")
def rec():
    rng = np.random.default_rng(0)
    U = rng.standard_normal((N_USERS, RANK)).astype(np.float32)
    V = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    cats = synthetic_item_categories(N_ITEMS, n_categories=4, seed=0)
    user_ix = JMap.build([f"u{k}" for k in range(N_USERS)])
    item_ix = JMap.build([f"i{k}" for k in range(N_ITEMS)])
    props = []
    for ix in range(N_ITEMS):
        k = int(item_ix.id_of(ix)[1:])
        p = {"categories": list(cats[k])}
        if k % 4:
            p["creationYear"] = 1990 + k % 9
        props.append(p if k % 7 else None)
    c, y = JR.RecommendationModel.derive_filters(props)
    mj = JR.RecommendationModel(JALS.ALSModel(U, V, RANK), user_ix, item_ix,
                                item_properties=props, item_categories=c,
                                item_years=y)
    mt = from_jax_model(U, V, list(user_ix._ids), list(item_ix._ids), RANK,
                        device="cpu", item_properties=props)
    return mj, mt


@pytest.fixture(scope="module")
def sim():
    rng = np.random.default_rng(1)
    T = rng.standard_normal((N_ITEMS, RANK)).astype(np.float32)
    T = (T / np.linalg.norm(T, axis=1, keepdims=True)).astype(np.float32)
    cats = synthetic_item_categories(N_ITEMS, n_categories=4, seed=1)
    raw = {f"i{k}": dict({"categories": list(cats[k])},
                         **({"year": 1990 + k % 9} if k % 3 else {}))
           for k in range(N_ITEMS)}
    item_ix = JMap.build(list(raw))
    items_j = {k: JS.Item(tuple(p["categories"]), properties=p)
               for k, p in raw.items()}
    items_t = {k: TS.Item(tuple(p["categories"]), properties=p)
               for k, p in raw.items()}
    mj = JS.SimilarProductModel(
        item_factors_normalized=T,
        **JS.ItemMetadataModel.metadata_kwargs(items_j, item_ix))
    mt = from_jax_similarproduct_model(T, list(item_ix._ids), items_t,
                                       device="cpu")
    return mj, mt


@pytest.mark.parametrize("mode", MODES)
def test_users_topk_serve_matches_the_reference(rec, mode, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", mode)
    mj, mt = rec
    users = np.array([3, 0, 17, 39, 3, 22, 8])
    U64 = mj.als.user_factors.astype(np.float64)
    V64 = mj.als.item_factors.astype(np.float64)
    for num in (1, 5, 16, 20, N_ITEMS):
        s_t, i_t = TALS.users_topk_serve(mt.als, users, num)
        s_j, i_j = JALS.users_topk_serve(mj.als, users, num)
        assert s_t.shape[0] == len(users)
        for row, u in enumerate(users):
            a = TSim.unpack_top_k_rows(s_t[row], i_t[row], num)
            b = JSim.unpack_top_k_rows(s_j[row], i_j[row], num)
            np.testing.assert_array_equal(a[1], b[1])
            s64 = V64 @ U64[u]
            np.testing.assert_array_equal(
                a[1], np.argsort(-s64, kind="stable")[:num])
            hold_scores(a[0], s64[a[1]], dot_bound(U64[u], V64[a[1]], RANK),
                        mode, (num, u))
            hold_pair(a[0], b[0], s64[a[1]], mode)
            if mode == "on":       # the scores are the f16 payload's
                np.testing.assert_array_equal(
                    a[0].astype(np.float16).astype(np.float32), a[0])


@pytest.mark.parametrize("fp", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_masked_top_k_batch_begin_matches_the_reference(sim, mode, fp,
                                                        monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", mode)
    mj, mt = sim
    rng = np.random.default_rng(2)
    T = mj.item_factors_normalized
    q = rng.standard_normal((5, RANK)).astype(np.float32)
    masks = rng.random((5, N_ITEMS)) < 0.6
    T64, q64 = T.astype(np.float64), q.astype(np.float64)
    for k in (3, 16, 17):
        s_t, i_t = TSim.masked_top_k_batch_begin(mt.table(), q, masks, k,
                                                 filter_positive=fp)()
        s_j, i_j = JSim.masked_top_k_batch(T, q, masks, k,
                                           filter_positive=fp)
        for row in range(5):
            a = TSim.unpack_top_k_rows(s_t[row], i_t[row], k)
            b = JSim.unpack_top_k_rows(s_j[row], i_j[row], k)
            np.testing.assert_array_equal(a[1], b[1])
            s64 = T64 @ q64[row]
            ok = masks[row] & ((s64 > 0) if fp else True)
            want = np.argsort(-np.where(ok, s64, -np.inf), kind="stable")
            np.testing.assert_array_equal(a[1], want[:len(a[1])])
            assert len(a[1]) == min(k, int(ok.sum()))
            hold_scores(a[0], s64[a[1]],
                        dot_bound(q64[row], T64[a[1]], RANK), mode, k)
            hold_pair(a[0], b[0], s64[a[1]], mode)


REC_QUERIES = [dict(user="u3", num=4), dict(user="u7", num=20),
               dict(user="u1", num=5, categories=("c1",)),
               dict(user="u9", num=6, creation_year=1994),
               dict(user="u2", num=3, categories=("c0", "c2"),
                    creation_year=1992),
               dict(user="nobody", num=3),
               dict(user="u5", num=4, categories=("none",)),
               dict(user="u3", num=2)]


@pytest.mark.parametrize("mode", MODES)
def test_recommendation_batch_predict_begin_matches_the_reference(
        rec, mode, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", mode)
    mj, mt = rec
    aj = JR.ALSAlgorithm(JR.ALSAlgorithmParams(
        rank=RANK, return_properties=("creationYear",)))
    at = TR.ALSAlgorithm(TR.ALSAlgorithmParams(
        rank=RANK, device="cpu", return_properties=("creationYear",)))
    got = dict(at.batch_predict_begin(mt, [
        (k, TR.Query(**q)) for k, q in enumerate(REC_QUERIES)])())
    want = dict(aj.batch_predict(mj, [
        (k, JR.Query(**q)) for k, q in enumerate(REC_QUERIES)]))
    U64 = mj.als.user_factors.astype(np.float64)
    V64 = mj.als.item_factors.astype(np.float64)
    assert sorted(got) == sorted(want) == list(range(len(REC_QUERIES)))
    for k, q in enumerate(REC_QUERIES):
        g, w = got[k].to_dict()["itemScores"], want[k].to_dict()[
            "itemScores"]
        assert [s["item"] for s in g] == [s["item"] for s in w]
        assert [s["creationYear"] for s in g] == \
            [s["creationYear"] for s in w]
        if not g:
            assert q["user"] == "nobody" or q.get("categories") == \
                ("none",)
            continue
        uix = mj.user_ix[q["user"]]
        ix = mj.item_ix.to_indices([s["item"] for s in g])
        s64 = V64[ix] @ U64[uix]
        hold_scores([s["score"] for s in g], s64,
                    dot_bound(U64[uix], V64[ix], RANK), mode, q)
        hold_pair([s["score"] for s in g], [s["score"] for s in w], s64,
                  mode)


SIM_QUERIES = [dict(items=["i3"], num=4),
               dict(items=["i1", "i8"], num=20, categories=["c1"]),
               dict(items=["i2", "i5", "i9"], num=5),
               dict(items=["i4"], num=6, whiteList=["i1", "i6", "i7", "i30",
                                                    "i31", "i44"]),
               dict(items=["i6"], num=5, blackList=["i10", "i11", "i12"]),
               dict(items=["i7"], num=7, recommendFromYear=1994),
               dict(items=["nope"], num=3),
               dict(items=["i0", "nope"], num=3, categories=["c3"])]


@pytest.mark.parametrize("cls", ["ALSAlgorithm", "LikeAlgorithm"])
@pytest.mark.parametrize("mode", MODES)
def test_similarproduct_batch_predict_begin_matches_the_reference(
        sim, mode, cls, monkeypatch):
    monkeypatch.setenv("PIO_SERVE_PACK", mode)
    mj, mt = sim
    aj = getattr(JS, cls)(JS.ALSAlgorithmParams(rank=RANK,
                                                return_properties=("year",)))
    at = getattr(TS, cls)(TS.ALSAlgorithmParams(rank=RANK, device="cpu",
                                                return_properties=("year",)))
    got = dict(at.batch_predict_begin(mt, [
        (k, TS.Query.from_dict(q)) for k, q in enumerate(SIM_QUERIES)])())
    want = dict(aj.batch_predict(mj, [
        (k, JS.Query.from_dict(q)) for k, q in enumerate(SIM_QUERIES)]))
    T64 = mj.item_factors_normalized.astype(np.float64)
    assert sorted(got) == sorted(want)
    for k, q in enumerate(SIM_QUERIES):
        g, w = got[k].to_dict()["itemScores"], want[k].to_dict()[
            "itemScores"]
        assert [s["item"] for s in g] == [s["item"] for s in w]
        assert [s["year"] for s in g] == [s["year"] for s in w]
        if not g:
            assert q["items"] == ["nope"]
            continue
        q_ix = mj.item_ix.to_indices([i for i in q["items"]
                                      if i in mj.item_ix])
        qsum = mj.item_factors_normalized[q_ix].sum(axis=0).astype(
            np.float64)
        ix = mj.item_ix.to_indices([s["item"] for s in g])
        s64 = T64[ix] @ qsum
        hold_scores([s["score"] for s in g], s64,
                    dot_bound(qsum, T64[ix], RANK + 3), mode, q)
        hold_pair([s["score"] for s in g], [s["score"] for s in w], s64,
                  mode)


def test_batch_predict_is_begin_then_finish(rec, sim):
    mj, mt = rec
    at = TR.ALSAlgorithm(TR.ALSAlgorithmParams(rank=RANK, device="cpu"))
    qs = [(k, TR.Query(**q)) for k, q in enumerate(REC_QUERIES)]
    assert [(k, r.to_dict()) for k, r in at.batch_predict(mt, qs)] == \
        [(k, r.to_dict()) for k, r in at.batch_predict_begin(mt, qs)()]
    sj, st = sim
    bt = TS.ALSAlgorithm(TS.ALSAlgorithmParams(rank=RANK, device="cpu"))
    qs = [(k, TS.Query.from_dict(q)) for k, q in enumerate(SIM_QUERIES)]
    assert [(k, r.to_dict()) for k, r in bt.batch_predict(st, qs)] == \
        [(k, r.to_dict()) for k, r in bt.batch_predict_begin(st, qs)()]


def test_serve_shapes_pad_to_their_buckets(rec, monkeypatch):
    """The bucket dims of both serve executables are the reference's:
    the tables at their row buckets (64 here), batch and k at theirs."""
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    mj, mt = rec
    assert TALS.batch_predict_dims(mt.als, 5, 3) == \
        {"u": 64, "i": 64, "b": 8, "k": 16, "r": RANK, "p": 2}
    for batch, k in ((5, 3), (16, 20), (1, 40), (3, 100)):
        assert TALS.batch_predict_dims(mt.als, batch, k) == \
            JALS.batch_predict_dims(mj.als, batch, k)
        for fp in (False, True):
            assert TSim.masked_topk_dims(N_ITEMS, RANK, batch, k, fp) == \
                JSim.masked_topk_dims(N_ITEMS, RANK, batch, k, fp)
    assert TALS.batch_predict_dims(mt.als, 1, 40)["k"] == 64
    s, i = TALS.users_topk_serve(mt.als, [1, 2, 3], 5)
    assert s.shape == i.shape == (3, 16)
