"""Port parity: the event store and the recommendation template's
store-backed reads (L0 storage, L2 event store, L3 data source,
preparator and query filters) vs the JAX reference.

Both packages read the same `PIO_STORAGE_*` environment (the `tmp_env`
SQLite/localfs fixture), so a store written by one is read back through
the other. Tolerances: column arrays, property maps, vocabularies, COO
and filter masks are held exactly (NaN where a property is missing
compares equal). Predictions of a model carried across by
`from_jax_model` hold ids exactly and scores within 1e-5 absolute
(SCORE_TOL): both sides score the same f32 tables, summed in another
order. The reference's batched path is held in exact mode
(`PIO_SERVE_PACK=exact`), so its f16 score packing does not enter.
"""

import datetime as dt
import os

import numpy as np
import pytest

from predictionio_tpu.core import params as JP
from predictionio_tpu.data import aggregator as JAgg
from predictionio_tpu.data import columnar as JCol
from predictionio_tpu.data import datamap as JDM
from predictionio_tpu.data import event as JE
from predictionio_tpu.data.storage import base as JB
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu.ops import similarity as JSim
from predictionio_tpu_torch.core import params as TP
from predictionio_tpu_torch.data import aggregator as TAgg
from predictionio_tpu_torch.data import columnar as TCol
from predictionio_tpu_torch.data import datamap as TDM
from predictionio_tpu_torch.data import event as TE
from predictionio_tpu_torch.data.storage import base as TB
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.store import event_store as TES
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.ops import similarity as TSim
from predictionio_tpu_torch.weights import from_jax_model

SCORE_TOL = 1e-5
N_USERS, N_ITEMS, N_RATE, N_BUY = 40, 30, 600, 60
APP = "storeapp"

PKGS = {
    "jax": dict(reg=JReg, base=JB, col=JCol, event=JE, dm=JDM),
    "port": dict(reg=TReg, base=TB, col=TCol, event=TE, dm=TDM),
}


@pytest.fixture()
def stores(tmp_env):
    """One SQLite/localfs store that both packages' registries read."""
    TReg.clear_cache()
    yield tmp_env
    TReg.clear_cache()


def time_str(ms: int) -> str:
    sec, ms = divmod(ms, 1000)
    return "1970-01-01T00:%02d:%02d.%03dZ" % (sec // 60, sec % 60, ms)


def item_props(k: int, cats) -> dict:
    props = {"categories": list(cats[k]), "title": f"Item {k}"}
    if k % 4:
        props["creationYear"] = 1990 + k % 9   # every 4th item undated
    return props


def write_store(pkg: str, channel: bool = False) -> tuple:
    """Seeded events through `pkg`'s storage: rate events (with repeated
    (user, item) pairs, several at one event time), buy events (no
    rating), other event names, and the items' $set/$unset/$delete
    history. Returns (app_id, channel_id)."""
    m = PKGS[pkg]
    S = m["reg"].Storage
    app_id = S.get_meta_data_apps().insert(m["base"].App(0, APP))
    channel_id = None
    if channel:
        channel_id = S.get_meta_data_channels().insert(
            m["base"].Channel(0, "ch1", app_id))
    ev = S.get_events()
    rng = np.random.default_rng(7)
    u = rng.integers(0, N_USERS, N_RATE)
    i = rng.integers(0, N_ITEMS, N_RATE)
    r = rng.integers(1, 6, N_RATE)
    # three rows share each millisecond: equal-time duplicates of a pair
    # keep insertion order, which the "latest" dedup reads
    u[1::3], i[1::3] = u[::3][:len(u[1::3])], i[::3][:len(i[1::3])]
    ev.insert_columnar(m["col"].ColumnarBatch(
        N_RATE, "rate", "user", [f"u{x}" for x in u], "item",
        [f"i{x}" for x in i], [{"rating": float(x)} for x in r],
        [time_str(j // 3) for j in range(N_RATE)]), app_id, channel_id)
    bu = rng.integers(0, N_USERS, N_BUY)
    bi = rng.integers(0, N_ITEMS, N_BUY)
    ev.insert_columnar(m["col"].ColumnarBatch(
        N_BUY, ["buy", "view"] * (N_BUY // 2), "user",
        [f"u{x}" for x in bu], "item", [f"i{x}" for x in bi], None,
        [time_str(100 + j) for j in range(N_BUY)]), app_id, channel_id)
    cats = synthetic_item_categories(N_ITEMS, n_categories=5, seed=2)
    E, DM = m["event"].Event, m["dm"].DataMap
    t0 = dt.datetime(1970, 1, 1, 0, 5, tzinfo=dt.timezone.utc)
    events = [E(event="$set", entity_type="item", entity_id=f"i{k}",
                properties=DM(item_props(k, cats)),
                event_time=t0 + dt.timedelta(milliseconds=k))
              for k in range(N_ITEMS)]
    events += [
        E(event="$unset", entity_type="item", entity_id="i3",
          properties=DM({"title": None}),
          event_time=t0 + dt.timedelta(seconds=1)),
        E(event="$delete", entity_type="item", entity_id="i5",
          event_time=t0 + dt.timedelta(seconds=1)),
        E(event="$set", entity_type="user", entity_id="u1",
          properties=DM({"age": 30}), event_time=t0)]
    ev.insert_batch(events, app_id, channel_id)
    return app_id, channel_id


def assert_columns_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype.kind == want[k].dtype.kind, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def assert_property_maps_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].fields == want[k].fields
        assert got[k].first_updated == want[k].first_updated
        assert got[k].last_updated == want[k].last_updated


@pytest.mark.parametrize("channel", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_reads_back_through_the_other_package(stores, writer,
                                                    channel):
    app_id, channel_id = write_store(writer, channel)
    reads = {}
    for pkg in ("jax", "port"):
        ev = PKGS[pkg]["reg"].Storage.get_events()
        reads[pkg] = (
            ev.find_columnar(app_id, channel_id=channel_id,
                             property_field="rating", entity_type="user",
                             target_entity_type="item",
                             event_names=["rate", "buy"]),
            ev.find_columnar(app_id, channel_id=channel_id),
            ev.aggregate_properties(app_id, channel_id=channel_id,
                                    entity_type="item"),
            ev.aggregate_properties(app_id, channel_id=channel_id,
                                    entity_type="item",
                                    required=["creationYear"]))
    for got, want in zip(reads["port"][:2], reads["jax"][:2]):
        assert_columns_equal(got, want)
    for got, want in zip(reads["port"][2:], reads["jax"][2:]):
        assert_property_maps_equal(got, want)
    cols, items = reads["port"][0], reads["port"][2]
    assert len(cols["t"]) == N_RATE + N_BUY // 2
    assert "i5" not in items and "title" not in items["i3"]
    assert np.isnan(cols["prop"][cols["event"] == "buy"]).all()


def test_equal_time_rows_come_back_in_insertion_order(stores):
    write_store("port")
    app_id = TReg.Storage.get_meta_data_apps().get_by_name(APP).id
    cols = TReg.Storage.get_events().find_columnar(
        app_id, property_field="rating", event_names=["rate"])
    ev = JReg.Storage.get_events()
    rows = list(ev.find(app_id, event_names=["rate"]))
    assert [e.entity_id for e in rows] == list(cols["entity_id"])
    # the fixture's rows three to a millisecond, in the written order
    assert (np.diff(cols["t"]) >= 0).all()
    assert (np.bincount(cols["t"]) == 3).all()


def test_point_reads_and_deletes_match(stores):
    app_id, _ = write_store("jax")
    tev, jev = TReg.Storage.get_events(), JReg.Storage.get_events()
    jrows = list(jev.find(app_id, entity_type="item", limit=5,
                          reversed_order=True))
    trows = list(tev.find(app_id, entity_type="item", limit=5,
                          reversed_order=True))
    assert [e.event_id for e in trows] == [e.event_id for e in jrows]
    got = tev.get(jrows[0].event_id, app_id)
    assert got.properties.fields == jrows[0].properties.fields
    assert got.event_time == jrows[0].event_time
    assert tev.delete(jrows[0].event_id, app_id)
    assert jev.get(jrows[0].event_id, app_id) is None
    eid = tev.insert(TE.Event(event="rate", entity_type="user",
                              entity_id="new", target_entity_type="item",
                              target_entity_id="i1",
                              properties=TDM.DataMap({"rating": 2.5})),
                     app_id)
    assert jev.get(eid, app_id).properties.get("rating", float) == 2.5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_metadata_reads_back_through_the_other_package(stores, writer):
    app_id, channel_id = write_store(writer, channel=True)
    reader = "port" if writer == "jax" else "jax"
    S = PKGS[reader]["reg"].Storage
    assert S.get_meta_data_apps().get_by_name(APP).id == app_id
    assert [c.id for c in S.get_meta_data_channels().get_by_app_id(
        app_id)] == [channel_id]


def test_unported_backend_types_raise(stores, monkeypatch):
    monkeypatch.setenv("PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE", "PG")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_PG_TYPE", "pgsql")
    monkeypatch.setenv("PIO_STORAGE_SOURCES_PG_URL", "localhost:1")
    TReg.clear_cache()
    with pytest.raises(TReg.StorageError, match="not ported"):
        TReg.Storage.get_events()


def test_registry_defaults_match_the_reference(monkeypatch, tmp_path):
    for k in list(os.environ):
        if k.startswith("PIO_STORAGE_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    for repo in TReg.REPOSITORIES:
        t, j = TReg.repository_config(repo), JReg.repository_config(repo)
        assert (t.name, t.type, t.properties) == (j.name, j.type,
                                                  j.properties)
        assert TReg.repository_namespace(repo) == \
            JReg.repository_namespace(repo)


# -- the pure-Python copies --------------------------------------------------

def test_aggregator_matches_the_reference():
    t0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
    spec = [("$set", "a", {"x": 1, "y": 2}, 0), ("$set", "a", {"x": 3}, 5),
            ("$unset", "a", {"y": None}, 4), ("$set", "b", {"z": 1}, 1),
            ("$delete", "b", {}, 2), ("$set", "c", {"p": 1, "q": 2}, 1),
            ("$delete", "c", {}, 1), ("$set", "c", {"q": 7}, 3),
            ("rate", "d", {"rating": 4}, 0), ("$unset", "e", {"k": 0}, 0)]
    got = {}
    for pkg, E, DM, agg in (("jax", JE.Event, JDM.DataMap, JAgg),
                            ("port", TE.Event, TDM.DataMap, TAgg)):
        got[pkg] = agg.aggregate_properties(
            [E(event=n, entity_type="item", entity_id=e,
               properties=DM(p), event_time=t0 + dt.timedelta(seconds=s))
             for n, e, p, s in spec])
    assert_property_maps_equal(got["port"], got["jax"])
    assert got["port"]["a"].fields == {"x": 3}
    assert sorted(got["port"]) == ["a", "c"]


def test_match_event_and_validation_match_the_reference():
    t0 = dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)

    def events(E, DM):
        return [E("rate", "user", "u1", "item", "i1", DM({"rating": 1}),
                  t0),
                E("$set", "item", "i1", properties=DM({"a": 1}),
                  event_time=t0 + dt.timedelta(seconds=3)),
                E("$set", "item", "i1", "item", "i2"),
                E("$bad", "user", "u1"), E("x", "pio_user", "u"),
                E("$unset", "item", "i1"), E("y", "user", "u", "item"),
                E("z", "user", "u", properties=DM({"pio_p": 1}))]
    filters = [dict(), dict(start_time=t0 + dt.timedelta(seconds=1)),
               dict(until_time=t0 + dt.timedelta(seconds=1)),
               dict(entity_type="item"), dict(entity_id="u1"),
               dict(event_names=["rate"]),
               dict(target_entity_type=TB.ABSENT),
               dict(target_entity_id="i1")]
    for je, te in zip(events(JE.Event, JDM.DataMap),
                      events(TE.Event, TDM.DataMap)):
        for f in filters:
            jf = {k: (JB.ABSENT if v is TB.ABSENT else v)
                  for k, v in f.items()}
            assert TB.match_event(te, **f) == JB.match_event(je, **jf)
        outcome = []
        for V, e in ((JE.EventValidation, je), (TE.EventValidation, te)):
            try:
                V.validate(e)
                outcome.append(None)
            except ValueError as err:
                outcome.append(str(err))
        assert outcome[0] == outcome[1]


@pytest.mark.parametrize("raw", [
    {"rank": 4, "num_iterations": 2, "lam": 0.1},
    {"rank": 4.0, "return_properties": ["creationYear"]},
    {"rank": "4"}, {"rank": 4.5}, {"lam": True}, {"seed": None},
    {"return_properties": "creationYear"}, {"no_such": 1},
    {"compute_dtype": 16}])
def test_params_from_dict_matches_the_reference(raw):
    def build(P, cls):
        try:
            return P.params_from_dict(cls, raw)
        except (TypeError, ValueError) as e:
            return type(e).__name__
    j = build(JP, JR.ALSAlgorithmParams)
    t = build(TP, TR.ALSAlgorithmParams)
    if isinstance(j, str):
        assert t == j
    else:
        for k in raw:
            assert getattr(t, k) == getattr(j, k)


def test_params_to_dict_names_a_field_with_no_json_form():
    p = TR.DataSourceParams(ratings=TR.RatingsData(["u"], ["i"], [1.0]))
    with pytest.raises(ValueError, match="DataSourceParams.ratings"):
        TP.params_to_dict(p)
    assert TP.params_to_dict(TR.DataSourceParams(app_name="a")) == {
        "app_name": "a", "channel_name": None,
        "event_names": ("rate", "buy"), "buy_rating": 4.0,
        "read_items": False, "eval_k": None, "eval_query_num": 10,
        "ratings": None}


# -- the data source and preparator -----------------------------------------

def read_both(**kw):
    td_j = JR.RecommendationDataSource(
        JR.DataSourceParams(app_name=APP, **kw)).read_training()
    td_t = TR.RecommendationDataSource(
        TR.DataSourceParams(app_name=APP, **kw)).read_training()
    return td_j, td_t


@pytest.mark.parametrize("kw", [
    dict(), dict(read_items=True), dict(buy_rating=2.5),
    dict(event_names=("rate",)), dict(channel_name="ch1", read_items=True)])
def test_data_source_matches_the_reference(stores, kw):
    write_store("jax", channel="channel_name" in kw)
    td_j, td_t = read_both(**kw)
    for name in ("users", "items", "vals", "ts"):
        a, b = getattr(td_t.ratings, name), getattr(td_j.ratings, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert td_t.items == td_j.items
    assert (td_t.items is None) == (not kw.get("read_items"))
    names = list(kw.get("event_names", ("rate", "buy")))
    app_id, channel_id = TES.PEventStore.resolve(APP, kw.get("channel_name"))
    cols = TReg.Storage.get_events().find_columnar(
        app_id, channel_id=channel_id, event_names=names,
        entity_type="user", target_entity_type="item")
    is_buy = cols["event"] == "buy"
    assert is_buy.any() == ("buy" in names)
    np.testing.assert_array_equal(td_t.ratings.vals[is_buy],
                                  kw.get("buy_rating", 4.0))


def test_rate_without_rating_raises_in_both(stores):
    app_id, _ = write_store("port")
    TReg.Storage.get_events().insert(TE.Event(
        event="rate", entity_type="user", entity_id="u0",
        target_entity_type="item", target_entity_id="i0"), app_id)
    with pytest.raises(ValueError, match="lack the required 'rating'"):
        JR.RecommendationDataSource(
            JR.DataSourceParams(app_name=APP)).read_training()
    with pytest.raises(ValueError, match="lack the required 'rating'"):
        TR.RecommendationDataSource(
            TR.DataSourceParams(app_name=APP)).read_training()


def test_unknown_app_and_channel_raise(stores):
    write_store("port")
    for kw in (dict(app_name="nope"),
               dict(app_name=APP, channel_name="nope")):
        with pytest.raises(ValueError, match="Invalid"):
            TR.RecommendationDataSource(
                TR.DataSourceParams(**kw)).read_training()


@pytest.mark.parametrize("exclude", [None, ["i1", "i7", "i29", "zz"]])
def test_preparator_matches_the_reference(stores, tmp_path, exclude):
    write_store("port")
    td_j, td_t = read_both(read_items=True)
    path = None
    if exclude is not None:
        path = tmp_path / "exclude.txt"
        path.write_text("\n".join(exclude) + "\n\n")
    pd_j = JR.RecommendationPreparator(JR.PreparatorParams(
        exclude_items_file=path and str(path))).prepare(td_j)
    pd_t = TR.RecommendationPreparator(TR.PreparatorParams(
        exclude_items_file=path and str(path))).prepare(td_t)
    for name in ("user_idx", "item_idx", "rating"):
        np.testing.assert_array_equal(getattr(pd_t.ratings_coo, name),
                                      getattr(pd_j.ratings_coo, name))
    assert (pd_t.ratings_coo.n_users, pd_t.ratings_coo.n_items) == \
        (pd_j.ratings_coo.n_users, pd_j.ratings_coo.n_items)
    assert list(pd_t.user_ix.ids) == list(pd_j.user_ix._ids)
    assert list(pd_t.item_ix.ids) == list(pd_j.item_ix._ids)
    assert pd_t.items == pd_j.items
    if exclude is not None:
        assert not set(exclude) & set(pd_t.item_ix.ids)


# -- the query filters and predict ------------------------------------------

@pytest.fixture()
def trained_jax(stores, monkeypatch):
    """A JAX model trained from the store with item properties, and the
    port's model carrying its tables and properties (on the CPU)."""
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    write_store("jax")
    td_j, _ = read_both(read_items=True)
    pd_j = JR.RecommendationPreparator().prepare(td_j)
    params = dict(rank=8, num_iterations=3, lam=0.1, seed=1,
                  return_properties=("creationYear", "title"))
    algo_j = JR.ALSAlgorithm(JR.ALSAlgorithmParams(**params))
    mj = algo_j.train(pd_j)
    mt = from_jax_model(mj.als.user_factors, mj.als.item_factors,
                        list(mj.user_ix._ids), list(mj.item_ix._ids),
                        mj.als.rank, device="cpu",
                        item_properties=mj.item_properties)
    algo_t = TR.ALSAlgorithm(TR.ALSAlgorithmParams(device="cpu", **params))
    return algo_j, mj, algo_t, mt


QUERIES = [dict(), dict(categories=("c1",)), dict(categories=("c0", "c4")),
           dict(creation_year=1995), dict(creation_year=2100),
           dict(categories=("c2",), creation_year=1993),
           dict(categories=()), dict(categories=("nope",))]


@pytest.mark.parametrize("q", QUERIES)
def test_allowed_mask_matches_the_reference(trained_jax, q):
    _, mj, _, mt = trained_jax
    mask_j = mj.allowed_mask(JR.Query("u1", 5, **q))
    mask_t = mt.allowed_mask(TR.Query("u1", 5, **q))
    if mask_j is None:
        assert mask_t is None
        return
    np.testing.assert_array_equal(mask_t, mask_j)
    if q.get("creation_year") == 2100:
        # only the undated items pass a year no item reaches
        np.testing.assert_array_equal(mask_t, np.isnan(mt.item_years))
        assert mask_t.any()


def test_derived_filters_match_the_reference(trained_jax):
    _, mj, _, mt = trained_jax
    assert mt.item_categories == mj.item_categories
    np.testing.assert_array_equal(mt.item_years, mj.item_years)
    assert mt.item_properties == mj.item_properties


@pytest.mark.parametrize("q", QUERIES)
def test_predict_matches_the_reference(trained_jax, q):
    algo_j, mj, algo_t, mt = trained_jax
    for user in ("u0", "u3", "u17", "nobody"):
        got = algo_t.predict(mt, TR.Query(user, 7, **q)).to_dict()
        want = algo_j.predict(mj, JR.Query(user, 7, **q)).to_dict()
        assert [s["item"] for s in got["itemScores"]] == \
            [s["item"] for s in want["itemScores"]]
        np.testing.assert_allclose(
            [s["score"] for s in got["itemScores"]],
            [s["score"] for s in want["itemScores"]], rtol=0,
            atol=SCORE_TOL)
        for a, b in zip(got["itemScores"], want["itemScores"]):
            assert (a.get("creationYear"), a.get("title")) == \
                (b.get("creationYear"), b.get("title"))
            assert set(a) == set(b) == {"item", "score", "creationYear",
                                        "title"}


def test_batch_predict_matches_the_reference(trained_jax):
    algo_j, mj, algo_t, mt = trained_jax
    picks = [("u0", 5, {}), ("u2", 3, dict(categories=("c1",))),
             ("nobody", 4, {}), ("u5", 9, dict(creation_year=1994)),
             ("u9", 6, dict(categories=("nope",))), ("u11", 2, {})]
    got = dict(algo_t.batch_predict(mt, [(k, TR.Query(u, n, **q)) for k, (
        u, n, q) in enumerate(picks)]))
    want = dict(algo_j.batch_predict(mj, [(k, JR.Query(u, n, **q)) for k, (
        u, n, q) in enumerate(picks)]))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].to_dict(), want[k].to_dict()
        assert [s["item"] for s in g["itemScores"]] == \
            [s["item"] for s in w["itemScores"]]
        np.testing.assert_allclose(
            [s["score"] for s in g["itemScores"]],
            [s["score"] for s in w["itemScores"]], rtol=0, atol=SCORE_TOL)
        single = algo_t.predict(mt, TR.Query(
            picks[k][0], picks[k][1], **picks[k][2])).to_dict()
        assert [s["item"] for s in g["itemScores"]] == \
            [s["item"] for s in single["itemScores"]]


def test_masked_top_k_keeps_negative_scores_when_asked(monkeypatch):
    import torch
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    rng = np.random.default_rng(4)
    table = rng.standard_normal((25, 6)).astype(np.float32)
    q = rng.standard_normal((3, 6)).astype(np.float32)
    masks = rng.random((3, 25)) < 0.7
    for fp in (False, True):
        s_t, i_t = TSim.masked_top_k_batch(torch.tensor(table), q, masks,
                                           25, filter_positive=fp)
        s_j, i_j = JSim.masked_top_k_batch(table, q, masks, 25,
                                           filter_positive=fp)
        for row in range(3):
            a = TSim.unpack_top_k_rows(s_t[row], i_t[row], 25)
            b = JSim.unpack_top_k_rows(s_j[row], i_j[row], 25)
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_allclose(a[0], b[0], rtol=0, atol=SCORE_TOL)
            assert len(a[1]) == (masks[row].sum() if not fp else
                                 (masks[row] & (table @ q[row] > 0)).sum())
            if not fp:
                assert (a[0] < 0).any()
