"""Port parity: the e-commerce recommendation template and the event
store's deadline-guarded point read vs the JAX reference, on the CPU.

Both packages read one seeded SQLite store (the `tmp_env` fixture's
`PIO_STORAGE_*`): items' `$set` categories, `rate` (re-rated pairs
included) and `buy` events, `view` events, and two
`constraint/unavailableItems` `$set`s (the later one wins).

- The training data is held array for array; a `rate` without a rating
  is refused with the reference's message.
- Train (rank 4, 10 iterations, alpha 5, the solver at 'auto', which is
  Cholesky on the CPU in both packages): the factor tables within 1e-4 of
  the largest factor at lam 0.1 and 4e-4 at lam 0.01 (the bounds of
  tests/test_torch_als.py), the id maps and category sets equal.
- Served answers: the JAX model carried over (`weights.
  from_jax_ecommerce_model`) answers every query kind (seen items,
  unavailable items, categories, white and black lists, the new-user
  fallback, the unknown user) with the JAX answer's ids, scores within
  1e-5 relative; the port's `batch_predict` equals its own `predict`
  under `PIO_SERVE_PACK=exact` (ids, scores 1e-5 relative) and under the
  default f16 readback (ids, scores within f16 rounding).
- The business rules: seen items, the latest `unavailableItems` list,
  the fallback's 10 most recent views, a wedged store answering nothing
  excluded and counting a timeout; the serialization round trip; the
  engine through `create_workflow_main` and a loaded server.
- `find_by_entity` mirrors tests/test_entity_filtered_fold.py
  ::TestPointReadDeadline: a wedged backend times out and is counted,
  permits are bounded, a healthy burst past them answers, a late result
  is dropped and its permit returns; its rows equal the reference's.
- The result cache over live reads, a fault shared with the reference:
  after a known user's answer is cached, a `buy` of one of its items
  leaves both servers answering the stale bytes; with
  `PIO_SERVE_CACHE=off` both exclude the item.
"""

import dataclasses
import datetime as dt
import json
import threading

import numpy as np
import pytest

from predictionio_tpu.core import EngineParams as JEngineParams
from predictionio_tpu.core import FirstServing as JFirstServing
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.data.store.event_store import EventStore as JStore
from predictionio_tpu.models import ecommerce as JE
from predictionio_tpu.serving import server as JSrv
from predictionio_tpu.utils.http import Headers, Request
from predictionio_tpu_torch.core import EngineParams
from predictionio_tpu_torch.core.params import params_from_dict
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.store import event_store as TES
from predictionio_tpu_torch.models import ecommerce as TE
from predictionio_tpu_torch.models.similarproduct import Item
from predictionio_tpu_torch.serving import server as TSrv
from predictionio_tpu_torch.weights import from_jax_ecommerce_model

APP = "ecomapp"
RANK = 4
FACTOR_TOL = {0.1: 1e-4, 0.01: 4e-4}
SCORE_RTOL = 1e-5
F16_REL = 2.0 ** -11


def time_str(ms: int) -> str:
    sec, ms = divmod(ms, 1000)
    return "1970-01-01T00:%02d:%02d.%03dZ" % (sec // 60, sec % 60, ms)


@pytest.fixture()
def store(tmp_env):
    """Two item groups (catA, catB; one item without categories); users
    u0-u11 rate their group's items (some re-rated later), some buys;
    views; two unavailableItems lists."""
    TReg.clear_cache()
    JReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    ev = TReg.Storage.get_events()
    rng = np.random.default_rng(3)
    t = iter(range(10, 10 ** 6, 7))
    items = [f"i{g}{k}" for g in range(2) for k in range(6)]
    ev.insert_columnar(ColumnarBatch(
        len(items), "$set", "item", items,
        properties=[{} if i == "i05" else
                    {"categories": ["catA" if i[1] == "0" else "catB"]}
                    for i in items], event_time=time_str(next(t))), app_id)
    ev.insert_columnar(ColumnarBatch(
        2, "$set", "user", ["u0", "u1"], properties=[{"age": 30}, {}],
        event_time=time_str(next(t))), app_id)
    rows = []
    for u in range(12):
        g = u % 2
        for k in range(6):
            if rng.random() < 0.85:
                rows.append((f"u{u}", f"i{g}{k}",
                             float(rng.integers(1, 6))))
    rows += [("u3", "i00", 5.0), ("u0", "i01", 1.0), ("u1", "i10", 2.0)]
    ev.insert_columnar(ColumnarBatch(
        len(rows), "rate", "user", [r[0] for r in rows], "item",
        [r[1] for r in rows], [{"rating": r[2]} for r in rows],
        [time_str(next(t)) for _ in rows]), app_id)
    buys = [("u4", "i02"), ("u5", "i13"), ("u6", "i11"), ("u2", "i14")]
    ev.insert_columnar(ColumnarBatch(
        len(buys), "buy", "user", [b[0] for b in buys], "item",
        [b[1] for b in buys], None,
        [time_str(next(t)) for _ in buys]), app_id)
    views = ([("u0", "i02"), ("u0", "i03"), ("u1", "i12")]
             + [("fresh", f"i1{k}") for k in (0, 2, 3)]
             + [("many", f"i{g}{k}") for g in range(2) for k in range(6)])
    ev.insert_columnar(ColumnarBatch(
        len(views), "view", "user", [v[0] for v in views], "item",
        [v[1] for v in views], None,
        [time_str(next(t)) for _ in views]), app_id)
    for lst in (["i04", "i15"], ["i01", "i11"]):
        ev.insert_columnar(ColumnarBatch(
            1, "$set", "constraint", ["unavailableItems"],
            properties=[{"items": lst}], event_time=time_str(next(t))),
            app_id)
    yield app_id
    TReg.clear_cache()
    JReg.clear_cache()


def algo_kw(**kw):
    return dict(dict(app_name=APP, rank=RANK, num_iterations=10, lam=0.01,
                     alpha=5.0, seed=2), **kw)


def j_params(**kw):
    return JEngineParams(
        data_source_params=("", JE.DataSourceParams(app_name=APP)),
        preparator_params=("", None),
        algorithm_params_list=[("ecomm", JE.ECommAlgorithmParams(
            **algo_kw(**kw)))],
        serving_params=("", None))


def t_params(**kw):
    return EngineParams(
        data_source_params=("", TE.DataSourceParams(app_name=APP)),
        preparator_params=("", None),
        algorithm_params_list=[("ecomm", TE.ECommAlgorithmParams(
            **algo_kw(device="cpu", **kw)))],
        serving_params=("", None))


def train_both(**kw):
    jr = JE.ECommerceEngineFactory.apply().train(j_params(**kw))
    tr = TE.ECommerceEngineFactory.apply().train(t_params(**kw))
    return jr, tr


def carried(jm) -> TE.ECommerceModel:
    """The JAX model through the converter, on the CPU."""
    return from_jax_ecommerce_model(
        jm.user_factors, jm.item_factors, jm.item_factors_normalized,
        list(jm.user_ix._ids), list(jm.item_ix._ids),
        {k: Item(v.categories) for k, v in jm.items.items()}, jm.rank,
        device="cpu")


QUERIES = [
    dict(user="u0", num=8),                           # seen views, buys
    dict(user="u1", num=8, categories=["catB"]),
    dict(user="u2", num=8, blackList=["i02", "i04"]),
    dict(user="u3", num=3, whiteList=["i00", "i02", "i13", "i01"]),
    dict(user="u5", num=20),                          # more than items
    dict(user="fresh", num=4),                        # cosine fallback
    dict(user="fresh", num=6, categories=["catA"]),
    dict(user="many", num=5),                         # 10 latest of 12
    dict(user="ghost", num=4),                        # empty
]


def pairs(res):
    return [(s.item, s.score) for s in res.item_scores]


def assert_same_answer(got, want, what, rtol=SCORE_RTOL):
    g, w = pairs(got), pairs(want)
    assert [x[0] for x in g] == [x[0] for x in w], what
    np.testing.assert_allclose([x[1] for x in g], [x[1] for x in w],
                               rtol=rtol, err_msg=str(what))


# ---------------------------------------------------------------------------
# the data source
# ---------------------------------------------------------------------------

def test_read_training_matches_the_reference(store):
    td_j = JE.ECommerceDataSource(
        JE.DataSourceParams(app_name=APP)).read_training()
    td_t = TE.ECommerceDataSource(
        TE.DataSourceParams(app_name=APP)).read_training()
    assert td_t.users == td_j.users and td_t.users["u0"] == {"age": 30}
    assert list(td_t.items) == list(td_j.items)
    for k, v in td_j.items.items():
        assert td_t.items[k].categories == v.categories
    assert td_t.items["i05"].categories is None
    for name in ("users", "items", "vals", "ts"):
        a = getattr(td_t.rate_events, name)
        b = getattr(td_j.rate_events, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # buys count as buy_rating
    assert (td_t.rate_events.vals[-4:] == 4.0).all()


def test_a_rate_without_rating_is_refused_alike(store):
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        2, "rate", "user", ["u9", "u9"], "item", ["i00", "i01"],
        [{}, {"stars": 3}], time_str(999_000)), store)
    msgs = []
    for mod in (JE, TE):
        with pytest.raises(ValueError) as e:
            mod.ECommerceDataSource(
                mod.DataSourceParams(app_name=APP)).read_training()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("2 'rate' event(s) lack the required "
                                  "'rating' property")


# ---------------------------------------------------------------------------
# train and serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.1, 0.01])
def test_train_matches_the_reference(store, lam):
    jr, tr = train_both(lam=lam)
    jm, tm = jr.models[0], tr.models[0]
    assert list(tm.user_ix._ids) == list(jm.user_ix._ids)
    assert list(tm.item_ix._ids) == list(jm.item_ix._ids)
    assert tm.item_categories == jm.item_categories
    assert tm.rank == jm.rank == RANK
    for a, b in ((jm.user_factors, tm.user_factors),
                 (jm.item_factors, tm.item_factors),
                 (jm.item_factors_normalized, tm.item_factors_normalized)):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.abs(a - b).max() <= FACTOR_TOL[lam] * np.abs(a).max()
    assert tr.algorithms[0].last_train_telemetry["solver_calls"] > 0


@pytest.mark.parametrize("unseen_only, seen_events", [
    (True, ("buy", "view")), (True, ("view",)), (False, ("buy", "view"))])
def test_the_carried_model_answers_as_the_reference(store, unseen_only,
                                                    seen_events):
    jr = JE.ECommerceEngineFactory.apply().train(j_params(
        unseen_only=unseen_only, seen_events=seen_events))
    ja, jm = jr.algorithms[0], jr.models[0]
    ta = TE.ECommAlgorithm(TE.ECommAlgorithmParams(**algo_kw(
        unseen_only=unseen_only, seen_events=seen_events, device="cpu")))
    tm = carried(jm)
    for q in QUERIES:
        assert_same_answer(ta.predict(tm, TE.Query.from_dict(q)),
                           ja.predict(jm, JE.Query.from_dict(q)), q)


@pytest.mark.parametrize("pack", ["exact", "f16"])
def test_batch_predict_matches_predict(store, pack, monkeypatch):
    if pack == "exact":
        monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    else:
        monkeypatch.delenv("PIO_SERVE_PACK", raising=False)
    tr = TE.ECommerceEngineFactory.apply().train(t_params())
    algo, model = tr.algorithms[0], tr.models[0]
    queries = [TE.Query.from_dict(q) for q in QUERIES]
    batched = dict(algo.batch_predict(model, list(enumerate(queries))))
    for ix, q in enumerate(queries):
        single = algo.predict(model, q)
        if pack == "exact":
            assert_same_answer(batched[ix], single, q)
            continue
        b, s = pairs(batched[ix]), pairs(single)
        assert [x[0] for x in b] == [x[0] for x in s], q
        sb, ss = (np.array([x[1] for x in b]), np.array([x[1] for x in s]))
        assert (np.abs(sb - ss) <= F16_REL * np.abs(ss)).all(), q


def test_the_business_rules(store):
    tr = TE.ECommerceEngineFactory.apply().train(t_params())
    algo, model = tr.algorithms[0], tr.models[0]

    def items(**q):
        return [s.item for s in algo.predict(
            model, TE.Query.from_dict(dict(num=20, **q))).item_scores]
    # the latest unavailableItems list wins; the earlier one is served
    for user in ("u0", "u1", "u2", "fresh"):
        got = items(user=user)
        assert not {"i01", "i11"} & set(got), (user, got)
    assert algo._unavailable_items() == ["i01", "i11"]
    # u0's seen items (viewed i02, i03; rated items are not seen events)
    assert sorted(algo._seen_items("u0")) == ["i02", "i03"]
    assert not {"i02", "i03"} & set(items(user="u0"))
    assert set(algo._seen_items("u4")) == {"i02"}
    # the fallback's input: at most the 10 latest views
    r_ix = algo._recent_view_indices(model, "many")
    assert len(r_ix) == 10
    assert set(model.item_ix.ids_of(r_ix)) == {
        f"i{g}{k}" for g in range(2) for k in range(6)} - {"i00", "i01"}
    assert items(user="fresh") and items(user="ghost") == []
    # every known-user score is positive (the reference keeps score > 0)
    res = algo.predict(model, TE.Query("u5", 20))
    assert all(s.score > 0 for s in res.item_scores)


class _Wedged:
    """An events backend whose reads block until released."""

    def __init__(self):
        self.release = threading.Event()

    def find(self, *a, **kw):
        self.release.wait(10)
        return iter(())


class _OneApp:
    def get_by_name(self, name):
        from predictionio_tpu_torch.data.storage.base import App
        return App(1, name)


def test_a_wedged_store_excludes_nothing_and_counts(store, monkeypatch):
    tr = TE.ECommerceEngineFactory.apply().train(t_params())
    algo, model = tr.algorithms[0], tr.models[0]
    ok = pairs(algo.predict(model, TE.Query("u0", 20)))
    wedged = _Wedged()
    monkeypatch.setattr(TE.LEventStore, "_events", wedged)
    monkeypatch.setattr(TES.EventStore, "_point_read_sem",
                        threading.BoundedSemaphore(8))
    before = TES.EventStore.point_read_stats()[
        "pio_event_point_read_timeout_total"]
    try:
        got = pairs(algo.predict(model, TE.Query("u0", 20)))
        # u0's seen i02, i03 and its group's unavailable i01 are served
        # again
        assert {"i02", "i03", "i01"} <= {x[0] for x in got}
        assert {x[0] for x in ok} < {x[0] for x in got}
        after = TES.EventStore.point_read_stats()[
            "pio_event_point_read_timeout_total"]
        assert after == before + 2
    finally:
        wedged.release.set()


def test_the_model_survives_serialization(store):
    engine = TE.ECommerceEngineFactory.apply()
    ep = t_params()
    tr = engine.train(ep)
    blob = engine.serialize_models(
        engine.make_serializable_models(tr, "inst", ep))
    (host,) = engine.deserialize_models(blob, "inst")
    assert host.device is None and host._als is None
    deployed = engine.prepare_deploy(ep, [host], "inst")
    m = deployed.models[0]
    assert m.device.type == "cpu"
    np.testing.assert_array_equal(m.user_factors, tr.models[0].user_factors)
    for q in QUERIES:
        q = TE.Query.from_dict(q)
        assert pairs(deployed.algorithms[0].predict(m, q)) == pairs(
            tr.algorithms[0].predict(tr.models[0], q))


def test_engine_json_trains_and_deploys(store, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_AOT_WARM", "on")
    from predictionio_tpu_torch.serving.server import (EngineServer,
                                                       ServerConfig)
    from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                                 create_workflow_main)
    path = tmp_path / "engine.json"
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "ecommercerecommendation",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [{"name": "ecomm", "params": algo_kw(
            device="cpu")}]}))
    iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)))
    server = EngineServer(ServerConfig(port=0, engine_variant=str(path),
                                       result_cache=False)).load()
    try:
        assert server.engine_instance.id == iid
        body, _ = server.queries(b'{"user": "u0", "num": 4}')
        got = json.loads(body)["itemScores"]
        assert got and not {"i01", "i02", "i03", "i11"} & {
            s["item"] for s in got}
        body, _ = server.queries(b'{"user": "ghost", "num": 4}')
        assert json.loads(body) == {"itemScores": []}
        stats = server.stats()
        assert stats["pio_event_point_read_timeout_total"] >= 0
        # no aot_warm_specs: unwarmed, as in the reference
        assert stats["aotWarm"]["specs"] == 0
        assert stats["aotWarm"]["compiled"] == 0
    finally:
        server.batcher.stop()


def test_params_parser_takes_fuse_iteration_and_refuses_unknown_fields():
    """The params parser once refused `fuse_iteration`; it is now a field
    of the port's params as of the reference's, and an unknown field is
    still refused."""
    p = params_from_dict(TE.ECommAlgorithmParams, {"fuse_iteration": True})
    assert p.fuse_iteration is True
    with pytest.raises(ValueError, match="no_such_field"):
        params_from_dict(TE.ECommAlgorithmParams, {"no_such_field": True})
    names = {f.name for f in dataclasses.fields(JE.ECommAlgorithmParams)}
    port = {f.name for f in dataclasses.fields(TE.ECommAlgorithmParams)}
    assert port == names | {"device"}


def test_query_wire_format_matches():
    d = {"user": "u1", "num": 3, "categories": ["a"], "whiteList": ["i1"],
         "blackList": ["i2"]}
    assert dataclasses.astuple(TE.Query.from_dict(d)) == \
        dataclasses.astuple(JE.Query.from_dict(d))
    for bad in ({"num": 3}, {"user": "u1", "num": "x"}):
        with pytest.raises((KeyError, ValueError)):
            TE.Query.from_dict(bad)


# ---------------------------------------------------------------------------
# find_by_entity: the deadline-guarded point read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(entity_type="user", entity_id="u0",
         event_names=["buy", "view"], target_entity_type="item"),
    dict(entity_type="user", entity_id="many", event_names=["view"],
         target_entity_type="item", limit=10, latest=True),
    dict(entity_type="constraint", entity_id="unavailableItems",
         event_names=["$set"], limit=1, latest=True),
    dict(entity_type="user", entity_id="u3", latest=False),
])
def test_point_read_rows_match_the_reference(store, kw):
    got = TES.PEventStore.find_by_entity(app_name=APP, timeout_ms=2000,
                                         **kw)
    want = JStore().find_by_entity(app_name=APP, timeout_ms=2000, **kw)
    assert got

    def row(e):
        return (e.event, e.entity_type, e.entity_id, e.target_entity_id,
                e.properties.fields, e.event_time)
    assert [row(e) for e in got] == [row(e) for e in want]
    # without a deadline the same rows
    assert [row(e) for e in TES.PEventStore.find_by_entity(
        app_name=APP, **kw)] == [row(e) for e in got]


class TestPointReadDeadline:
    def _store(self, events):
        return TES.EventStore(apps=_OneApp(), channels=None, events=events)

    @staticmethod
    def _workers() -> int:
        return sum(t.name == "pio-point-read" for t in threading.enumerate())

    @staticmethod
    def _timeouts():
        return TES.EventStore.point_read_stats()[
            "pio_event_point_read_timeout_total"]

    def test_timeout_raises_and_counts(self, monkeypatch):
        monkeypatch.setattr(TES.EventStore, "_point_read_sem",
                            threading.BoundedSemaphore(8))
        wedged = _Wedged()
        store = self._store(wedged)
        before = self._timeouts()
        try:
            with pytest.raises(TimeoutError,
                               match="exceeded 50 ms deadline$"):
                store.find_by_entity("app", "user", "u1", timeout_ms=50)
            assert self._timeouts() == before + 1
        finally:
            wedged.release.set()

    def test_wedged_workers_are_bounded(self, monkeypatch):
        monkeypatch.setattr(TES.EventStore, "_point_read_sem",
                            threading.BoundedSemaphore(2))
        monkeypatch.setattr(TES.EventStore, "POINT_READ_MAX_INFLIGHT", 2)
        wedged = _Wedged()
        store = self._store(wedged)
        n_before = self._workers()
        before = self._timeouts()
        try:
            for _ in range(2):
                with pytest.raises(TimeoutError, match="deadline"):
                    store.find_by_entity("app", "user", "u1",
                                         timeout_ms=30)
            t0 = dt.datetime.now()
            with pytest.raises(TimeoutError, match="all 2 deadline-read "
                               "workers are busy"):
                store.find_by_entity("app", "user", "u1", timeout_ms=300)
            waited = (dt.datetime.now() - t0).total_seconds()
            assert 0.25 <= waited < 2.0
            # no worker was started for the refused read
            assert self._workers() <= n_before + 2
            assert self._timeouts() == before + 3
        finally:
            wedged.release.set()

    def test_healthy_burst_past_permits_still_answers(self, monkeypatch):
        monkeypatch.setattr(TES.EventStore, "_point_read_sem",
                            threading.BoundedSemaphore(2))
        monkeypatch.setattr(TES.EventStore, "POINT_READ_MAX_INFLIGHT", 2)

        class _Slowish:
            def find(self, *a, **kw):
                import time as _t
                _t.sleep(0.05)
                return iter(())

        store = self._store(_Slowish())
        errors = []

        def one():
            try:
                assert store.find_by_entity("app", "user", "u1",
                                            timeout_ms=2000) == []
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors

    def test_late_result_is_discarded_and_permit_returns(self,
                                                         monkeypatch):
        monkeypatch.setattr(TES.EventStore, "_point_read_sem",
                            threading.BoundedSemaphore(1))
        monkeypatch.setattr(TES.EventStore, "POINT_READ_MAX_INFLIGHT", 1)
        wedged = _Wedged()
        store = self._store(wedged)
        with pytest.raises(TimeoutError):
            store.find_by_entity("app", "user", "u1", timeout_ms=30)
        wedged.release.set()
        deadline = dt.datetime.now() + dt.timedelta(seconds=5)
        while dt.datetime.now() < deadline:
            try:
                assert store.find_by_entity("app", "user", "u1",
                                            timeout_ms=500) == []
                break
            except TimeoutError:
                continue
        else:
            pytest.fail("permit never returned after late completion")

    def test_a_late_worker_returns_its_own_permit(self, monkeypatch):
        """A worker still wedged when the class's semaphore is replaced
        (as each test here replaces it) gives its permit back to the
        semaphore it took it from, never to the new one."""
        old = threading.BoundedSemaphore(1)
        monkeypatch.setattr(TES.EventStore, "_point_read_sem", old)
        wedged = _Wedged()
        store = self._store(wedged)
        with pytest.raises(TimeoutError):
            store.find_by_entity("app", "user", "u1", timeout_ms=30)
        new = threading.BoundedSemaphore(2)
        monkeypatch.setattr(TES.EventStore, "_point_read_sem", new)
        assert new.acquire(blocking=False)
        before = self._workers()
        wedged.release.set()
        deadline = dt.datetime.now() + dt.timedelta(seconds=5)
        while self._workers() >= before and dt.datetime.now() < deadline:
            threading.Event().wait(0.01)
        assert old.acquire(timeout=5)          # the late permit came back
        assert new.acquire(blocking=False)     # the new one has its own 2
        assert not new.acquire(blocking=False)

    def test_an_error_surfaces_and_returns_its_permit(self, monkeypatch):
        monkeypatch.setattr(TES.EventStore, "_point_read_sem",
                            threading.BoundedSemaphore(1))

        class _Broken:
            def find(self, *a, **kw):
                raise OSError("disk gone")

        store = self._store(_Broken())
        for _ in range(3):
            with pytest.raises(OSError, match="disk gone"):
                store.find_by_entity("app", "user", "u1", timeout_ms=500)


# ---------------------------------------------------------------------------
# the result cache over live reads: a fault shared with the reference
# ---------------------------------------------------------------------------

def serving(pkg, jr, tr):
    cfg = dict(micro_batch=4, micro_batch_wait_ms=1.0)
    if pkg == "jax":
        s = JSrv.EngineServer(
            JSrv.ServerConfig(ip="127.0.0.1", port=0, **cfg),
            engine=JE.ECommerceEngineFactory.apply())
        s.algorithms, s.models = jr.algorithms, jr.models
        s.serving = JFirstServing()
        return s
    return TSrv.EngineServer(TSrv.ServerConfig(port=0, **cfg),
                             TE.ECommerceEngineFactory.apply(), t_params(),
                             tr)


def ask(pkg, s, body) -> bytes:
    raw = json.dumps(body).encode()
    if pkg == "jax":
        resp = s._queries(Request("POST", "/queries.json", {}, Headers(),
                                  raw))
        assert resp.status == 200
        return resp.payload()
    out, _ = s.queries(raw)
    return out


@pytest.mark.parametrize("cache", ["on", "off"])
def test_a_cached_answer_keeps_an_item_bought_after_it(store, cache,
                                                       monkeypatch):
    monkeypatch.delenv("PIO_SERVE_CACHE", raising=False)
    if cache == "off":
        monkeypatch.setenv("PIO_SERVE_CACHE", "off")
    jr, tr = train_both()
    servers = {pkg: serving(pkg, jr, tr) for pkg in ("jax", "torch")}
    query = {"user": "u7", "num": 4}
    try:
        first = {pkg: ask(pkg, s, query) for pkg, s in servers.items()}
        ranked = {pkg: [x["item"] for x in json.loads(b)["itemScores"]]
                  for pkg, b in first.items()}
        assert ranked["jax"] == ranked["torch"] and ranked["jax"]
        bought = ranked["jax"][0]
        TReg.Storage.get_events().insert_columnar(ColumnarBatch(
            1, "buy", "user", ["u7"], "item", [bought], None,
            time_str(999_000)), store)
        again = {pkg: ask(pkg, s, query) for pkg, s in servers.items()}
        for pkg in servers:
            items = [x["item"] for x in json.loads(again[pkg])[
                "itemScores"]]
            if cache == "on":
                # stale: the cache does not know the answer reads the store
                assert again[pkg] == first[pkg], pkg
                assert bought in items
            else:
                assert bought not in items, pkg
    finally:
        for s in servers.values():
            s.batcher.stop()
