"""Port parity: the similar-product data source reading the event store,
and the similar-product template trained from the store through the
workflow, vs the JAX reference, on the CPU.

Both packages read one seeded SQLite store (the `tmp_env` fixture's
`PIO_STORAGE_*`): users' and items' `$set` properties, `view`, `rate`
and `like`/`dislike` events at repeated event times. The training data
is held exactly, array for array and in the same order: users,
items (categories and properties), the view and like columns, under
`rate_as_view` and `read_like_events` both ways. `create_workflow_main`
trains the template from the store in both packages (rank 6, 4
iterations, alpha 2, the port's Cholesky solver): the normalized item
tables agree within 1.5e-5 of the largest entry (the implicit parity bar
of tests/test_torch_similarproduct.py), and the port's deployed instance
answers queries.
"""

import json

import numpy as np
import pytest

from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import similarproduct as JS
from predictionio_tpu.workflow import create_workflow as JW
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import similarproduct as TS
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

APP = "simapp"
N_USERS, N_ITEMS = 30, 24
FACTOR_TOL = 1.5e-5


def time_str(ms: int) -> str:
    sec, ms = divmod(ms, 1000)
    return "1970-01-01T00:%02d:%02d.%03dZ" % (sec // 60, sec % 60, ms)


@pytest.fixture()
def store(tmp_env):
    """Seeded events written through the port's storage; both packages'
    registries read them."""
    TReg.clear_cache()
    JReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    ev = TReg.Storage.get_events()
    rng = np.random.default_rng(11)
    t = iter(range(10 ** 6))
    ev.insert_columnar(ColumnarBatch(
        N_USERS // 2, "$set", "user",
        [f"u{k}" for k in range(0, N_USERS, 2)],
        properties=[{"age": 20 + k} for k in range(0, N_USERS, 2)],
        event_time=time_str(next(t))), app_id)
    ev.insert_columnar(ColumnarBatch(
        N_ITEMS, "$set", "item", [f"i{k}" for k in range(N_ITEMS)],
        properties=[dict({"categories": [f"c{k % 3}", f"c{k % 5}"]}
                         if k % 6 else {}, year=1990 + k, title=f"T{k}")
                    for k in range(N_ITEMS)],
        event_time=time_str(next(t))), app_id)
    # a later $set overwrites one item's categories
    ev.insert_columnar(ColumnarBatch(
        1, "$set", "item", ["i4"], properties=[{"categories": ["c9"]}],
        event_time=time_str(next(t))), app_id)
    for name, n in (("view", 500), ("rate", 150), ("like", 90),
                    ("dislike", 60), ("buy", 40)):
        # pairs of rows share an event time: equal-time rows keep their
        # insertion order in both reads
        times = [time_str(next(t)) for _ in range((n + 1) // 2)]
        ev.insert_columnar(ColumnarBatch(
            n, name, "user",
            [f"u{x}" for x in rng.integers(0, N_USERS, n)], "item",
            [f"i{x}" for x in rng.integers(0, N_ITEMS - 2, n)],
            [{"rating": float(x)} for x in rng.integers(1, 6, n)]
            if name == "rate" else None,
            [times[k // 2] for k in range(n)]), app_id)
    yield tmp_env
    TReg.clear_cache()
    JReg.clear_cache()


@pytest.mark.parametrize("rate_as_view", [False, True])
@pytest.mark.parametrize("read_like_events", [False, True])
def test_read_training_matches_the_reference(store, rate_as_view,
                                             read_like_events):
    kw = dict(app_name=APP, rate_as_view=rate_as_view,
              read_like_events=read_like_events)
    td_j = JS.SimilarProductDataSource(
        JS.DataSourceParams(**kw)).read_training()
    td_t = TS.SimilarProductDataSource(
        TS.DataSourceParams(**kw)).read_training()
    assert td_t.users == td_j.users and len(td_t.users) == N_USERS // 2
    assert list(td_t.items) == list(td_j.items)
    assert len(td_t.items) == N_ITEMS
    for k in td_j.items:
        assert td_t.items[k].categories == td_j.items[k].categories
        assert td_t.items[k].properties == td_j.items[k].properties
    assert td_t.items["i4"].categories == ("c9",)
    assert td_t.items["i0"].categories is None
    n_views = 500 + (150 if rate_as_view else 0)
    for name in ("users", "items", "vals", "ts"):
        a = getattr(td_t.view_events, name)
        b = getattr(td_j.view_events, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(td_t.view_events) == n_views
    assert (td_t.view_events.vals == 1.0).all()
    if not read_like_events:
        assert td_t.like_events is None and td_j.like_events is None
        return
    for name in ("users", "items", "vals", "ts"):
        np.testing.assert_array_equal(getattr(td_t.like_events, name),
                                      getattr(td_j.like_events, name))
    assert sorted(set(td_t.like_events.vals.tolist())) == [-1.0, 1.0]
    assert len(td_t.like_events) == 150


def test_array_params_have_no_json_form():
    from predictionio_tpu_torch.core import params as TP
    p = TS.DataSourceParams(items={"i": TS.Item(("c",))},
                            view_events=TS.RatingsData(["u"], ["i"], [1.0]))
    with pytest.raises(ValueError, match="DataSourceParams.items"):
        TP.params_to_dict(p)
    assert TP.params_to_dict(TS.DataSourceParams(app_name="a")) == {
        "app_name": "a", "channel_name": None, "rate_as_view": False,
        "read_like_events": False, "items": None, "view_events": None,
        "like_events": None}


def variant(path, **algo) -> str:
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "similarproduct",
        "datasource": {"params": {"app_name": APP, "rate_as_view": True}},
        "algorithms": [{"name": "als", "params": dict(
            rank=6, num_iterations=4, lam=0.01, alpha=2.0, seed=3,
            return_properties=["title"], **algo)}]}))
    return str(path)


def test_run_train_trains_the_template_from_the_store(store, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("PIO_AOT_WARM", "on")
    id_j = JW.create_workflow_main(JW.WorkflowConfig(
        engine_variant=variant(tmp_path / "jax.json")))
    path = variant(tmp_path / "port.json", solver="chol_cuda", device="cpu")
    tel = {}
    id_t = create_workflow_main(WorkflowConfig(engine_variant=path),
                                telemetry=tel)
    inst = TReg.Storage.get_meta_data_engine_instances().get(id_t)
    assert inst.status == "COMPLETED" and inst.engine_factory == \
        "similarproduct"
    assert json.loads(inst.data_source_params)["params"]["rate_as_view"]
    assert tel["algorithms"][0]["ratings"] > 0
    (mj,) = JS.SimilarProductEngineFactory.apply().deserialize_models(
        JReg.Storage.get_model_data_models().get(id_j).models)
    (mt,) = TS.SimilarProductEngineFactory.apply().deserialize_models(
        TReg.Storage.get_model_data_models().get(id_t).models, id_t)
    assert list(mt.item_ix.ids) == list(mj.item_ix._ids)
    a, b = mj.item_factors_normalized, mt.item_factors_normalized
    assert np.abs(a - b).max() <= FACTOR_TOL * np.abs(a).max()
    srv = EngineServer(ServerConfig(port=0, engine_variant=path)).load()
    try:
        assert srv.engine_instance.id == id_t
        got = srv.answer({"items": ["i1", "i2"], "num": 4,
                          "categories": ["c1"]})
        assert 0 < len(got["itemScores"]) <= 4
        assert all("title" in s for s in got["itemScores"])
        # the masked top-k's ladder, 1..16: 5 buckets
        assert srv.last_aot_warm["compiled"] == 5
    finally:
        srv.stop()
