"""Port parity: train -> persisted engine instance -> deploy (L2 workflow
and persistence, L5 serving) vs the JAX reference, on the CPU.

Both packages train the recommendation template from one SQLite/localfs
store through their own `create_workflow_main` (rank 8, 3 iterations,
lam 0.1, read_items, return_properties). Tolerances: the trained factor
tables agree within FACTOR_TOL = 1e-4 of the largest factor, the bar of
tests/test_torch_als.py at lam 0.1 (f32 sums in another order over three
iterations). A model restored from storage is held bit-equal to the one
that was trained, and a server answers exactly as the in-memory model
does; scores served by the two packages' servers agree within 1e-4
relative (SCORE_RTOL), what the factor difference allows at scores ~5.
"""

import json
import os
import pickle
import pickletools
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import get_engine_factory as j_factory
from predictionio_tpu.serving import server as JS
from predictionio_tpu.workflow import create_workflow as JW
from predictionio_tpu_torch.core import EngineParams
from predictionio_tpu_torch.core.persistence import (
    RETRAIN, PersistentModel, PersistentModelLoader, PersistentModelManifest,
    load_persistent_model)
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.synthetic import synthetic_item_categories
from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.models import similarproduct as TS
from predictionio_tpu_torch.ops.als import ALSModel
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main, run_train)

FACTOR_TOL = 1e-4
SCORE_RTOL = 1e-4
APP = "deployapp"
N_USERS, N_ITEMS, N_RATE = 50, 35, 900
ALGO = dict(rank=8, num_iterations=3, lam=0.1, seed=1,
            return_properties=["creationYear"])
STORAGE_ENV = {
    "PIO_STORAGE_REPOSITORIES_METADATA_NAME": "pio_meta",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "SQLITE",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_NAME": "pio_event",
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "SQLITE",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_NAME": "pio_model",
    "PIO_STORAGE_REPOSITORIES_MODELDATA_SOURCE": "LOCALFS",
    "PIO_STORAGE_SOURCES_SQLITE_TYPE": "sqlite",
    "PIO_STORAGE_SOURCES_LOCALFS_TYPE": "localfs",
}


def storage_env(root) -> dict:
    """The `tmp_env` fixture's variables, rooted at `root`."""
    return dict(STORAGE_ENV, PIO_FS_BASEDIR=str(root / "pio"),
                PIO_STORAGE_SOURCES_SQLITE_URL=str(root / "pio" / "pio.db"),
                PIO_STORAGE_SOURCES_LOCALFS_HOSTS=str(root / "pio" /
                                                      "models"))


def populate(seed: int = 0) -> None:
    """Rate events (seeded, with repeated pairs) and one $set per item
    with categories and, for most items, a creationYear."""
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_USERS, N_RATE)
    i = rng.integers(0, N_ITEMS, N_RATE)
    r = rng.integers(1, 6, N_RATE)
    ev = TReg.Storage.get_events()
    ev.insert_columnar(ColumnarBatch(
        N_RATE, "rate", "user", [f"u{x}" for x in u], "item",
        [f"i{x}" for x in i], [{"rating": float(x)} for x in r],
        ["1970-01-01T00:00:%02d.%03dZ" % divmod(j, 1000)
         for j in range(N_RATE)]), app_id)
    cats = synthetic_item_categories(N_ITEMS, n_categories=4, seed=seed)
    ev.insert_columnar(ColumnarBatch(
        N_ITEMS, "$set", "item", [f"i{k}" for k in range(N_ITEMS)],
        properties=[dict({"categories": list(cats[k])},
                         **({"creationYear": 1990 + k % 11} if k % 5
                            else {}))
                    for k in range(N_ITEMS)],
        event_time="1970-01-01T01:00:00.000Z"), app_id)


def write_variant(path, algo: dict) -> str:
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "recommendation",
        "datasource": {"params": {"app_name": APP, "read_items": True}},
        "algorithms": [{"name": "als", "params": algo}]}))
    return str(path)


def post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url: str):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One store, trained by both packages' `create_workflow_main`."""
    root = tmp_path_factory.mktemp("deploy")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in storage_env(root).items():
            mp.setenv(k, v)
        JReg.clear_cache()
        TReg.clear_cache()
        populate()
        path_j = write_variant(root / "engine_jax.json", ALGO)
        path_t = write_variant(root / "engine_port.json",
                               dict(ALGO, device="cpu"))
        id_j = JW.create_workflow_main(JW.WorkflowConfig(
            engine_variant=path_j))
        tel = {}
        id_t = create_workflow_main(WorkflowConfig(engine_variant=path_t),
                                    telemetry=tel)
        yield dict(root=root, path_j=path_j, path_t=path_t, id_j=id_j,
                   id_t=id_t, tel=tel)
        JReg.clear_cache()
        TReg.clear_cache()


def restored(id_):
    """The port's engine and the models of instance `id_`, unpickled."""
    engine = TR.RecommendationEngineFactory.apply()
    blob = TReg.Storage.get_model_data_models().get(id_).models
    return engine, engine.deserialize_models(blob, id_)


def test_train_records_completed_instances(trained):
    inst = TReg.Storage.get_meta_data_engine_instances()
    t, j = inst.get(trained["id_t"]), inst.get(trained["id_j"])
    assert t.status == j.status == "COMPLETED"
    assert (t.engine_id, t.engine_version, t.engine_factory) == \
        (j.engine_id, j.engine_version, j.engine_factory)
    assert t.engine_variant == trained["path_t"]
    assert json.loads(t.data_source_params)["params"]["read_items"]
    tel = trained["tel"]
    assert tel["model_bytes"] == len(
        TReg.Storage.get_model_data_models().get(t.id).models)
    assert tel["algorithms"][0]["solver_calls"] > 0
    for k in ("read_s", "prepare_s", "train_s", "serialize_s", "persist_s"):
        assert tel[k] >= 0


def test_trained_factors_match_the_reference(trained):
    _, (mt,) = restored(trained["id_t"])
    j_engine = j_factory("recommendation").apply()
    (mj,) = j_engine.deserialize_models(
        JReg.Storage.get_model_data_models().get(trained["id_j"]).models)
    assert list(mt.user_ix.ids) == list(mj.user_ix._ids)
    assert list(mt.item_ix.ids) == list(mj.item_ix._ids)
    assert mt.item_properties == mj.item_properties
    for a, b in ((mj.als.user_factors, mt.als.user_factors),
                 (mj.als.item_factors, mt.als.item_factors)):
        assert np.abs(a - b).max() <= FACTOR_TOL * np.abs(a).max()


def test_engine_params_json_round_trips(trained):
    engine = TR.RecommendationEngineFactory.apply()
    with open(trained["path_t"]) as f:
        ep = engine.json_to_engine_params(json.load(f))
    inst = TReg.Storage.get_meta_data_engine_instances().get(
        trained["id_t"])
    recorded = {"datasource": json.loads(inst.data_source_params),
                "preparator": json.loads(inst.preparator_params),
                "algorithms": json.loads(inst.algorithms_params),
                "serving": json.loads(inst.serving_params)}
    assert json.loads(json.dumps(engine.engine_params_to_json(ep))) == \
        recorded
    back = engine.json_to_engine_params(recorded)
    assert back.algorithm_params_list == ep.algorithm_params_list
    assert back.preparator_params == ep.preparator_params
    assert vars(back.data_source_params[1]) == vars(ep.data_source_params[1])
    assert back.algorithm_params_list[0][1].return_properties == \
        ("creationYear",)


def test_blob_holds_host_numpy_only(trained):
    blob = TReg.Storage.get_model_data_models().get(trained["id_t"]).models
    modules = {arg.split(" ")[0] for op, arg, _ in pickletools.genops(blob)
               if op.name in ("GLOBAL", "STACK_GLOBAL") and arg}
    strings = [arg for op, arg, _ in pickletools.genops(blob)
               if op.name in ("SHORT_BINUNICODE", "BINUNICODE")]
    assert not any(s.split(".")[0] == "torch" for s in modules | set(
        strings))
    _, (m,) = restored(trained["id_t"])
    assert m.als._tables is None and m.als.device is None
    with pytest.raises(RuntimeError, match="place_model"):
        m.als.tables()


def test_blob_of_a_model_with_device_tables_drops_them():
    U = np.arange(12, dtype=np.float32).reshape(4, 3)
    als = ALSModel(U, U[:2].copy(), 3, torch.device("cpu"))
    U_dev, V_dev = als.tables()
    engine = TR.RecommendationEngineFactory.apply()
    blob = engine.serialize_models([als])
    assert als._tables[0] is U_dev      # the live model keeps its tables
    (back,) = engine.deserialize_models(blob, "x")
    assert back._tables is None and back.device is None
    np.testing.assert_array_equal(back.user_factors, U)
    np.testing.assert_array_equal(back.item_factors, U[:2])


def test_deploy_restores_and_serves_like_the_in_memory_model(
        trained, monkeypatch):
    # the served scores are held bit for bit against predict's f32 ones:
    # the default f16 readback is held in tests/test_torch_serve_plane.py
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    srv = EngineServer(ServerConfig(port=0,
                                    engine_variant=trained["path_t"]))
    srv.load().start()
    try:
        assert srv.engine_instance.id == trained["id_t"]
        (model,) = srv.models
        U, V = model.als.tables()
        assert U.device.type == "cpu"
        _, (fresh,) = restored(trained["id_t"])
        np.testing.assert_array_equal(U.numpy(), fresh.als.user_factors)
        # the in-memory model: the same engine params trained in process
        engine = TR.RecommendationEngineFactory.apply()
        ep = engine.json_to_engine_params(json.load(open(trained["path_t"])))
        mem = engine.train(ep)
        np.testing.assert_array_equal(mem.models[0].als.item_factors,
                                      model.als.item_factors)
        algo = mem.algorithms[0]
        url = f"http://127.0.0.1:{srv.config.port}"
        for body in ({"user": "u1", "num": 5},
                     {"user": "u7", "num": 4, "categories": ["c1"]},
                     {"user": "u3", "num": 6, "creationYear": 1995},
                     {"user": "u9", "num": 3, "categories": ["c0", "c2"],
                      "creationYear": 1993},
                     {"user": "nobody", "num": 3},
                     {"user": "u1", "num": 3, "categories": ["none"]}):
            status, got = post(url + "/queries.json",
                               json.dumps(body).encode())
            want = algo.predict(mem.models[0],
                                TR.Query.from_dict(body)).to_dict()
            assert status == 200 and got == want
            assert all("creationYear" in s for s in got["itemScores"])
        status, st = get(url + "/")
        assert st["engineInstanceId"] == trained["id_t"]
    finally:
        srv.stop()


def test_both_servers_answer_alike_and_reject_malformed_fields(
        trained, monkeypatch):
    # the reference's exact readback: its f16 score packing stays out
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    j = JS.EngineServer(JS.ServerConfig(
        ip="127.0.0.1", port=0, engine_variant=trained["path_j"]))
    j.load()
    j.start(background=True)
    t = EngineServer(ServerConfig(port=0, engine_variant=trained["path_t"]))
    t.load().start()
    try:
        urls = [f"http://127.0.0.1:{s.config.port}/queries.json"
                for s in (j, t)]
        for body in ({"user": "u2", "num": 5},
                     {"user": "u4", "num": 5, "categories": ["c3"],
                      "creationYear": 1992}):
            (sj, bj), (st, bt) = [post(u, json.dumps(body).encode())
                                  for u in urls]
            assert sj == st == 200
            assert [s["item"] for s in bt["itemScores"]] == \
                [s["item"] for s in bj["itemScores"]]
            np.testing.assert_allclose(
                [s["score"] for s in bt["itemScores"]],
                [s["score"] for s in bj["itemScores"]], rtol=SCORE_RTOL)
        for bad in (b'{"user": "u1", "num": 3, "creationYear": "old"}',
                    b'{"user": "u1", "categories": ["c1"]}',
                    b'{"user": "u1", "num": "x"}', b'{"num": 3}'):
            assert [post(u, bad)[0] for u in urls] == [400, 400]
        # a field of the wrong JSON type raises TypeError in both
        # packages' Query.from_dict; the reference's server answers that
        # 500, the port's 400 like every other malformed body
        bad = b'{"user": "u1", "num": 3, "categories": 7}'
        assert [post(u, bad)[0] for u in urls] == [500, 400]
    finally:
        t.stop()
        j.stop()


def test_jax_blob_is_refused_without_importing_the_reference(trained):
    code = (
        "import sys\n"
        "from predictionio_tpu_torch.serving.server import (EngineServer,\n"
        "    ServerConfig)\n"
        f"srv = EngineServer(ServerConfig(engine_instance_id={trained['id_j']!r}))\n"
        "try:\n"
        "    srv.load()\n"
        "except ValueError as e:\n"
        "    print('refused:', e)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('predictionio_tpu', 'jax')))\n")
    env = dict(os.environ, **storage_env(trained["root"]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("refused:")
    assert trained["id_j"] in lines[0] and "JAX package" in lines[0]
    assert lines[-1] == "[]"


def test_blob_unpickles_where_there_is_no_card(trained):
    code = (
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from predictionio_tpu_torch.models.recommendation import (\n"
        "    RecommendationEngineFactory)\n"
        "from predictionio_tpu_torch.data.storage.registry import Storage\n"
        f"blob = Storage.get_model_data_models().get({trained['id_t']!r})\n"
        "(m,) = RecommendationEngineFactory.apply().deserialize_models(\n"
        "    blob.models)\n"
        "print(m.als.user_factors.shape, m.als.device)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               **storage_env(trained["root"]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == f"({N_USERS}, 8) None"


def test_reload_picks_the_newer_instance(tmp_env, tmp_path, monkeypatch):
    # the answer after /reload is held bit for bit against predict's f32
    # one: the default f16 readback is held in test_torch_serve_plane.py
    monkeypatch.setenv("PIO_SERVE_PACK", "exact")
    TReg.clear_cache()
    try:
        populate(seed=3)
        path = write_variant(tmp_path / "engine.json",
                             dict(ALGO, device="cpu"))
        first = create_workflow_main(WorkflowConfig(engine_variant=path))
        srv = EngineServer(ServerConfig(port=0, engine_variant=path))
        srv.load().start()
        url = f"http://127.0.0.1:{srv.config.port}"
        try:
            assert get(url + "/")[1]["engineInstanceId"] == first
            q = json.dumps({"user": "u3", "num": 5}).encode()
            before = post(url + "/queries.json", q)[1]
            write_variant(tmp_path / "engine.json",
                          dict(ALGO, device="cpu", seed=2))
            second = create_workflow_main(WorkflowConfig(
                engine_variant=path))
            assert post(url + "/reload", b"") == (200,
                                                  {"message": "Reloaded"})
            assert get(url + "/")[1]["engineInstanceId"] == second
            after = post(url + "/queries.json", q)[1]
            _, (m2,) = restored(second)
            m2 = srv.algorithms[0].place_model(m2)
            assert after == srv.algorithms[0].predict(
                m2, TR.Query("u3", 5)).to_dict()
            assert after != before
            assert srv.algorithms[0].params.seed == 2
            # GET works too, and a pinned instance id stays pinned
            assert get(url + "/reload")[0] == 200
            assert srv.engine_instance.id == second
        finally:
            srv.stop()
        pinned = EngineServer(ServerConfig(engine_instance_id=first)).load()
        pinned.reload()
        assert pinned.engine_instance.id == first
    finally:
        TReg.clear_cache()


def test_stop_route_shuts_the_server_down(trained):
    srv = EngineServer(ServerConfig(port=0,
                                    engine_variant=trained["path_t"]))
    srv.load().start()
    url = f"http://127.0.0.1:{srv.config.port}"
    assert post(url + "/stop", b"") == (200, {"message": "Shutting down."})
    for _ in range(100):
        try:
            get(url + "/")
        except OSError:
            break
        time.sleep(0.05)
    else:
        pytest.fail("the server still answers after /stop")


def test_load_without_a_trained_instance_raises(trained):
    with pytest.raises(ValueError, match="No valid engine instance"):
        EngineServer(ServerConfig(engine_variant="nope.json")).load()
    with pytest.raises(ValueError, match="Invalid engine instance id"):
        EngineServer(ServerConfig(engine_instance_id="nope")).load()


def test_run_train_refuses_array_params(tmp_env):
    TReg.clear_cache()
    try:
        engine = TR.RecommendationEngineFactory.apply()
        ep = TR.RecommendationEngineFactory.engine_params(
            TR.RatingsData(["u"], ["i"], [1.0]),
            TR.ALSAlgorithmParams(rank=2, device="cpu"))
        with pytest.raises(ValueError, match="DataSourceParams.ratings"):
            run_train(engine, ep)
        assert TReg.Storage.get_meta_data_engine_instances().get_all() == []
    finally:
        TReg.clear_cache()


def test_failed_train_is_recorded_aborted(tmp_env, tmp_path):
    TReg.clear_cache()
    try:
        path = write_variant(tmp_path / "engine.json",
                             dict(ALGO, device="cpu"))
        with pytest.raises(ValueError, match="Invalid app name"):
            create_workflow_main(WorkflowConfig(engine_variant=path))
        (inst,) = TReg.Storage.get_meta_data_engine_instances().get_all()
        assert inst.status == "ABORTED"
    finally:
        TReg.clear_cache()


def test_similarproduct_model_round_trips_and_is_placed():
    td = TS.TrainingData(
        users={}, items={"x": TS.Item(("c",)), "y": TS.Item(("c",)),
                         "z": TS.Item(("d",))},
        view_events=[TS.ViewEvent("u1", "x"), TS.ViewEvent("u2", "y"),
                     TS.ViewEvent("u2", "x"), TS.ViewEvent("u1", "z")])
    algo = TS.ALSAlgorithm(TS.ALSAlgorithmParams(rank=2, num_iterations=2,
                                                 device="cpu"))
    model = algo.train(TS.SimilarProductPreparator().prepare(td))
    model.table()
    engine = TS.SimilarProductEngineFactory.apply()
    (back,) = engine.deserialize_models(engine.serialize_models([model]))
    assert back._table is None and back.device is None
    result = engine.prepare_deploy(
        EngineParams(algorithm_params_list=[("als", algo.params)]), [back],
        "x")
    placed = result.models[0]
    assert placed.table().device.type == "cpu"
    q = TS.Query(items=("x",), num=2)
    assert result.algorithms[0].predict(placed, q) == algo.predict(model, q)


def test_engine_factories_and_loaders_of_the_reference_are_refused():
    assert get_engine_factory("recommendation") is \
        TR.RecommendationEngineFactory
    assert get_engine_factory(
        "predictionio_tpu_torch.models.similarproduct."
        "SimilarProductEngineFactory") is TS.SimilarProductEngineFactory
    for name in ("predictionio_tpu.models.recommendation."
                 "RecommendationEngineFactory", "nosuch"):
        with pytest.raises(KeyError):
            get_engine_factory(name)
    with pytest.raises(ValueError, match="JAX package"):
        load_persistent_model(PersistentModelManifest(
            "predictionio_tpu.models.recommendation.Loader"), "x", None)
    assert pickle.loads(pickle.dumps(RETRAIN)) is RETRAIN


def test_restricted_unpickler_refuses_other_globals():
    engine = TR.RecommendationEngineFactory.apply()
    with pytest.raises(ValueError, match="may not hold"):
        engine.deserialize_models(pickle.dumps([os.system]), "inst-1")
    with pytest.raises(ValueError, match="inst-2"):
        engine.deserialize_models(pickle.dumps([torch.device("cpu")]),
                                  "inst-2")


def _global_blob(module: str, name: str) -> bytes:
    """A protocol-4 pickle of one STACK_GLOBAL: `module`.`name`."""
    def text(s: str) -> bytes:
        b = s.encode()
        return pickle.SHORT_BINUNICODE + bytes([len(b)]) + b
    return (pickle.PROTO + b"\x04" + text(module) + text(name)
            + pickle.STACK_GLOBAL + pickle.STOP)


@pytest.mark.parametrize("module,name", [
    # dotted names reach past the package into what its modules import
    ("predictionio_tpu_torch.core.engine", "pickle.loads"),
    ("predictionio_tpu_torch.ops._build", "subprocess.run"),
    ("predictionio_tpu_torch.models.recommendation", "np.load"),
    ("numpy", "lib.format.read_array"),
    # plain names that are not a model's class
    ("predictionio_tpu_torch.models.recommendation", "np"),
    ("predictionio_tpu_torch.models.recommendation", "build_filter_mask"),
    ("predictionio_tpu_torch.serving.server", "EngineServer"),
    ("predictionio_tpu_torch.models.nosuch", "Model"),
    ("numpy", "load"),
    ("builtins", "eval"),
])
def test_restricted_unpickler_refuses_dotted_and_foreign_names(module, name):
    engine = TR.RecommendationEngineFactory.apply()
    with pytest.raises(ValueError, match="may not hold"):
        engine.deserialize_models(_global_blob(module, name), "inst-3")


def test_restricted_unpickler_takes_a_models_classes_by_plain_name():
    engine = TR.RecommendationEngineFactory.apply()
    for module, name, want in [
            ("predictionio_tpu_torch.models.recommendation",
             "RecommendationModel", TR.RecommendationModel),
            ("predictionio_tpu_torch.ops.als", "ALSModel", ALSModel),
            ("numpy", "ndarray", np.ndarray)]:
        assert engine.deserialize_models(_global_blob(module, name)) is want


class _Saved(PersistentModel, PersistentModelLoader):
    """A model that persists itself (a manifest in the blob)."""
    store: dict = {}

    def __init__(self, value=None):
        self.value = value

    def save(self, instance_id, params) -> bool:
        _Saved.store[instance_id] = self.value
        return True

    def load(self, instance_id, params):
        return _Saved(_Saved.store[instance_id])


class _Algo(TR.ALSAlgorithm):
    """Trains a fixed value; persists it as its mode says."""
    MODE = None

    def train(self, pd):
        return _Saved(42) if self.MODE == "manual" else {"value": 42}

    def make_persistent_model(self, model):
        return RETRAIN if self.MODE == "retrain" else model

    def place_model(self, model):
        return ("placed", model)


@pytest.mark.parametrize("mode", ["automatic", "manual", "retrain"])
def test_the_three_persistence_modes_restore_at_deploy(mode, monkeypatch):
    from predictionio_tpu_torch.core import Engine
    monkeypatch.setattr(_Algo, "MODE", mode)
    pd = TR.PreparedData(None, None, None)

    class Source(TR.RecommendationDataSource):
        def read_training(self):
            return None

    class Prep(TR.RecommendationPreparator):
        def prepare(self, td):
            return pd

    engine = Engine(Source, Prep, {"a": _Algo}, TR.FirstServing)
    ep = EngineParams(algorithm_params_list=[("a", TR.ALSAlgorithmParams())])
    trained = engine.train(ep, sanity_check=False)
    blob = engine.serialize_models(engine.make_serializable_models(
        trained, "inst", ep))
    (persisted,) = engine.deserialize_models(blob, "inst")
    want = {"automatic": dict, "manual": PersistentModelManifest,
            "retrain": type(RETRAIN)}[mode]
    assert isinstance(persisted, want)
    (placed,) = engine.prepare_deploy(ep, [persisted], "inst",
                                      sanity_check=False).models
    assert placed[0] == "placed"
    got = placed[1].value if mode == "manual" else placed[1]["value"]
    assert got == 42
