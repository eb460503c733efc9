"""Port parity: the classification template (`models/classification.py`),
multinomial naive Bayes (`ops/naive_bayes.py`), the random forest
(`ops/forest.py`) and the `weights.py` converters vs the JAX reference,
on the CPU.

Mirrors tests/test_naive_bayes.py `TestMultinomialNB` and
tests/test_forest.py. Tolerances:
- naive Bayes `pi`/`theta` within rtol 1e-5 of the reference's (and of
  the MLlib formulas in float64), the reference test's bound; with
  integer features the float32 counts are exact, so they are in fact
  equal;
- the forest's four tree arrays exactly equal the reference's, given the
  reference's own `jax.random` draws (drawn here as `forest.py:131-133`
  and `:183-184` draw them): the histograms are sums of integer
  bootstrap weights, exact in float32, and the gains are the same float32
  operations;
- with the port's own draws (a CPU `torch.Generator`), the reference
  test's bounds: accuracy > 0.85 on separable 4-class data (> 0.8 with
  entropy), the same trees for one seed and other trees for another.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.ops import forest as JF
from predictionio_tpu.ops.naive_bayes import \
    multinomial_nb_train as j_nb_train
from predictionio_tpu.parallel.mesh import make_mesh
from predictionio_tpu_torch import weights
from predictionio_tpu_torch.core import EngineParams
from predictionio_tpu_torch.core.params import params_from_dict
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import classification as C
from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.ops import forest as TF
from predictionio_tpu_torch.ops.naive_bayes import multinomial_nb_train
from predictionio_tpu_torch.serving.server import EngineServer, ServerConfig
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main)

NB_RTOL = 1e-5
TREE_ARRAYS = ("feature", "threshold", "is_leaf", "leaf_class")


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(jax.devices()[:1])


def np_reference(X, y, lam):
    """tests/test_naive_bayes.py's float64 MLlib formulas."""
    classes = np.unique(y)
    C_, D = len(classes), X.shape[1]
    N = len(y)
    pi, theta = np.zeros(C_), np.zeros((C_, D))
    for ci, c in enumerate(classes):
        sel = y == c
        pi[ci] = np.log((sel.sum() + lam) / (N + C_ * lam))
        sums = X[sel].sum(axis=0).astype(np.float64)
        theta[ci] = np.log(sums + lam) - np.log(sums.sum() + D * lam)
    return pi, theta, classes


@pytest.mark.parametrize("lam", [0.1, 1.0, 10.0])
def test_nb_matches_the_reference_and_the_mllib_formulas(mesh1, lam):
    rng = np.random.default_rng(0)
    X = rng.integers(0, 5, size=(97, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=97).astype(np.float64)
    m = multinomial_nb_train(X, y, lam=lam, device="cpu")
    j = j_nb_train(X, y, lam=lam, mesh=mesh1)
    pi, theta, classes = np_reference(X, y, lam)
    for got in (j.pi, pi):
        np.testing.assert_allclose(m.pi, got, rtol=NB_RTOL)
    for got in (j.theta, theta):
        np.testing.assert_allclose(m.theta, got, rtol=NB_RTOL)
    np.testing.assert_array_equal(m.labels, classes)
    np.testing.assert_array_equal(m.labels, j.labels)


def test_nb_predict_separable():
    X = np.array([[10, 0], [9, 1], [0, 10], [1, 9]], dtype=np.float32)
    y = np.array([0, 0, 1, 1], dtype=np.float64)
    m = multinomial_nb_train(X, y, lam=1.0, device="cpu")
    assert m.predict(np.array([5.0, 0.0])) == 0.0
    assert m.predict(np.array([0.0, 5.0])) == 1.0


def test_nb_priors_count_every_row(mesh1):
    """tests/test_naive_bayes.py's 13-row case (the reference pads it to
    its mesh; the port has nothing to pad)."""
    X = np.ones((13, 3), dtype=np.float32)
    y = np.array([0, 1] * 6 + [0], dtype=np.float64)
    m = multinomial_nb_train(X, y, lam=1.0, device="cpu")
    assert m.pi[0] > m.pi[1]
    np.testing.assert_allclose(np.exp(m.pi).sum(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(m.pi, j_nb_train(X, y, 1.0, mesh1).pi,
                               rtol=NB_RTOL)


def four_class(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
         + 2 * (X[:, 2] > 0.3)).astype(int)
    return X, y


def jax_draws(seed, T, n, D, F):
    """The reference's bootstrap weights and per-level feature scores."""
    kw, kf = jax.random.split(jax.random.PRNGKey(seed))
    w = np.asarray(jax.random.poisson(kw, 1.0, (T, n)).astype(jnp.float32))
    scores = [np.asarray(jax.random.uniform(jax.random.fold_in(kf, d),
                                            (T, 2 ** d, F)))
              for d in range(D)]
    return w, scores


@pytest.mark.parametrize("case", [
    dict(n=600, T=15, D=6, B=32, impurity="gini", strategy="auto", seed=42),
    dict(n=400, T=10, D=5, B=32, impurity="entropy", strategy="auto",
         seed=7),
    dict(n=257, T=4, D=4, B=8, impurity="gini", strategy="all", seed=3),
    dict(n=50, T=3, D=3, B=64, impurity="entropy", strategy="onethird",
         seed=11)])
def test_forest_arrays_equal_the_reference_given_its_draws(case):
    X, y = four_class(case["n"], seed=case["seed"])
    kw = dict(num_classes=4, num_trees=case["T"], max_depth=case["D"],
              max_bins=case["B"], impurity=case["impurity"],
              feature_subset_strategy=case["strategy"], seed=case["seed"])
    j = JF.forest_train(X, y, **kw)
    w, scores = jax_draws(case["seed"], case["T"], case["n"], case["D"],
                          X.shape[1])
    t = TF.forest_train(X, y, bootstrap=w, feature_scores=scores,
                        device="cpu", **kw)
    for a in TREE_ARRAYS:
        got, want = getattr(t, a), getattr(j, a)
        assert got.dtype == want.dtype and np.array_equal(got, want), a
    Xt, _ = four_class(200, seed=99)
    assert np.array_equal(t.predict_batch(Xt), j.predict_batch(Xt))


def test_forest_learns_separable_4class():
    X, y = four_class(600)
    m = TF.forest_train(X, y, num_classes=4, num_trees=15, max_depth=6,
                        device="cpu")
    Xt, yt = four_class(400, seed=1)
    assert (m.predict_batch(Xt) == yt).mean() > 0.85
    for i in range(10):
        assert m.predict(Xt[i]) == m.predict_batch(Xt[i:i + 1])[0]


def test_forest_deterministic_given_seed():
    X, y = four_class(300)
    a = TF.forest_train(X, y, num_classes=4, num_trees=8, seed=7,
                        device="cpu")
    b = TF.forest_train(X, y, num_classes=4, num_trees=8, seed=7,
                        device="cpu")
    for name in TREE_ARRAYS:
        assert np.array_equal(getattr(a, name), getattr(b, name))
    c = TF.forest_train(X, y, num_classes=4, num_trees=8, seed=8,
                        device="cpu")
    assert not np.array_equal(a.threshold, c.threshold)


def test_forest_entropy_impurity():
    X, y = four_class(400)
    m = TF.forest_train(X, y, num_classes=4, num_trees=10,
                        impurity="entropy", device="cpu")
    Xt, yt = four_class(300, seed=2)
    assert (m.predict_batch(Xt) == yt).mean() > 0.8


def test_forest_knob_and_label_rules():
    X, y = four_class(50)
    with pytest.raises(ValueError):
        TF.forest_train(X, y, num_classes=4, impurity="variance",
                        device="cpu")
    with pytest.raises(ValueError):
        TF.feature_subset_size("most", 4, 10)
    with pytest.raises(ValueError, match=r"\[0, 2\)"):
        TF.forest_train(X, y, num_classes=2, device="cpu")
    with pytest.raises(ValueError, match="integer"):
        TF.forest_train(X, y + 0.5, num_classes=5, device="cpu")
    with pytest.raises(ValueError, match="bootstrap"):
        TF.forest_train(X, y, num_classes=4, num_trees=3, device="cpu",
                        bootstrap=np.ones((2, 50), np.float32))
    for strategy in ("auto", "all", "sqrt", "log2", "onethird"):
        for F in (1, 4, 9, 10, 16):
            for T in (1, 10):
                assert TF.feature_subset_size(strategy, F, T) == \
                    JF.feature_subset_size(strategy, F, T)


def test_forest_pure_node_becomes_leaf():
    base = np.array([[0.0, 5.0], [0.1, -3.0], [0.9, 2.0], [1.0, -1.0]],
                    np.float32)
    X = np.tile(base, (10, 1))
    y = np.tile(np.array([0, 0, 1, 1]), 10)
    m = TF.forest_train(X, y, num_classes=2, num_trees=5, max_depth=4,
                        feature_subset_strategy="all", max_bins=4,
                        device="cpu")
    assert list(m.predict_batch(base)) == [0.0, 0.0, 1.0, 1.0]


def test_converters_carry_the_reference_models(mesh1):
    X, y = four_class(300)
    jf = JF.forest_train(X, y, num_classes=4, num_trees=6, max_depth=4)
    tf = weights.from_jax_forest_model(
        *(getattr(jf, a) for a in TREE_ARRAYS), num_classes=jf.num_classes,
        max_depth=jf.max_depth)
    Xt, _ = four_class(100, seed=5)
    assert np.array_equal(tf.predict_batch(Xt), jf.predict_batch(Xt))
    Xc = np.abs(np.round(X[:, :3] * 3))
    jn = j_nb_train(Xc, y.astype(np.float64), lam=1.0, mesh=mesh1)
    tn = weights.from_jax_nb_model(jn.pi, jn.theta, jn.labels)
    algo = C.NaiveBayesAlgorithm(C.NaiveBayesAlgorithmParams(device="cpu"))
    queries = [(i, C.Query(*map(float, Xc[i, :3]))) for i in range(40)]
    from predictionio_tpu.models import classification as JC
    j_algo = JC.NaiveBayesAlgorithm()
    for (ix, got), (_, want) in zip(
            algo.batch_predict(tn, queries),
            j_algo.batch_predict(jn, [(i, JC.Query(q.attr0, q.attr1,
                                                   q.attr2))
                                      for i, q in queries])):
        assert got.label == want.label
    with pytest.raises(ValueError):
        weights.from_jax_nb_model(jn.pi, jn.theta[:1], jn.labels)
    with pytest.raises(ValueError):
        weights.from_jax_forest_model(jf.feature[:, :3], jf.threshold,
                                      jf.is_leaf, jf.leaf_class, 4, 4)


APP = "clsapp"


@pytest.fixture()
def cls_store(tmp_env):
    """tests/test_forest.py's 40 users, $set by the port."""
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, APP))
    rng = np.random.default_rng(1)
    props = []
    for j in range(40):
        label = float(j % 2)
        base = np.array([8.0, 1.0, 1.0]) if label == 0 else \
            np.array([1.0, 1.0, 8.0])
        attrs = base + rng.integers(0, 2, 3)
        props.append({"plan": label, "attr0": float(attrs[0]),
                      "attr1": float(attrs[1]), "attr2": float(attrs[2])})
    TReg.Storage.get_events().insert_columnar(ColumnarBatch(
        40, "$set", "user", [f"u{j}" for j in range(40)], properties=props,
        event_time=["1970-01-01T00:00:%02d.000Z" % j for j in range(40)]),
        app_id)
    yield tmp_env
    TReg.clear_cache()


def test_engine_with_both_algorithms(cls_store):
    engine = get_engine_factory("classification").apply()
    ep = EngineParams(
        data_source_params=("", C.DataSourceParams(app_name=APP)),
        preparator_params=("", None),
        algorithm_params_list=[
            ("randomforest", C.RandomForestAlgorithmParams(
                num_classes=2, num_trees=10, max_depth=4, device="cpu")),
            ("naive", C.NaiveBayesAlgorithmParams(lam=1.0, device="cpu"))],
        serving_params=("", None))
    tr = engine.train(ep)
    assert len(tr.models) == 2
    rf, nb = tr.algorithms
    assert isinstance(rf, C.RandomForestAlgorithm)
    assert rf.predict(tr.models[0], C.Query(9.0, 1.0, 1.0)).label == 0.0
    assert rf.predict(tr.models[0], C.Query(1.0, 1.0, 9.0)).label == 1.0
    queries = [(i, C.Query(float(a), 1.0, float(b)))
               for i, (a, b) in enumerate([(9, 1), (1, 9), (8, 2)])]
    for algo, model in zip(tr.algorithms, tr.models):
        batched = dict(algo.batch_predict(model, queries))
        for ix, q in queries:
            assert batched[ix].label == algo.predict(model, q).label
    # the data source's points, folds and the NB model equal the
    # reference's on the same store
    from predictionio_tpu.data.storage import registry as JReg
    from predictionio_tpu.models import classification as JC
    JReg.clear_cache()
    jds = JC.ClassificationDataSource(JC.DataSourceParams(app_name=APP,
                                                          eval_k=3))
    tds = C.ClassificationDataSource(C.DataSourceParams(app_name=APP,
                                                        eval_k=3))
    assert [(p.label, p.features) for p in
            tds.read_training().labeled_points] == \
        [(p.label, p.features) for p in jds.read_training().labeled_points]
    for (td, _, qa), (jtd, _, jqa) in zip(tds.read_eval(), jds.read_eval()):
        assert len(td.labeled_points) == len(jtd.labeled_points)
        assert [(q.attr0, q.attr1, q.attr2, a.label) for q, a in qa] == \
            [(q.attr0, q.attr1, q.attr2, a.label) for q, a in jqa]
    JReg.clear_cache()


def test_params_from_engine_json():
    p = params_from_dict(C.RandomForestAlgorithmParams, {
        "num_classes": 4, "num_trees": 7,
        "feature_subset_strategy": "auto", "impurity": "entropy",
        "max_depth": 3, "max_bins": 16})
    assert p.num_trees == 7 and p.impurity == "entropy"
    assert p.max_depth == 3 and p.num_classes == 4
    with pytest.raises(ValueError):
        params_from_dict(C.RandomForestAlgorithmParams, {"numTrees": 7})
    assert C.Query.from_dict({"attr0": 2, "attr1": 0, "attr2": "1"}) == \
        C.Query(2.0, 0.0, 1.0)
    assert C.PredictedResult(3.0).to_dict() == {"label": 3.0}


def test_deployed_engine_answers_the_nb_argmax(cls_store):
    path = cls_store / "engine.json"
    path.write_text(json.dumps({
        "id": "default", "engineFactory": "classification",
        "datasource": {"params": {"app_name": APP}},
        "algorithms": [
            {"name": "naive", "params": {"lam": 1.0, "device": "cpu"}},
            {"name": "randomforest", "params": {
                "num_classes": 2, "num_trees": 5, "max_depth": 3,
                "device": "cpu"}}]}))
    iid = create_workflow_main(WorkflowConfig(engine_variant=str(path)))
    blob = TReg.Storage.get_model_data_models().get(iid).models
    nb, forest = C.ClassificationEngineFactory.apply().deserialize_models(
        blob, iid)
    assert isinstance(nb, C.MultinomialNBModel)
    assert isinstance(forest, C.ForestModel)
    server = EngineServer(ServerConfig(port=0, engine_variant=str(path))
                          ).load()
    try:
        rng = np.random.default_rng(8)
        for _ in range(12):
            x = rng.integers(0, 10, 3).astype(float)
            body, _ = server.queries(json.dumps(
                {"attr0": x[0], "attr1": x[1], "attr2": x[2]}).encode())
            want = nb.labels[np.argmax(nb.pi + nb.theta @ x)]
            assert json.loads(body) == {"label": float(want)}
        with pytest.raises((KeyError, ValueError)):
            server.queries(b'{"attr0": 1}')
    finally:
        server.batcher.stop()
