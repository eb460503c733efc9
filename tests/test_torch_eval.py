"""Port parity: evaluation (`core/metrics.py`, `core/cross_validation.py`,
`core/evaluation.py`, `core/fast_eval.py`, `Engine.eval`, the evaluation
instances, `workflow.run_evaluation`, `fake_workflow`, the recommendation
template's `read_eval` and `PrecisionAtK`, and `python -m
predictionio_tpu_torch eval`) vs the JAX reference, on the CPU.

Mirrors tests/test_evaluation.py (metrics, MetricEvaluator, the
FastEvalEngine counters, equality with the plain engine) and
tests/test_eval_cli.py, with this file's own fixture components and
Evaluation classes (named by dotted path, `tests.test_torch_eval.*`).
Every comparison is exact: the metrics, the folds, the evaluator's choice
and `best.json` are equal to the reference's, and the recommendation
sweep's PrecisionAtK equals the reference's on one store (small tables at
lam 0.1, whose top-10s hold no near-tie the two packages' f32 rounding
could flip; the test asserts as much by comparing the answers first).
"""

import json
import math
import os
import pathlib
import subprocess
import sys
from dataclasses import dataclass

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.core import Engine as JEngine
from predictionio_tpu.core import FastEvalEngine as JFastEvalEngine
from predictionio_tpu.core import MetricEvaluator as JMetricEvaluator
from predictionio_tpu.core import metrics as JM
from predictionio_tpu.core.cross_validation import split_data as j_split
from predictionio_tpu.data.storage import registry as JReg
from predictionio_tpu.models import recommendation as JR
from predictionio_tpu_torch.core import (AverageMetric, DataSource, Engine,
                                         EngineParams, EngineParamsGenerator,
                                         Evaluation, FastEvalEngine,
                                         MetricEvaluator, OptionAverageMetric,
                                         Params, Preparator, Serving,
                                         StdevMetric, SumMetric, ZeroMetric)
from predictionio_tpu_torch.core.base import Algorithm
from predictionio_tpu_torch.core.cross_validation import split_data
from predictionio_tpu_torch.data.columnar import ColumnarBatch
from predictionio_tpu_torch.data.storage import registry as TReg
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.storage.base import \
    EvaluationInstance as TInstance
from predictionio_tpu_torch.models import classification as TC
from predictionio_tpu_torch.models import recommendation as TR
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import (WorkflowConfig,
                                             create_workflow_main,
                                             run_evaluation)
from predictionio_tpu_torch.workflow.fake_workflow import run_fake
from tests import sample_engine as JS

REPO = pathlib.Path(__file__).resolve().parent.parent


# -- the port's fixture components (tests/sample_engine.py's on the port) --

@dataclass(frozen=True)
class DSParams(Params):
    id: int = 0
    error: bool = False
    n_eval_sets: int = 0


class DataSource0(DataSource):
    PARAMS_CLASS = DSParams

    def __init__(self, params=None):
        super().__init__(params or DSParams())

    def read_training(self):
        return JS.TrainingData(self.params.id)

    def read_eval(self):
        return [(JS.TrainingData(self.params.id), JS.EvalInfo(self.params.id),
                 [(JS.Query(q), JS.Actual(q)) for q in range(3)])
                for _ in range(self.params.n_eval_sets)]


@dataclass(frozen=True)
class PParams(Params):
    id: int = 0


class Preparator0(Preparator):
    PARAMS_CLASS = PParams

    def __init__(self, params=None):
        super().__init__(params or PParams())

    def prepare(self, td):
        return JS.ProcessedData(self.params.id, td)


@dataclass(frozen=True)
class AParams(Params):
    id: int = 0


class Algo0(Algorithm):
    PARAMS_CLASS = AParams

    def __init__(self, params=None):
        super().__init__(params or AParams())

    def train(self, pd):
        return JS.AModel(self.params.id, pd)

    def predict(self, model, query):
        return JS.Prediction(self.params.id, query, models=model)


@dataclass(frozen=True)
class SParams(Params):
    id: int = 0


class Serving0(Serving):
    PARAMS_CLASS = SParams

    def __init__(self, params=None):
        super().__init__(params or SParams())

    def supplement(self, query):
        return JS.Query(query.id, supplemented=True)

    def serve(self, query, predictions):
        return predictions[0]


class QidMetric(AverageMetric):
    def calculate_one(self, q, p, a):
        return float(q.id)


class PredictionIdMetric(AverageMetric):
    def calculate_one(self, q, p, a):
        return float(p.id)


class JPredictionIdMetric(JM.AverageMetric):
    def header(self):
        return "PredictionIdMetric"

    def calculate_one(self, q, p, a):
        return float(p.id)


class OptMetric(OptionAverageMetric):
    def calculate_one(self, q, p, a):
        return float(q.id) if q.id > 0 else None


def eval_data(vals):
    qpa = [(JS.Query(v), JS.Prediction(v, JS.Query(v)), JS.Actual(v))
           for v in vals]
    return [(JS.EvalInfo(0), qpa)]


def port_params(algo_id, ds_id=1):
    return EngineParams(
        data_source_params=("", DSParams(id=ds_id, n_eval_sets=2)),
        preparator_params=("", PParams(id=2)),
        algorithm_params_list=[("algo", AParams(id=algo_id))],
        serving_params=("", SParams()))


def ref_params(algo_id):
    from predictionio_tpu.core import EngineParams as JEngineParams
    return JEngineParams(
        data_source_params=("", JS.DSParams(id=1, n_eval_sets=2)),
        preparator_params=("", JS.PParams(id=2)),
        algorithm_params_list=[("algo", JS.AParams(id=algo_id))],
        serving_params=("", JS.SParams()))


def port_engine(cls=Engine):
    return cls({"": DataSource0}, {"": Preparator0}, {"algo": Algo0},
               {"": Serving0})


def ref_engine(cls=JEngine):
    return cls({"": JS.DataSource0}, {"": JS.Preparator0},
               {"algo": JS.Algo0}, {"": JS.Serving0})


# -- metrics -----------------------------------------------------------------

class JQid(JM.AverageMetric):
    def calculate_one(self, q, p, a):
        return float(q.id)


class JOpt(JM.OptionAverageMetric):
    def calculate_one(self, q, p, a):
        return float(q.id) if q.id > 0 else None


class TStdev(StdevMetric):
    def calculate_one(self, q, p, a):
        return float(q.id)


class JStdev(JM.StdevMetric):
    def calculate_one(self, q, p, a):
        return float(q.id)


class TSum(SumMetric):
    def calculate_one(self, q, p, a):
        return float(q.id)


class JSum(JM.SumMetric):
    def calculate_one(self, q, p, a):
        return float(q.id)


@pytest.mark.parametrize("port,ref,vals,want", [
    (QidMetric, JQid, [1, 2, 3], 2.0),
    (OptMetric, JOpt, [0, 2, 4], 3.0),
    (TStdev, JStdev, [2, 2, 2], 0.0),
    (TStdev, JStdev, [1, 3], 1.0),
    (TSum, JSum, [1, 2, 3], 6.0),
    (ZeroMetric, JM.ZeroMetric, [1], 0.0)])
def test_metric_values(port, ref, vals, want):
    got = port().calculate(eval_data(vals))
    assert got == want == ref().calculate(eval_data(vals))


@pytest.mark.parametrize("port,ref", [(QidMetric, JQid), (OptMetric, JOpt),
                                      (TStdev, JStdev)])
def test_metric_of_nothing_is_nan(port, ref):
    assert math.isnan(port().calculate(eval_data([])))
    assert math.isnan(ref().calculate(eval_data([])))


def test_compare_nan_loses():
    m, j = QidMetric(), JQid()
    for a, b in ((float("nan"), 1.0), (1.0, float("nan")), (2.0, 1.0),
                 (1.0, 1.0), (float("nan"), float("nan"))):
        assert m.compare(a, b) == j.compare(a, b)
    assert m.compare(float("nan"), 1.0) < 0
    assert m.compare(1.0, float("nan")) > 0
    assert m.header() == "QidMetric"


def test_split_data_matches_the_reference():
    data = list(range(11))
    kw = dict(training_data_creator=tuple, query_creator=lambda d: -d,
              actual_creator=lambda d: d * 10)
    assert split_data(3, data, "ei", **kw) == j_split(3, data, "ei", **kw)


# -- the evaluator and the engines --------------------------------------------

def test_metric_evaluator_picks_best_and_writes_the_reference_best_json(
        tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    result = MetricEvaluator(PredictionIdMetric(),
                             output_path=str(port_dir)).evaluate_base(
        port_engine(), [port_params(1), port_params(5), port_params(3)])
    ref = JMetricEvaluator(JPredictionIdMetric(),
                           output_path=str(ref_dir)).evaluate_base(
        ref_engine(), [ref_params(1), ref_params(5), ref_params(3)])
    assert result.best_idx == ref.best_idx == 1
    assert result.best_score.score == ref.best_score.score == 5.0
    assert result.best_engine_params.algorithm_params_list[0][1].id == 5
    assert result.one_liner() == ref.one_liner()
    assert json.loads(result.to_json(port_engine())) == \
        json.loads(ref.to_json(ref_engine()))
    assert "<html>" in result.to_html()
    assert json.loads((port_dir / "best.json").read_text()) == \
        json.loads((ref_dir / "best.json").read_text())


def test_fast_eval_stage_cache_hit_counts():
    engine = port_engine(FastEvalEngine)
    out = engine.batch_eval([port_params(i) for i in (1, 2, 3)])
    assert len(out) == 3
    assert engine.counters == {"dataSource": 1, "preparator": 1,
                               "algorithms": 3, "serving": 3}


def test_fast_eval_datasource_change_invalidates_prefix():
    engine = port_engine(FastEvalEngine)
    a, b = port_params(1), port_params(1, ds_id=99)
    engine.batch_eval([a, b, a])
    assert engine.counters["dataSource"] == 2
    assert engine.counters["preparator"] == 2
    assert engine.counters["algorithms"] == 2
    engine.clear()
    engine.eval(a)
    assert engine.counters["dataSource"] == 3


@pytest.mark.parametrize("fast", [False, True])
def test_eval_matches_the_plain_engine_and_the_reference(fast):
    ep = port_params(7)
    got = port_engine(FastEvalEngine if fast else Engine).eval(ep)
    plain = port_engine().eval(ep)
    ref = ref_engine(JFastEvalEngine if fast else JEngine).eval(
        ref_params(7))

    def ids(out, supplemented=False):
        return [(ei, [(q.id, p.id, a.id) + ((p.q.supplemented,)
                                            if supplemented else ())
                      for q, p, a in qpa]) for ei, qpa in out]
    assert ids(got) == ids(plain) == ids(ref)
    # as the reference's: the plain engine hands supplemented queries to
    # the algorithms and the unsupplemented one to serve and the result;
    # the FastEvalEngine's algorithms see the query as it is
    assert ids(got, True) == ids(ref, True)
    assert all(p.q.supplemented != fast and not q.supplemented
               for _, qpa in got for q, p, _ in qpa)


def test_run_evaluation_records_the_results_and_aborts_on_failure(tmp_env):
    TReg.clear_cache()

    class Ev(Evaluation):
        engine = port_engine()
        metric = PredictionIdMetric()

    iid = run_evaluation(Ev.engine, Ev(), [port_params(1), port_params(4)],
                         evaluation_class="Ev", output_path=str(tmp_env))
    dao = TReg.Storage.get_meta_data_evaluation_instances()
    inst = dao.get(iid)
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluator_results.startswith("[PredictionIdMetric] best: "
                                             "4.000000")
    assert json.loads(inst.evaluator_results_json)["bestIndex"] == 1
    assert inst.evaluator_results_html.startswith("<html>")

    class Broken(Evaluation):
        engine = port_engine()
        metric = None
    with pytest.raises(ValueError, match="metric"):
        run_evaluation(Broken.engine, Broken(), [port_params(1)])
    statuses = sorted(i.status for i in dao.get_all())
    assert statuses == ["ABORTED", "EVALCOMPLETED"]
    assert [i.id for i in dao.get_completed()] == [iid]
    TReg.clear_cache()


def test_run_fake_calls_fn_with_the_device(tmp_env):
    TReg.clear_cache()
    seen = []
    iid = run_fake(seen.append, device="cpu")
    assert seen == [torch.device("cpu")]
    inst = TReg.Storage.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluation_class == "FakeRun"
    TReg.clear_cache()


# -- the evaluation instances on one store -----------------------------------

def test_evaluation_instances_round_trip_between_packages(tmp_env):
    TReg.clear_cache()
    JReg.clear_cache()
    dao = TReg.Storage.get_meta_data_evaluation_instances()
    iid = dao.insert(TInstance(status="EVALCOMPLETED", evaluation_class="x",
                               env={"PIO_A": "1"}, evaluator_results="r",
                               evaluator_results_json="{}"))
    (ref,) = JReg.Storage.get_meta_data_evaluation_instances().get_completed()
    assert ref.id == iid and ref.env == {"PIO_A": "1"}
    assert ref.evaluator_results == "r"
    inst = dao.get(iid)
    assert dao.update(inst.with_(status="ABORTED"))
    assert dao.get_completed() == []
    assert dao.delete(iid) and dao.get(iid) is None
    TReg.clear_cache()
    JReg.clear_cache()


# -- the classification sweep through the CLI (tests/test_eval_cli.py) -------

CLS_APP = "evalapp"


def cls_params(lam):
    return EngineParams(
        data_source_params=("", TC.DataSourceParams(app_name=CLS_APP,
                                                    eval_k=3)),
        preparator_params=("", None),
        algorithm_params_list=[("naive", TC.NaiveBayesAlgorithmParams(
            lam=lam, device="cpu"))],
        serving_params=("", None))


class AccuracyEvaluation(Evaluation):
    def __init__(self):
        self.engine = TC.ClassificationEngineFactory.apply()
        self.metric = TC.Accuracy()


class LambdaSweep(EngineParamsGenerator):
    engine_params_list = [cls_params(0.1), cls_params(1.0),
                          cls_params(10.0)]


@pytest.fixture()
def eval_app(tmp_env):
    """tests/test_eval_cli.py's separable 36 users, written by the port."""
    TReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, CLS_APP))
    rng = np.random.default_rng(0)
    props = []
    for j in range(36):
        label = float(j % 2)
        base = [9.0, 1.0, 1.0] if label == 0 else [1.0, 1.0, 9.0]
        props.append({"plan": label,
                      "attr0": base[0] + float(rng.integers(0, 2)),
                      "attr1": base[1], "attr2": base[2]})
    TReg.Storage.get_events().insert_columnar(ColumnarBatch(
        36, "$set", "user", [f"u{j}" for j in range(36)],
        properties=props), app_id)
    yield tmp_env
    TReg.clear_cache()


def test_eval_cli(eval_app, capsys):
    rc = cli.main(["eval", "tests.test_torch_eval.AccuracyEvaluation",
                   "tests.test_torch_eval.LambdaSweep",
                   "--output-path", str(eval_app / "out")])
    assert rc == 0
    assert "Evaluation completed. Evaluation instance ID: " in \
        capsys.readouterr().out
    completed = TReg.Storage.get_meta_data_evaluation_instances(
    ).get_completed()
    assert len(completed) == 1
    inst = completed[0]
    assert inst.evaluation_class == "tests.test_torch_eval.AccuracyEvaluation"
    assert inst.engine_params_generator_class == \
        "tests.test_torch_eval.LambdaSweep"
    assert "Accuracy" in inst.evaluator_results
    parsed = json.loads(inst.evaluator_results_json)
    assert len(parsed["scores"]) == 3
    assert parsed["bestScore"] > 0.9  # separable data
    best = json.loads((eval_app / "out" / "best.json").read_text())
    assert best["algorithms"][0]["name"] == "naive"
    assert best["algorithms"][0]["params"]["lam"] == \
        [0.1, 1.0, 10.0][parsed["bestIndex"]]


def test_eval_without_generator_requires_own_list(eval_app):
    with pytest.raises(ValueError, match="engine_params_list"):
        cli.main(["eval", "tests.test_torch_eval.AccuracyEvaluation"])


@pytest.mark.parametrize("field", ["skip_sanity_check", "stop_after_read",
                                   "stop_after_prepare"])
def test_eval_refuses_the_train_only_workflow_fields(eval_app, field):
    """An evaluation runs its whole sweep, so a field that would stop or
    skip part of a train is refused, before any instance is recorded."""
    with pytest.raises(ValueError, match=field):
        create_workflow_main(WorkflowConfig(
            evaluation_class="tests.test_torch_eval.AccuracyEvaluation",
            engine_params_generator_class="tests.test_torch_eval.LambdaSweep",
            **{field: True}))
    assert TReg.Storage.get_meta_data_evaluation_instances().get_all() == []


def test_eval_cli_in_a_subprocess_is_read_by_a_reference_process(eval_app):
    out = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch", "eval",
         "tests.test_torch_eval.AccuracyEvaluation",
         "tests.test_torch_eval.LambdaSweep", "--output-path",
         str(eval_app / "out")], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    iid = out.stdout.strip().splitlines()[-1].rsplit(" ", 1)[-1]
    read = subprocess.run(
        [sys.executable, "-c",
         "import json, sys\n"
         "from predictionio_tpu.data.storage import Storage\n"
         "i = Storage.get_meta_data_evaluation_instances().get(sys.argv[1])\n"
         "print(json.dumps([i.status, i.evaluation_class,\n"
         "                  json.loads(i.evaluator_results_json)]))", iid],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert read.returncode == 0, read.stderr
    status, cls, results = json.loads(read.stdout.strip().splitlines()[-1])
    assert status == "EVALCOMPLETED"
    assert cls == "tests.test_torch_eval.AccuracyEvaluation"
    assert len(results["scores"]) == 3


# -- the recommendation template's evaluation ---------------------------------

REC_APP = "recevalapp"


@pytest.fixture()
def rec_store(tmp_env):
    """One store, written by the port, that both packages read."""
    TReg.clear_cache()
    JReg.clear_cache()
    app_id = TReg.Storage.get_meta_data_apps().insert(App(0, REC_APP))
    rng = np.random.default_rng(21)
    n = 900
    TReg.Storage.get_events().insert_columnar(ColumnarBatch(
        n, "rate", "user", [f"u{x}" for x in rng.integers(0, 40, n)],
        "item", [f"i{x}" for x in rng.integers(0, 30, n)],
        [{"rating": float(x)} for x in rng.integers(1, 6, n)],
        ["1970-01-01T00:00:%02d.%03dZ" % divmod(k, 1000)
         for k in range(n)]), app_id)
    yield tmp_env
    TReg.clear_cache()
    JReg.clear_cache()


def test_recommendation_read_eval_folds_equal_the_reference(rec_store):
    kw = dict(app_name=REC_APP, eval_k=3, eval_query_num=7)
    got = TR.RecommendationDataSource(TR.DataSourceParams(**kw)).read_eval()
    ref = JR.RecommendationDataSource(JR.DataSourceParams(**kw)).read_eval()
    assert len(got) == len(ref) == 3
    for (td, ei, qa), (jtd, jei, jqa) in zip(got, ref):
        assert ei is None and jei is None
        for f in ("users", "items", "vals", "ts"):
            assert np.array_equal(getattr(td.ratings, f),
                                  getattr(jtd.ratings, f))
        assert [(q.user, q.num) for q, _ in qa] == \
            [(q.user, q.num) for q, _ in jqa]
        assert [tuple(map(tuple, a.ratings)) for _, a in qa] == \
            [tuple(map(tuple, a.ratings)) for _, a in jqa]
    assert TR.RecommendationDataSource(
        TR.DataSourceParams(app_name=REC_APP)).read_eval() == []


def rec_sweep(pkg, R, lams):
    algo = dict(rank=6, num_iterations=4, seed=3)
    extra = {"device": "cpu"} if pkg == "port" else {}
    return [pkg_params(R, lam, algo, extra) for lam in lams]


def pkg_params(R, lam, algo, extra):
    from predictionio_tpu.core import EngineParams as JEngineParams
    ep_cls = EngineParams if R is TR else JEngineParams
    return ep_cls(
        data_source_params=("", R.DataSourceParams(app_name=REC_APP,
                                                   eval_k=2,
                                                   eval_query_num=10)),
        preparator_params=("", R.PreparatorParams()),
        algorithm_params_list=[("als", R.ALSAlgorithmParams(
            lam=lam, **algo, **extra))],
        serving_params=("", None))


def test_precision_at_k_and_best_json_equal_the_reference(rec_store,
                                                          tmp_path):
    lams = (0.1, 0.5)
    port_engine_ = FastEvalEngine(
        {"": TR.RecommendationDataSource}, {"": TR.RecommendationPreparator},
        {"als": TR.ALSAlgorithm}, {"": TR.FirstServing})
    ref_engine_ = JFastEvalEngine(
        {"": JR.RecommendationDataSource}, {"": JR.RecommendationPreparator},
        {"als": JR.ALSAlgorithm}, {"": JR.FirstServing})
    got = port_engine_.batch_eval(rec_sweep("port", TR, lams))
    ref = ref_engine_.batch_eval(rec_sweep("ref", JR, lams))
    assert port_engine_.counters["dataSource"] == 1
    for (_, g), (_, r) in zip(got, ref):
        for (_, gq), (_, rq) in zip(g, r):
            assert [[s.item for s in p.item_scores] for _, p, _ in gq] == \
                [[s.item for s in p.item_scores] for _, p, _ in rq]
    metric, jmetric = TR.PrecisionAtK(k=10), JR.PrecisionAtK(k=10)
    assert metric.header() == jmetric.header()
    for (_, g), (_, r) in zip(got, ref):
        assert metric.calculate(g) == jmetric.calculate(r) == \
            jmetric.calculate(g)
    res = MetricEvaluator(metric, output_path=str(tmp_path / "p")
                          ).evaluate_base(port_engine_,
                                          rec_sweep("port", TR, lams))
    jres = JMetricEvaluator(jmetric, output_path=str(tmp_path / "r")
                            ).evaluate_base(ref_engine_,
                                            rec_sweep("ref", JR, lams))
    assert res.best_idx == jres.best_idx
    assert [s.score for _, s in res.engine_params_scores] == \
        [s.score for _, s in jres.engine_params_scores]
    port_best = json.loads((tmp_path / "p" / "best.json").read_text())
    ref_best = json.loads((tmp_path / "r" / "best.json").read_text())
    # the port's params add `device`, `solver` and the store-free
    # `ratings`; the reference's `factor_sharding` and `stream` belong to
    # planes the port has not taken yet (ROADMAP.md A5, A8)
    for block, port_only, ref_only in (
            (lambda b: b["algorithms"][0]["params"], ("device", "solver"),
             ("factor_sharding",)),
            (lambda b: b["datasource"]["params"], ("ratings",),
             ("stream",))):
        for k in port_only:
            block(port_best).pop(k)
        for k in ref_only:
            block(ref_best).pop(k)
    assert port_best == ref_best


def test_precision_at_k_matches_the_reference_on_edge_cases():
    from predictionio_tpu.models.common import ItemScore, ItemScoreResult
    R = JR.Rating
    items = [ItemScore(f"i{k}", 1.0 - k / 10) for k in range(5)]
    cases = [
        (ItemScoreResult(tuple(items)),
         JR.ActualResult((R("u", "i1", 4.0), R("u", "i9", 1.0)))),
        (ItemScoreResult(()), JR.ActualResult((R("u", "i1", 5.0),))),
        (ItemScoreResult(tuple(items)),
         JR.ActualResult((R("u", "i1", 1.0),)))]     # no positive: skipped
    data = [(None, [(None, p, a) for p, a in cases])]
    for k, thr in ((10, 2.0), (2, 4.0), (3, 5.0)):
        assert TR.PrecisionAtK(k, thr).calculate(data) == \
            JR.PrecisionAtK(k, thr).calculate(data)
    assert math.isnan(TR.PrecisionAtK().calculate([(None, [])]))


def test_workflow_evaluation_writes_best_json(rec_store):
    out = rec_store / "best"
    iid = create_workflow_main(WorkflowConfig(
        evaluation_class="tests.test_torch_eval.RecEvaluation",
        engine_params_generator_class="tests.test_torch_eval.RecSweep",
        output_path=str(out)))
    inst = TReg.Storage.get_meta_data_evaluation_instances().get(iid)
    assert inst.status == "EVALCOMPLETED"
    assert inst.evaluator_results.startswith("[PrecisionAtK(k=10, "
                                             "threshold=2.0)] best: ")
    assert len(json.loads(inst.evaluator_results_json)["scores"]) == 2
    assert json.loads((out / "best.json").read_text())["algorithms"][0][
        "name"] == "als"


class RecEvaluation(Evaluation):
    def __init__(self):
        self.engine = FastEvalEngine(
            {"": TR.RecommendationDataSource},
            {"": TR.RecommendationPreparator}, {"als": TR.ALSAlgorithm},
            {"": TR.FirstServing})
        self.metric = TR.PrecisionAtK(k=10, rating_threshold=2.0)


class RecSweep(EngineParamsGenerator):
    engine_params_list = rec_sweep("port", TR, (0.1, 0.5))
