"""The train and evaluation runs with their lifecycle records.

The port's counterpart of `predictionio_tpu/workflow/core_workflow.py`:
`run_train` (CoreWorkflow.runTrain, CoreWorkflow.scala:42-99):
EngineInstance INIT -> train -> serialize the models -> Models.insert ->
COMPLETED, or ABORTED when any step raises. The engine params are
recorded as JSON on the instance, which is how a server that did not
train restores them. `run_evaluation` (CoreWorkflow.runEvaluation):
EvaluationInstance INIT -> `MetricEvaluator.evaluate_base` ->
EVALCOMPLETED with the one-line, HTML and JSON results, or ABORTED.

A train runs under a `train` trace with the stage spans `train`,
`serialize` and `persist` (each also observed into the process-wide
`pio_train_stage_seconds{stage}`), between the `train_start` and
`train_end` flight records; an evaluation runs under an `evaluation`
trace with the `evaluate` stage.
"""

from __future__ import annotations

import contextlib
import datetime as _dt
import json
import logging
import time
from typing import Optional, Sequence

from predictionio_tpu_torch.core.engine import Engine, EngineParams
from predictionio_tpu_torch.core.evaluation import (Evaluation,
                                                    MetricEvaluator)
from predictionio_tpu_torch.data.storage.base import (EngineInstance,
                                                      EvaluationInstance,
                                                      Model)
from predictionio_tpu_torch.data.storage.registry import Storage
from predictionio_tpu_torch.obs import FLIGHT, TRACER, get_registry

logger = logging.getLogger(__name__)


def _now():
    return _dt.datetime.now(_dt.timezone.utc)


def _stage_hist():
    """Process-wide per-stage training timings, on every /metrics
    through the registry's parent chain."""
    return get_registry().histogram(
        "pio_train_stage_seconds",
        "Wall time of core-workflow stages, labeled by stage",
        buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0),
        labelnames=("stage",))


@contextlib.contextmanager
def _timed_stage(hist, stage: str):
    """One span and one histogram observation."""
    t0 = time.perf_counter()
    with TRACER.span(stage):
        yield
    hist.labels(stage=stage).observe(time.perf_counter() - t0)


def run_train(engine: Engine, engine_params: EngineParams,
              engine_id: str = "default", engine_version: str = "0",
              engine_variant: str = "default", engine_factory: str = "",
              env: Optional[dict] = None, telemetry: Optional[dict] = None,
              batch: str = "", sanity_check: bool = True,
              stop_after_read: bool = False,
              stop_after_prepare: bool = False) -> str:
    """Train and persist; returns the EngineInstance id.

    `telemetry`, when a dict, receives the stage wall times (read_s,
    prepare_s, train_s from `Engine.train`, then serialize_s, persist_s),
    `model_bytes` (the blob's size) and, under `algorithms`, each
    algorithm's own `last_train_telemetry` where it keeps one. `batch` is
    the instance's label; `sanity_check`, `stop_after_read` and
    `stop_after_prepare` go to `Engine.train` (a stopped train leaves the
    instance ABORTED and raises the interruption)."""
    instances = Storage.get_meta_data_engine_instances()
    # params with no JSON form (arrays handed to a data source) raise
    # here, before an instance is recorded
    ep_json = engine.engine_params_to_json(engine_params)
    instance = EngineInstance(
        id="", status="INIT", start_time=_now(), end_time=_now(),
        engine_id=engine_id, engine_version=engine_version,
        engine_variant=engine_variant, engine_factory=engine_factory,
        batch=batch, env=env or {},
        data_source_params=json.dumps(ep_json["datasource"]),
        preparator_params=json.dumps(ep_json["preparator"]),
        algorithms_params=json.dumps(ep_json["algorithms"]),
        serving_params=json.dumps(ep_json["serving"]))
    instance_id = instances.insert(instance)
    instance = instances.get(instance_id)
    tel = telemetry if telemetry is not None else {}
    hist = _stage_hist()
    FLIGHT.record("train_start", model_version=instance_id,
                  engine=engine_id)
    try:
        with TRACER.trace("train", instance=instance_id, engine=engine_id):
            with _timed_stage(hist, "train"):
                result = engine.train(
                    engine_params, sanity_check, tel,
                    stop_after_read=stop_after_read,
                    stop_after_prepare=stop_after_prepare)
            tel["algorithms"] = [getattr(a, "last_train_telemetry", {})
                                 for a in result.algorithms]
            t0 = time.perf_counter()
            with _timed_stage(hist, "serialize"):
                blob = engine.serialize_models(
                    engine.make_serializable_models(result, instance_id,
                                                    engine_params))
            tel["serialize_s"] = time.perf_counter() - t0
            tel["model_bytes"] = len(blob)
            t0 = time.perf_counter()
            with _timed_stage(hist, "persist"):
                Storage.get_model_data_models().insert(
                    Model(instance_id, blob))
            tel["persist_s"] = time.perf_counter() - t0
            instances.update(instance.with_(status="COMPLETED",
                                            end_time=_now()))
        FLIGHT.record("train_end", model_version=instance_id,
                      status="COMPLETED")
        logger.info("Training completed: engine instance %s", instance_id)
        return instance_id
    except Exception:
        logger.exception("Training failed: engine instance %s",
                         instance_id)
        FLIGHT.record("train_end", model_version=instance_id,
                      status="ABORTED")
        instances.update(instance.with_(status="ABORTED", end_time=_now()))
        raise


def run_evaluation(engine: Engine, evaluation: Evaluation,
                   engine_params_list: Sequence[EngineParams],
                   evaluation_class: str = "",
                   engine_params_generator_class: str = "",
                   env: Optional[dict] = None,
                   output_path: Optional[str] = None,
                   batch: str = "") -> str:
    """Evaluate a params sweep and record the results; returns the
    EvaluationInstance id. `output_path`: where `best.json` is written."""
    dao = Storage.get_meta_data_evaluation_instances()
    instance = EvaluationInstance(
        status="INIT", start_time=_now(), end_time=_now(),
        evaluation_class=evaluation_class,
        engine_params_generator_class=engine_params_generator_class,
        batch=batch, env=env or {})
    instance_id = dao.insert(instance)
    instance = dao.get(instance_id)
    try:
        if evaluation.metric is None:
            raise ValueError("Evaluation.metric must be set")
        evaluator = MetricEvaluator(evaluation.metric,
                                    list(evaluation.metrics),
                                    output_path=output_path)
        with TRACER.trace("evaluation", instance=instance_id), \
                _timed_stage(_stage_hist(), "evaluate"):
            result = evaluator.evaluate_base(engine, engine_params_list)
        dao.update(instance.with_(
            status="EVALCOMPLETED", end_time=_now(),
            evaluator_results=result.one_liner(),
            evaluator_results_html=result.to_html(),
            evaluator_results_json=result.to_json(engine)))
        logger.info("Evaluation completed: %s", result.one_liner())
        return instance_id
    except Exception:
        logger.exception("Evaluation failed: evaluation instance %s",
                         instance_id)
        dao.update(instance.with_(status="ABORTED", end_time=_now()))
        raise
