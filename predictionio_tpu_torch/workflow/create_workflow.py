"""Workflow entry point: engine.json variant -> train run, or an
evaluation class -> evaluation run.

The port's counterpart of `predictionio_tpu/workflow/create_workflow.py`
(the reference's CreateWorkflow main, CreateWorkflow.scala:40-266).
Train: read the engine variant JSON, resolve its engine factory through
the port's registry (`models.get_engine_factory`), extract the
EngineParams and run the train in this process (`run_train`). Evaluation
(`evaluation_class` set): resolve the Evaluation and the params generator
by dotted path, and run the sweep (`run_evaluation`). This is what
`python -m predictionio_tpu_torch train` and `eval` call (`tools/cli.py`).
"""

from __future__ import annotations

import importlib
import json
import logging
import os
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.workflow.core_workflow import (run_evaluation,
                                                           run_train)

logger = logging.getLogger(__name__)


@dataclass
class WorkflowConfig:
    """What `pio train` passes (CreateWorkflow.scala:40-58)."""
    batch: str = ""
    engine_id: str = "default"   # the variant's "id" wins when it has one
    engine_version: str = "0"
    engine_variant: str = "engine.json"
    engine_factory: Optional[str] = None   # overrides the variant's
    evaluation_class: Optional[str] = None   # dotted path: an eval run
    engine_params_generator_class: Optional[str] = None
    output_path: Optional[str] = None   # where an eval writes best.json
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    verbose: bool = False        # log the extracted engine params


def load_variant(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve_class(dotted: str):
    module_name, _, attr = dotted.rpartition(".")
    if not module_name:
        raise ValueError(f"not a dotted class path: {dotted!r}")
    return getattr(importlib.import_module(module_name), attr)


def create_workflow_main(config: WorkflowConfig,
                         telemetry: Optional[dict] = None) -> str:
    """Train the variant `config.engine_variant` names and persist it, or
    with `config.evaluation_class` run that evaluation; returns the
    engine or evaluation instance id. `telemetry` (a train's) as
    `run_train`'s."""
    if config.evaluation_class:
        return _run_evaluation(config)
    variant = load_variant(config.engine_variant)
    factory_name = config.engine_factory or variant.get("engineFactory")
    if not factory_name:
        raise ValueError(f"{config.engine_variant} names no engineFactory; "
                         "give one with --engine-factory")
    engine = get_engine_factory(factory_name).apply()
    engine_params = engine.json_to_engine_params(variant)
    if config.verbose:
        logger.info("Engine params of %s: %s", config.engine_variant,
                    json.dumps(engine.engine_params_to_json(engine_params),
                               default=repr))
    return run_train(
        engine, engine_params,
        engine_id=variant.get("id", config.engine_id),
        engine_version=config.engine_version,
        engine_variant=config.engine_variant,
        engine_factory=factory_name,
        env={k: v for k, v in os.environ.items() if k.startswith("PIO_")},
        telemetry=telemetry, batch=config.batch,
        sanity_check=not config.skip_sanity_check,
        stop_after_read=config.stop_after_read,
        stop_after_prepare=config.stop_after_prepare)


def _run_evaluation(config: WorkflowConfig) -> str:
    train_only = [name for name in ("skip_sanity_check", "stop_after_read",
                                    "stop_after_prepare")
                  if getattr(config, name)]
    if train_only:
        raise ValueError(f"{', '.join(train_only)} applies to a train run, "
                         "not an evaluation")
    evaluation_cls = resolve_class(config.evaluation_class)
    evaluation = (evaluation_cls() if isinstance(evaluation_cls, type)
                  else evaluation_cls)
    engine = evaluation.engine
    if engine is None:
        raise ValueError(
            f"{config.evaluation_class} does not define .engine")
    if config.engine_params_generator_class:
        gen_cls = resolve_class(config.engine_params_generator_class)
        generator = gen_cls() if isinstance(gen_cls, type) else gen_cls
    else:
        generator = evaluation  # an Evaluation may carry its own list
    params_list = list(getattr(generator, "engine_params_list", ()))
    if not params_list:
        raise ValueError("engine_params_list is empty")
    return run_evaluation(
        engine, evaluation, params_list,
        evaluation_class=config.evaluation_class or "",
        engine_params_generator_class=(
            config.engine_params_generator_class or ""),
        env={k: v for k, v in os.environ.items() if k.startswith("PIO_")},
        output_path=config.output_path, batch=config.batch)
