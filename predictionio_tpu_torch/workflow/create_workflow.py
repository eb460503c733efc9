"""Workflow entry point: engine.json variant -> train run.

The port's counterpart of `predictionio_tpu/workflow/create_workflow.py`
(the reference's CreateWorkflow main, CreateWorkflow.scala:40-266):
read the engine variant JSON, resolve its engine factory through the
port's registry (`models.get_engine_factory`), extract the EngineParams
and run the train in this process (`run_train`). This is what `python -m
predictionio_tpu_torch train` calls (`tools/cli.py`). Evaluation runs are
a later slice.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.workflow.core_workflow import run_train

logger = logging.getLogger(__name__)


@dataclass
class WorkflowConfig:
    """What `pio train` passes (CreateWorkflow.scala:40-58)."""
    batch: str = ""
    engine_id: str = "default"   # the variant's "id" wins when it has one
    engine_version: str = "0"
    engine_variant: str = "engine.json"
    engine_factory: Optional[str] = None   # overrides the variant's
    skip_sanity_check: bool = False
    stop_after_read: bool = False
    stop_after_prepare: bool = False
    verbose: bool = False        # log the extracted engine params


def load_variant(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def create_workflow_main(config: WorkflowConfig,
                         telemetry: Optional[dict] = None) -> str:
    """Train the variant `config.engine_variant` names and persist it;
    returns the engine instance id. `telemetry` as `run_train`'s."""
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
