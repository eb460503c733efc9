"""Workflow entry point: engine.json variant -> train run.

The port's counterpart of `predictionio_tpu/workflow/create_workflow.py`
(the reference's CreateWorkflow main, CreateWorkflow.scala:40-266):
read the engine variant JSON, resolve its engine factory through the
port's registry (`models.get_engine_factory`), extract the EngineParams
and run the train in this process (`run_train`). This is what `pio train`
calls. Evaluation runs are a later slice.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

from predictionio_tpu_torch.models import get_engine_factory
from predictionio_tpu_torch.workflow.core_workflow import run_train


@dataclass
class WorkflowConfig:
    """(CreateWorkflow.scala:40-58); the CLI's other options come with
    the CLI."""
    engine_variant: str = "engine.json"


def load_variant(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def create_workflow_main(config: WorkflowConfig,
                         telemetry: Optional[dict] = None) -> str:
    """Train the variant `config.engine_variant` names and persist it;
    returns the engine instance id. `telemetry` as `run_train`'s."""
    variant = load_variant(config.engine_variant)
    factory_name = variant.get("engineFactory")
    if not factory_name:
        raise ValueError(f"{config.engine_variant} names no engineFactory")
    engine = get_engine_factory(factory_name).apply()
    return run_train(
        engine, engine.json_to_engine_params(variant),
        engine_id=variant.get("id", "default"),
        engine_variant=config.engine_variant,
        engine_factory=factory_name,
        env={k: v for k, v in os.environ.items() if k.startswith("PIO_")},
        telemetry=telemetry)
