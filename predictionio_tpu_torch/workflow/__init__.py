"""Training workflow runtime: engine.json -> train -> persisted engine
instance."""

from predictionio_tpu_torch.workflow.core_workflow import run_train
from predictionio_tpu_torch.workflow.create_workflow import (
    WorkflowConfig, create_workflow_main)

__all__ = ["run_train", "WorkflowConfig", "create_workflow_main"]
