"""Workflow runtime: engine.json -> train -> persisted engine instance,
and evaluation class -> evaluation run -> evaluation instance."""

from predictionio_tpu_torch.workflow.core_workflow import (run_evaluation,
                                                           run_train)
from predictionio_tpu_torch.workflow.create_workflow import (
    WorkflowConfig, create_workflow_main)

__all__ = ["run_evaluation", "run_train", "WorkflowConfig",
           "create_workflow_main"]
