"""Online model updates: fresh events into a deployed model, no retrain.

The port's counterpart of `predictionio_tpu/online/`:

- `fold_in`: batched one-sided solves of only the user and item rows the
  fresh events touched, through the training's solve path (on the card,
  `csrc/cg_solve.cu`);
- `scheduler`: tails the event store, folds on a count or staleness
  threshold, gates the result and publishes it, asking for a retrain
  when the fold's loss drifts;
- `registry`: publishes a folded model as a new COMPLETED engine
  instance, which `/reload` picks up; pins the last-good version and
  rolls back to it.
"""

from predictionio_tpu_torch.online.fold_in import (FoldInConfig, FoldInStats,
                                                   fold_in_coo, solve_rows)
from predictionio_tpu_torch.online.registry import (ONLINE_BATCH_TAG,
                                                    ROLLEDBACK_STATUS,
                                                    ModelVersionRegistry)
from predictionio_tpu_torch.online.scheduler import (DeltaTrainingScheduler,
                                                     EntityDelta,
                                                     SchedulerConfig,
                                                     attach_scheduler)

__all__ = [
    "FoldInConfig", "FoldInStats", "fold_in_coo", "solve_rows",
    "ModelVersionRegistry", "ONLINE_BATCH_TAG", "ROLLEDBACK_STATUS",
    "DeltaTrainingScheduler", "EntityDelta", "SchedulerConfig",
    "attach_scheduler",
]
