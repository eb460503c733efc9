"""Run any function through the evaluation plumbing.

The port's counterpart of `predictionio_tpu/workflow/fake_workflow.py`
(the reference's FakeWorkflow/FakeRun, FakeWorkflow.scala:93+): push a
`fn(device) -> None` through the whole evaluation lifecycle, evaluation
instance record included, without writing DASE components. `fn` gets
the `torch.device` the run was given, where the reference passes its
mesh.
"""

from __future__ import annotations

from typing import Callable

import torch

from predictionio_tpu_torch.core import (DataSource, Engine, EngineParams,
                                         Evaluation, FirstServing,
                                         IdentityPreparator, LAlgorithm,
                                         ZeroMetric)
from predictionio_tpu_torch.device import DeviceLike, resolve_device


class _FakeDataSource(DataSource):
    def read_training(self):
        return None

    def read_eval(self):
        return [(None, None, [(None, None)])]


class _FakeAlgorithm(LAlgorithm):
    fn: Callable[[torch.device], None] = staticmethod(lambda device: None)
    device: torch.device = torch.device("cpu")

    def train(self, pd):
        return None

    def predict(self, model, query):
        type(self).fn(type(self).device)
        return None


class FakeRun(Evaluation):
    """An Evaluation that runs `fn(device)` once (FakeWorkflow.scala
    FakeRun). `device`: None = the card, "cpu" only when asked."""

    def __init__(self, fn: Callable[[torch.device], None],
                 device: DeviceLike = None):
        algo_cls = type("_FakeAlgo", (_FakeAlgorithm,),
                        {"fn": staticmethod(fn),
                         "device": resolve_device(device)})
        self.engine = Engine({"": _FakeDataSource}, {"": IdentityPreparator},
                             {"": algo_cls}, {"": FirstServing})
        self.metric = ZeroMetric()
        self.engine_params_list = [EngineParams()]


def run_fake(fn: Callable[[torch.device], None],
             device: DeviceLike = None) -> str:
    """Run fn through the evaluation workflow; returns the
    EvaluationInstance id."""
    from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
    fake = FakeRun(fn, device)
    return run_evaluation(fake.engine, fake, fake.engine_params_list,
                          evaluation_class="FakeRun")
