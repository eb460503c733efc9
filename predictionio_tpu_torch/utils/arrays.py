"""Device -> host conversion of trained models before they are pickled.

The port's counterpart of `predictionio_tpu/utils/arrays.py` (the
serialization analog of the reference's Kryo step, CoreWorkflow.scala
:74-79): every tensor becomes a numpy array, so a persisted blob holds
host numpy only and unpickles on a machine without a card. The device a
model was trained on is not stored: a `torch.device` becomes None, and a
dataclass field whose name starts with `_` (a device-side cache, such as
`ALSModel._tables`) is dropped to None. At deploy the serving algorithm
puts the model on its own device (`Algorithm.place_model`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def to_host(obj: Any) -> Any:
    """Recursively convert tensors to numpy and drop device state.
    Handles dataclasses, dicts, lists and tuples (incl. namedtuples) and
    leaves everything else."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, torch.device):
        return None
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        if hasattr(obj, "_fields"):  # namedtuple
            return type(obj)(*(to_host(v) for v in obj))
        return tuple(to_host(v) for v in obj)
    if isinstance(obj, list):
        return [to_host(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: (None if f.name.startswith("_")
                     else to_host(getattr(obj, f.name)))
            for f in dataclasses.fields(obj) if f.init})
    return obj
