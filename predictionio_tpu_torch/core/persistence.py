"""Model persistence contracts: the three checkpoint modes.

The port's copy of `predictionio_tpu/core/persistence.py` (the
reference's PersistentModel.scala:64+, PersistentModelManifest.scala:18,
Engine.scala:208-230):

  1. automatic  the trained model object is serialized by the framework
                into the MODELDATA repository (pickle of host numpy: device
                tensors are copied to the host first, `utils/arrays.py`).
  2. manual     the model implements PersistentModel.save(); only a
                PersistentModelManifest naming its loader is stored, and
                the loader restores it at deploy.
  3. retrain    make_persistent_model returns RETRAIN; deploy re-runs
                read/prepare/train.
"""

from __future__ import annotations

import abc
import importlib
from dataclasses import dataclass
from typing import Any, Optional

#: the JAX package's root: a loader there is never imported by the port
REFERENCE_PACKAGE = "predictionio_tpu"


class _Retrain:
    """Sentinel: do not persist; re-train at deploy (the Unit-model case)."""

    _instance: Optional["_Retrain"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "RETRAIN"


RETRAIN = _Retrain()


@dataclass(frozen=True)
class PersistentModelManifest:
    """Stored in place of the model blob when the model persists itself
    (PersistentModelManifest.scala:18). `loader` is the fully-qualified
    name of a PersistentModelLoader subclass or of the model class itself
    (which must expose `load`)."""
    loader: str


class PersistentModel(abc.ABC):
    """Mix-in for models that manage their own storage
    (PersistentModel.scala:64)."""

    @abc.abstractmethod
    def save(self, instance_id: str, params: Any) -> bool:
        """Persist; return True to store only a manifest, False to fall
        back to automatic serialization."""

    @classmethod
    def loader_name(cls) -> str:
        return f"{cls.__module__}.{cls.__qualname__}"


class PersistentModelLoader(abc.ABC):
    """Restores a PersistentModel at deploy time."""

    @abc.abstractmethod
    def load(self, instance_id: str, params: Any) -> Any: ...


def resolve_loader(qualname: str):
    """Import the loader named by a manifest (WorkflowUtils.scala:350
    getPersistentModel). A loader of the JAX package is refused."""
    module_name, _, attr = qualname.rpartition(".")
    if module_name.split(".")[0] == REFERENCE_PACKAGE:
        raise ValueError(f"model loader {qualname!r} belongs to the JAX "
                         "package; predictionio_tpu_torch cannot load it")
    return getattr(importlib.import_module(module_name), attr)


def load_persistent_model(manifest: PersistentModelManifest,
                          instance_id: str, params: Any):
    loader = resolve_loader(manifest.loader)
    if isinstance(loader, type) and issubclass(loader, PersistentModelLoader):
        return loader().load(instance_id, params)
    load = getattr(loader, "load", None)
    if load is None:
        raise TypeError(f"{manifest.loader} has no load()")
    return load(instance_id, params)
