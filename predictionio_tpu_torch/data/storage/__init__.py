"""Storage layer: the env-driven backend registry, metadata DAOs and the
event store (the port's copy of `predictionio_tpu/data/storage`, with the
sqlite, localfs, memory, remotefs, nativelog, eventserver, docindex, pgsql
and mysql backends and nativelog snapshots)."""

from predictionio_tpu_torch.data.storage.base import (AccessKey, App,
                                                      Channel,
                                                      EngineInstance,
                                                      EngineManifest,
                                                      EvaluationInstance,
                                                      Model)
from predictionio_tpu_torch.data.storage import registry
from predictionio_tpu_torch.data.storage.registry import Storage

__all__ = ["AccessKey", "App", "Channel", "EngineInstance", "EngineManifest",
           "EvaluationInstance", "Model", "Storage", "registry"]
