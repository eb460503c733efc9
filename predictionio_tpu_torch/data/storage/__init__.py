"""Storage layer: the env-driven backend registry, metadata DAOs and the
event store (the port's copy of `predictionio_tpu/data/storage`, with the
sqlite, localfs, memory, remotefs, nativelog and eventserver backends)."""

from predictionio_tpu_torch.data.storage.base import (AccessKey, App,
                                                      Channel,
                                                      EngineInstance, Model)
from predictionio_tpu_torch.data.storage import registry
from predictionio_tpu_torch.data.storage.registry import Storage

__all__ = ["AccessKey", "App", "Channel", "EngineInstance", "Model", "Storage",
           "registry"]
