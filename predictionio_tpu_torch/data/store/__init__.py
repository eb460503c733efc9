"""Engine-facing event access, keyed by app name."""

from predictionio_tpu_torch.data.store.event_store import (EventStore,
                                                           PEventStore)

__all__ = ["EventStore", "PEventStore"]
