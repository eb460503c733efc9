"""Engine-facing event access, keyed by app name."""

from predictionio_tpu_torch.data.store.event_store import (EventStore,
                                                           LEventStore,
                                                           PEventStore)

__all__ = ["EventStore", "LEventStore", "PEventStore"]
