"""Event collection over REST (the reference's layer L1)."""

from predictionio_tpu_torch.data.api.event_server import (EventServer,
                                                          EventServerConfig)

__all__ = ["EventServer", "EventServerConfig"]
