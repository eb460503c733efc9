"""The fault-tolerance layer: retries, circuit breakers, the durable
ingest spill and seeded chaos injection.

The port's counterpart of `predictionio_tpu/resilience/`:

- `policy`: `RetryPolicy` (exponential backoff with full jitter under a
  deadline) and `CircuitBreaker` (closed/open/half-open per backend, with
  its `pio_breaker_*` families, flight records and `breaker_open`
  incident).
- `spill`: `SpillWAL` and `SpillReplayer`, the event server's promise
  never to lose an acknowledged event while the store is down.
- `faults`: the `PIO_FAULTS` seeded chaos harness that wraps the storage
  backends and the fold's arrays.
"""

from predictionio_tpu_torch.resilience.policy import (  # noqa: F401
    TRANSIENT_ERRORS, CircuitBreaker, CircuitOpenError,
    RetryBudgetExceeded, RetryPolicy, TransientHTTPError,
    retry_after_hint)
from predictionio_tpu_torch.resilience.spill import (  # noqa: F401
    SpillReplayer, SpillWAL)
from predictionio_tpu_torch.resilience.faults import (  # noqa: F401
    FaultInjector, FaultSpec, FaultyEvents, InjectedFault,
    injector_from_env, maybe_corrupt_array, maybe_wrap_events,
    reset_env_injector)
