"""Telemetry: the metrics registry, device time and runtime counters.

The port's counterpart of `predictionio_tpu/obs/`, so far:

- `obs.metrics`: Counter/Gauge/Histogram on a process-wide
  `MetricsRegistry` (each HTTP server's registry chains to it); every
  `GET /metrics` renders from here.
- `obs.torchmon`: `obs/jaxmon.py`'s counterpart: compile counters (the
  `nvcc` builds and the CUDA-graph captures), host<->device bytes,
  device-memory gauges.
- `obs.costmon`: compile attribution by executable label, device time
  from CUDA events, the occupancy EWMA.
- `obs.tenantctx`: the tenant contextvar and the bounded `tenant` label.

Tracing (`obs/trace.py`, `/traces.json`), the flight recorder,
incidents, SLOs, the slow-query log, the profiler and the fleet are
later slices.
"""

from predictionio_tpu_torch.obs.metrics import (DEFAULT_BUCKETS, Counter,
                                                FuncCollector, Gauge,
                                                Histogram, MetricsRegistry,
                                                REGISTRY, get_registry)
from predictionio_tpu_torch.obs import costmon, torchmon
from predictionio_tpu_torch.obs.tenantctx import (TENANT_LABEL,
                                                  current_tenant,
                                                  metric_tenant_label,
                                                  register_tenant,
                                                  registered_tenants,
                                                  tenant_scope)

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "FuncCollector", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "get_registry",
    "costmon", "torchmon",
    "TENANT_LABEL", "current_tenant", "metric_tenant_label",
    "register_tenant", "registered_tenants", "tenant_scope",
]
