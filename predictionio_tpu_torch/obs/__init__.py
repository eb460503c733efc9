"""Telemetry and diagnostics: the metrics registry, trace spans, device
time, the flight recorder, incidents, SLOs, the slow-query log and the
profilers.

The port's counterpart of `predictionio_tpu/obs/`:

- `obs.metrics`: Counter/Gauge/Histogram on a process-wide
  `MetricsRegistry` (each HTTP server's registry chains to it); every
  `GET /metrics` renders from here, with trace-id exemplars on the
  histogram buckets.
- `obs.trace`: trace spans with contextvar propagation, links across
  traces and the `X-PIO-Trace-Id` header contract; `GET /traces.json`
  on both servers reads the process-wide `TRACER`.
- `obs.torchmon`: `obs/jaxmon.py`'s counterpart: compile counters (the
  `nvcc` builds and the CUDA-graph captures), host<->device bytes,
  device-memory gauges.
- `obs.costmon`: compile attribution by executable label, device time
  from CUDA events, the occupancy EWMA.
- `obs.flight`: the bounded lifecycle log (`GET /flight.json`).
- `obs.incidents`: postmortem bundles under `base_dir()/incidents/`
  (`incidents` of the CLI, `GET /incidents.json`).
- `obs.slo`: the burn-rate SLO engine (`GET /health.json`) and the
  lock-wait probes.
- `obs.profiler`: the always-on sampling profiler and the torch.profiler
  device trace (`/profile.json`).
- `obs.slowlog`: slow-query stage waterfalls (`GET /slow.json`).
- `obs.tenantctx`: the tenant contextvar and the bounded `tenant` label.

The reference's `obs.fleet` (the member registry, `/fleet/*`, fleet-wide
incidents) is not ported yet.
"""

from predictionio_tpu_torch.obs.metrics import (DEFAULT_BUCKETS, Counter,
                                                FuncCollector, Gauge,
                                                Histogram, MetricsRegistry,
                                                REGISTRY, get_registry)
from predictionio_tpu_torch.obs.trace import (Span, Trace, Tracer, TRACER,
                                              ingress_trace_kwargs,
                                              trace_context_headers,
                                              traces_response)
from predictionio_tpu_torch.obs import costmon, torchmon
from predictionio_tpu_torch.obs.flight import (FLIGHT, FlightRecorder,
                                               flight_response, get_flight)
from predictionio_tpu_torch.obs.incidents import (INCIDENTS,
                                                  IncidentManager,
                                                  get_incidents)
from predictionio_tpu_torch.obs.slo import (SLOEngine, SLOSpec,
                                            default_engine_specs,
                                            default_event_specs,
                                            health_response)
from predictionio_tpu_torch.obs.profiler import (PROFILER,
                                                 SamplingProfiler,
                                                 get_profiler)
from predictionio_tpu_torch.obs.slowlog import (SLOWLOG, SlowQueryLog,
                                                get_slowlog, slow_response)
from predictionio_tpu_torch.obs.tenantctx import (TENANT_LABEL,
                                                  current_tenant,
                                                  metric_tenant_label,
                                                  register_tenant,
                                                  registered_tenants,
                                                  tenant_scope)

__all__ = [
    "DEFAULT_BUCKETS", "Counter", "FuncCollector", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "get_registry",
    "Span", "Trace", "Tracer", "TRACER", "traces_response",
    "ingress_trace_kwargs", "trace_context_headers",
    "costmon", "torchmon",
    "FLIGHT", "FlightRecorder", "flight_response", "get_flight",
    "INCIDENTS", "IncidentManager", "get_incidents",
    "SLOEngine", "SLOSpec", "default_engine_specs",
    "default_event_specs", "health_response",
    "PROFILER", "SamplingProfiler", "get_profiler",
    "SLOWLOG", "SlowQueryLog", "get_slowlog", "slow_response",
    "TENANT_LABEL", "current_tenant", "metric_tenant_label",
    "register_tenant", "registered_tenants", "tenant_scope",
]
