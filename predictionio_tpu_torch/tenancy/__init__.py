"""Multi-tenant serving: many engines on one card.

The port's counterpart of `predictionio_tpu/tenancy/`, with the same
exports:

- `budget`: the HBM budget manager (per-tenant resident bytes from the
  tenant-tagged uploads and residency slots, which hold the models'
  device tables, admission of tenants that can ever fit, eviction of the coldest
  unpinned tenants back to their host mirrors);
- `host`: the `ServingHost`, which routes `/engines/<tenant>/...` to
  per-tenant `EngineServer` slots sharing one result cache, one budget
  and one fold-tick gate, and serves the host's `/stats.json`,
  `/tenants.json`, `/tenants/signals.json`, `/placement.json`,
  `/metrics` and `/health.json`;
- `placement` and `controller`: the pure planner and the
  `PlacementController` that fails a dead host's tenants over to the
  survivors, migrates tenants and feeds the `TenantRouter`;
- `props`: durable per-tenant priority and pin;
- `auth`: the `PIO_AUTH=on` access-key gate of the tenant routes.

Where the port differs on purpose: a tenant's CUDA graphs are its own
(a graph bakes in the addresses of the tables it read), so an eviction
drops them with the tables, and a sharded table's resident shards with
them; resident bytes are summed by storage.
"""

from predictionio_tpu_torch.tenancy.budget import (HBMBudgetManager,
                                                   estimate_padded_bytes)
from predictionio_tpu_torch.tenancy.host import (HostConfig, ServingHost,
                                                 TenantSlot, TenantSpec)
from predictionio_tpu_torch.tenancy.controller import (ControllerConfig,
                                                       PlacementController,
                                                       TenantRouter)
from predictionio_tpu_torch.tenancy.placement import (Decision, HostView,
                                                      PlacementPlan,
                                                      TenantView,
                                                      plan_failover,
                                                      plan_placement,
                                                      plan_rebalance)

__all__ = [
    "HBMBudgetManager", "estimate_padded_bytes",
    "HostConfig", "ServingHost", "TenantSlot", "TenantSpec",
    "ControllerConfig", "PlacementController", "TenantRouter",
    "Decision", "HostView", "PlacementPlan", "TenantView",
    "plan_failover", "plan_placement", "plan_rebalance",
]
