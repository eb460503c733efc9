"""The tenant attribution context.

The port's copy of `predictionio_tpu/obs/tenantctx.py`: one contextvar
(`tenant_scope`, `current_tenant`) and the registered-tenant set that
bounds the `tenant` metric label (`register_tenant`,
`metric_tenant_label`). `obs.costmon.device_timed` books device seconds
by `{executable,tenant}` through it, and `utils/device_cache` tags the
uploads and residency slots made under it for the serving host's HBM
budget (`tenancy/`). A tenant is registered when a serving host's slot,
a tenant-tagged engine server or scheduler is made; an untenanted series
books under `""`. The scope follows the call stack across locks, not
into threads created inside it: a thread a tenant's path starts enters
the tenant itself.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import FrozenSet, Optional

#: the shared metric label name every tenant-labeled family uses
#: (no synonym such as tenant_id)
TENANT_LABEL = "tenant"

_tenant_var: "contextvars.ContextVar[Optional[str]]" = \
    contextvars.ContextVar("pio_tenant", default=None)

_reg_lock = threading.Lock()
# copy-on-write frozenset: readers (the device_timed hot path) get a
# lock-free membership test; registration is rare (tenant admission)
_registered: FrozenSet[str] = frozenset()


def current_tenant() -> Optional[str]:
    """The tenant the calling context is attributed to (None outside
    any scope). One contextvar read — hot-path safe."""
    return _tenant_var.get()


@contextlib.contextmanager
def tenant_scope(tenant: Optional[str]):
    """Attribute everything inside the block — device uploads, device
    time, flight records, traces, slow queries, incident captures — to
    ``tenant``. ``None`` is a no-op scope (single-tenant processes
    never pay for the tagging)."""
    if tenant is None:
        yield
        return
    token = _tenant_var.set(str(tenant))
    try:
        yield
    finally:
        _tenant_var.reset(token)


def register_tenant(tenant: str) -> str:
    """Admit ``tenant`` to the bounded metric-label set. Idempotent;
    called from every admission path (host slots, tenant-tagged
    EngineServers, tenant-attached schedulers)."""
    global _registered
    tenant = str(tenant)
    with _reg_lock:
        if tenant not in _registered:
            _registered = _registered | {tenant}
    return tenant


def registered_tenants() -> FrozenSet[str]:
    """The admitted tenant set — the cardinality bound metric lint
    checks tenant-labeled families against."""
    return _registered


def metric_tenant_label(tenant: Optional[str] = None) -> str:
    """The ``tenant`` label VALUE for a metric series: the active (or
    given) tenant when registered, else ``""`` — unregistered scope
    values must not mint unbounded series."""
    t = tenant if tenant is not None else _tenant_var.get()
    if t is not None and t in _registered:
        return t
    return ""
