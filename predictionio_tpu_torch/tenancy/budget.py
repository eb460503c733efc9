"""The HBM budget of a serving host: per-tenant resident bytes, admission
and eviction.

The port's counterpart of `predictionio_tpu/tenancy/budget.py`
(`estimate_padded_bytes`, `HBMBudgetManager`). A host packs several
tenants' factor tables on one card; this module decides which of them
may stay there.

- **Accounting.** `sizes()` reads each tenant's resident bytes from the
  live tensors: the uploads and residency slots `utils/device_cache`
  tagged with the tenant (the models' device tables are views of those
  uploads), and what a `sizer` adds for a tenant. The sum goes by
  storage, not by object (`device_cache.storage_nbytes`): two tensors
  that view one storage count it once, so the gauge
  `pio_engine_hbm_bytes{tenant}` reads what the tenant's live storages
  hold. It is never read from the caching allocator (`memory_reserved`,
  which keeps freed blocks) or from `nvidia-smi`.
- **Admission.** A tenant whose tables, padded to the compile plane's row
  buckets, exceed the whole budget can never fit: `admit` refuses it
  with `TableBudgetExceeded` before it serves a query.
- **Eviction.** `ensure_room` evicts the coldest unpinned tenants (lowest
  priority, then least recently hit) until the budget holds with the
  incoming tenant's bytes: its padded estimate, or what it held when it
  was last evicted if that was more (a fold's residency, a filtered
  ranking's table); `evict` runs the host's evictor (which quiesces the
  slot, drops its graphs, cache entries and residency slots) and counts `pio_tenant_evictions_total{tenant,reason}`, with a
  `tenant_eviction` flight record. The host mirrors (the models' numpy
  tables) stay: the next hit uploads again.

A sharded table (`parallel/sharded_table.ShardedTable`) is estimated at
its padded bytes / n_shards, as the reference's is: one logical device's
share. Its resident shard tensors reach `sizes` through the host's
sizer, by storage like every other tensor.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.utils import device_cache
from predictionio_tpu_torch.utils.device_cache import TableBudgetExceeded

logger = logging.getLogger(__name__)

__all__ = ["HBMBudgetManager", "TableBudgetExceeded",
           "estimate_padded_bytes", "is_sharded"]


def is_sharded(table: Any) -> bool:
    """True for a `ShardedTable`."""
    from predictionio_tpu_torch.parallel.sharded_table import \
        is_sharded as _is_sharded
    return _is_sharded(table)


def _model_objects(models: Sequence[Any]) -> List[Any]:
    """The models and their `als` parts: the objects whose attributes
    hold the tables, one level deep."""
    out = []
    for m in models:
        out.append(m)
        als = getattr(m, "als", None)
        if als is not None:
            out.append(als)
    return out


def _iter_tables(models: Sequence[Any]):
    """Every distinct 2-D host table reachable one attribute level deep
    from the models (the tables the serve and fold paths upload)."""
    seen = set()
    for obj in _model_objects(models):
        try:
            attrs = vars(obj)
        except TypeError:
            continue
        for v in attrs.values():
            if id(v) in seen:
                continue
            if is_sharded(v) or (isinstance(v, np.ndarray) and v.ndim == 2):
                seen.add(id(v))
                yield v


def estimate_padded_bytes(models: Sequence[Any]) -> int:
    """Bytes the models' tables take once resident at their row buckets:
    the admission estimate (the reference's, on the port's buckets). A
    sharded table costs its padded bytes / n_shards."""
    from predictionio_tpu_torch.compile import buckets as B
    total = 0
    for t in _iter_tables(models):
        n, width = t.shape
        itemsize = np.dtype(t.dtype).itemsize
        if is_sharded(t):
            padded = B.bucket_rows_sharded(n, t.n_shards)
            total += (padded // t.n_shards) * width * itemsize
        else:
            total += B.bucket_rows(n) * width * itemsize
    return int(total)


class _TenantState:
    __slots__ = ("tenant", "expected_bytes", "last_bytes", "priority",
                 "pinned", "last_hit", "admitted_at", "evictions", "sizer",
                 "evictor")

    def __init__(self, tenant: str, expected_bytes: int,
                 priority: int = 0, pinned: bool = False,
                 sizer: Optional[Callable[[], list]] = None,
                 evictor: Optional[Callable[[], None]] = None):
        self.tenant = tenant
        self.expected_bytes = int(expected_bytes)
        # what it held when last evicted: its next upload's projection
        self.last_bytes = 0
        self.priority = int(priority)
        self.pinned = bool(pinned)
        self.last_hit = time.monotonic()
        self.admitted_at = time.time()
        self.evictions = 0
        # sizer() -> tensors the tenant holds that device_cache does not
        # tag (tensors, not bytes: sizes() dedups them by storage
        # against the tagged entries); evictor() is the host's
        # quiesce-and-drop
        self.sizer = sizer
        self.evictor = evictor

    def snapshot(self) -> dict:
        return {
            "expectedPaddedBytes": self.expected_bytes,
            "priority": self.priority,
            "pinned": self.pinned,
            "idleSec": round(time.monotonic() - self.last_hit, 3),
            "admittedAt": self.admitted_at,
            "evictions": self.evictions,
        }


class HBMBudgetManager:
    """Thread-safe per-tenant accounting and eviction policy of one
    serving host. `budget_bytes` defaults to `PIO_TABLE_BUDGET_BYTES`
    (None: accounting only; an operator may still evict)."""

    def __init__(self, budget_bytes: Optional[int] = None, registry=None):
        self.budget_bytes = (int(budget_bytes) if budget_bytes
                             else device_cache.table_budget_bytes())
        self._lock = threading.RLock()
        self._tenants: Dict[str, _TenantState] = {}
        self._c_evictions = None
        if registry is not None:
            registry.gauge_func(
                "pio_engine_hbm_bytes",
                "Per-device HBM bytes resident per serving tenant "
                "(factor tables + fold residency payloads), measured "
                "from the live device tensors' storages",
                self._hbm_samples)
            registry.gauge_func(
                "pio_tenant_hbm_budget_bytes",
                "Enforced per-device HBM table budget for the host "
                "(0 = unenforced)",
                lambda: float(self.budget_bytes or 0))
            self._c_evictions = registry.counter(
                "pio_tenant_evictions_total",
                "Tenant factor-table evictions back to host mirrors, "
                "by tenant and reason (budget = room made for another "
                "tenant, operator = tenants evict / HTTP, remove = "
                "tenant removal)", labelnames=("tenant", "reason"))

    def _hbm_samples(self):
        sizes = self.sizes()
        with self._lock:
            # an admitted tenant with nothing resident samples 0
            return [({"tenant": t}, float(sizes.get(t, 0)))
                    for t in sorted(self._tenants)]

    # -- lifecycle ----------------------------------------------------------
    def admit(self, tenant: str, models: Sequence[Any], *,
              priority: int = 0, pinned: bool = False,
              sizer: Optional[Callable[[], list]] = None,
              evictor: Optional[Callable[[], None]] = None
              ) -> _TenantState:
        """Register `tenant` if its padded tables could fit the budget
        alone; else raise `TableBudgetExceeded` and keep no state."""
        tenant = str(tenant)
        expected = estimate_padded_bytes(models)
        if self.budget_bytes is not None and expected > self.budget_bytes:
            raise TableBudgetExceeded(
                f"tenant {tenant!r}: padded factor tables need "
                f"{expected} bytes per device, over the host HBM budget "
                f"of {self.budget_bytes} bytes — this tenant can NEVER "
                f"fit; shrink the vocabulary or raise the budget "
                f"(HostConfig.budget_bytes, PIO_TABLE_BUDGET_BYTES)")
        st = _TenantState(tenant, expected, priority=priority,
                          pinned=pinned, sizer=sizer, evictor=evictor)
        with self._lock:
            self._tenants[tenant] = st
        return st

    def forget(self, tenant: str) -> None:
        with self._lock:
            self._tenants.pop(str(tenant), None)

    def touch(self, tenant: str) -> None:
        st = self._tenants.get(str(tenant))
        if st is not None:
            st.last_hit = time.monotonic()

    def pin(self, tenant: str, pinned: bool = True) -> bool:
        with self._lock:
            st = self._tenants.get(str(tenant))
            if st is None:
                return False
            st.pinned = bool(pinned)
            return True

    # -- accounting ---------------------------------------------------------
    def tenant_tensors(self) -> Dict[str, list]:
        """tenant -> the live tensors it holds: the tagged cache entries
        and residency payloads, and what its sizer adds. Every admitted
        tenant has an entry."""
        arrays = device_cache.tenant_device_arrays()
        with self._lock:
            for t in self._tenants:
                arrays.setdefault(t, [])
            sizers = [(t, st.sizer) for t, st in self._tenants.items()
                      if st.sizer is not None]
        for t, sizer in sizers:
            try:
                arrays.setdefault(t, []).extend(sizer() or ())
            except Exception:
                logger.debug("tenant sizer failed for %s", t,
                             exc_info=True)
        return arrays

    def sizes(self) -> Dict[str, int]:
        """tenant -> bytes of the distinct live storages it holds."""
        return {t: device_cache.storage_nbytes(arrs)
                for t, arrs in self.tenant_tensors().items()}

    def resident_bytes(self) -> int:
        return sum(self.sizes().values())

    # -- policy -------------------------------------------------------------
    def _evictable(self, protect: str, sizes: Dict[str, int]
                   ) -> List[_TenantState]:
        """Unpinned tenants other than `protect` holding bytes, coldest
        first (priority, then last hit). The caller holds the lock."""
        cands = [st for t, st in self._tenants.items()
                 if t != protect and not st.pinned and sizes.get(t, 0) > 0]
        cands.sort(key=lambda s: (s.priority, s.last_hit))
        return cands

    def ensure_room(self, tenant: str) -> int:
        """Evict the coldest candidates while the other tenants' resident
        bytes plus `tenant`'s exceed the budget, `tenant`'s the most of
        its padded estimate, what it held when last evicted and what it
        holds. Returns the evictions made; none without a budget. Best
        effort: with every other tenant pinned the upload goes ahead over
        the budget, and a warning says so."""
        if self.budget_bytes is None:
            return 0
        tenant = str(tenant)
        evicted = 0
        for _ in range(len(self._tenants) + 1):
            sizes = self.sizes()
            with self._lock:
                st = self._tenants.get(tenant)
                need = (max(st.expected_bytes, st.last_bytes)
                        if st is not None else 0)
                projected = sum(b for t, b in sizes.items() if t != tenant) \
                    + max(need, sizes.get(tenant, 0))
                if projected <= self.budget_bytes:
                    return evicted
                cands = self._evictable(tenant, sizes)
                if not cands:
                    logger.warning(
                        "tenant %s: projected residency %d bytes exceeds "
                        "the %d-byte budget and no unpinned cold tenant "
                        "is left to evict — overcommitting (unpin a "
                        "neighbor or raise the budget)", tenant,
                        projected, self.budget_bytes)
                    return evicted
                victim = cands[0].tenant
            self.evict(victim, reason="budget")
            evicted += 1
        return evicted

    def evict(self, tenant: str, reason: str = "operator") -> dict:
        """Evict one tenant's device residency back to its host mirrors
        through the host's evictor (else the upload cache's drop).
        Returns {"tenant", "reason", "bytesFreed"}."""
        from predictionio_tpu_torch.obs.flight import FLIGHT
        tenant = str(tenant)
        before = self.sizes().get(tenant, 0)
        with self._lock:
            st = self._tenants.get(tenant)
            evictor = st.evictor if st is not None else None
        if evictor is not None:
            evictor()
        else:
            device_cache.evict_tenant(tenant)
        freed = max(before - self.sizes().get(tenant, 0), 0)
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None:
                st.evictions += 1
                if before:
                    st.last_bytes = int(before)
        if self._c_evictions is not None:
            self._c_evictions.labels(tenant=tenant, reason=reason).inc()
        FLIGHT.record("tenant_eviction", tenant=tenant, reason=reason,
                      bytesFreed=int(freed))
        logger.info("tenant %s evicted (%s): %d bytes freed", tenant,
                    reason, freed)
        return {"tenant": tenant, "reason": reason,
                "bytesFreed": int(freed)}

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        sizes = self.sizes()
        with self._lock:
            tenants = {t: dict(st.snapshot(), hbmBytes=int(sizes.get(t, 0)))
                       for t, st in self._tenants.items()}
        return {"budgetBytes": self.budget_bytes,
                "residentBytes": int(sum(sizes.values())),
                "tenants": tenants}
