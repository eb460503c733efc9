"""Device residency slots for the fold-in, and the factor-table budget.

The port's counterpart of the residency part of
`predictionio_tpu/utils/device_cache.py` (`get_resident`,
`put_resident`, `check_table_budget`). A fold tick starts from the
deployed factor tables and ends by publishing grown and updated ones;
the next tick starts from exactly those. A named slot keeps the tick's
final device tensors, keyed by weak references to the host arrays of the
model version it published: when the next tick presents the same host
arrays, it reuses the device tensors and uploads only its solve plans.
A slot dies with its key arrays (weakref callbacks), so a model that is
no longer served never pins device memory. One version per name.

`PIO_TABLE_BUDGET_BYTES` caps the bytes one factor table may take on the
device; unset, nothing is checked. The reference's content-keyed upload
cache and tenant attribution are not part of this slice.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, Optional, Tuple

_lock = threading.Lock()
_resident: Dict[str, Tuple[tuple, dict, Any]] = {}
# name -> (weak refs to the key arrays, payload, layout token)


class TableBudgetExceeded(RuntimeError):
    """A factor-table upload would exceed `PIO_TABLE_BUDGET_BYTES`."""


def table_budget_bytes() -> Optional[int]:
    """The enforced per-device factor-table budget, or None (the
    default: no budget)."""
    raw = os.environ.get("PIO_TABLE_BUDGET_BYTES", "").strip()
    if not raw:
        return None
    try:
        b = int(float(raw))
    except ValueError:
        return None
    return b if b > 0 else None


def check_table_budget(per_device_bytes: int, table: str = "table") -> None:
    """Raise `TableBudgetExceeded` when `per_device_bytes` breaks the
    budget; a no-op without one."""
    budget = table_budget_bytes()
    if budget is not None and int(per_device_bytes) > budget:
        raise TableBudgetExceeded(
            f"{table}: {int(per_device_bytes)} bytes per device exceeds "
            f"the enforced table budget of {budget} bytes "
            "(PIO_TABLE_BUDGET_BYTES); raise the budget")


def get_resident(name: str, key_arrays, sharding: Any = None
                 ) -> Optional[dict]:
    """The slot's payload if it was stored against exactly these host
    arrays (identity, through the weak references) and the same layout
    token; None on any mismatch."""
    with _lock:
        entry = _resident.get(name)
    if entry is None:
        return None
    refs, payload, token = entry
    if token != sharding or len(refs) != len(key_arrays):
        return None
    if all(r() is a for r, a in zip(refs, key_arrays)):
        return payload
    return None


def put_resident(name: str, key_arrays, payload: dict,
                 sharding: Any = None) -> None:
    """Store `payload` (device tensors) under `name`, valid while every
    array of `key_arrays` (the published version's host tables) lives;
    replaces the slot's previous version."""
    refs: tuple = ()

    def evict(_ref):
        # runs from the garbage collector, maybe while this thread holds
        # the lock: a plain dict operation, and only if the slot is still
        # the one these references key (a newer version stays)
        entry = _resident.get(name)
        if entry is not None and entry[0] is refs:
            _resident.pop(name, None)

    try:
        refs = tuple(weakref.ref(a, evict) for a in key_arrays)
    except TypeError:
        return    # not weakref-able: no residency rather than a leak
    with _lock:
        _resident[name] = (refs, payload, sharding)

