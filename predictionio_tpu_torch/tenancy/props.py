"""Durable per-tenant placement props: priority and pin.

The port's copy of `predictionio_tpu/tenancy/props.py`. A pin taken
through `tenants pin` must survive a host restart: each tenant key has
one JSON sidecar under `base_dir()/tenancy/props/`, written crash-atomic
(a temporary file, fsync, `os.replace`), and the serving host overlays
it on the static `TenantSpec` when it admits the tenant. The props
describe the tenant, not a trained instance, so retrains and rollbacks
never rewrite them. Last writer wins.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)

#: the props a caller may set; any other key is dropped on save
_FIELDS = ("priority", "pinned")


def _props_dir() -> str:
    from predictionio_tpu_torch.data.storage.registry import base_dir
    return os.path.join(base_dir(), "tenancy", "props")


def _path(tenant: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", tenant or "_")
    return os.path.join(_props_dir(), f"{safe}.json")


def load_props(tenant: str) -> Optional[dict]:
    """The stored props of `tenant`, or None when never written."""
    try:
        with open(_path(tenant), encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, ValueError):
        return None
    return rec if isinstance(rec, dict) else None


def save_props(tenant: str, *, priority: Optional[int] = None,
               pinned: Optional[bool] = None) -> Optional[dict]:
    """Merge the given fields into the tenant's sidecar, crash-atomic.
    Returns the record written, or None when the write failed (a
    read-only store must not fail the pin endpoint: the host's
    in-memory ledger still flips)."""
    rec = load_props(tenant) or {"tenant": tenant}
    if priority is not None:
        rec["priority"] = int(priority)
    if pinned is not None:
        rec["pinned"] = bool(pinned)
    rec = {k: rec[k] for k in ("tenant", *_FIELDS) if k in rec}
    rec["updatedAt"] = time.time()
    path = _path(tenant)
    tmp = path + f".tmp{os.getpid()}"
    try:
        os.makedirs(_props_dir(), exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        logger.warning("tenancy: cannot persist props for %r under %s",
                       tenant, _props_dir(), exc_info=True)
        return None
    return rec


def all_props() -> Dict[str, dict]:
    """Every stored record, by tenant."""
    out: Dict[str, dict] = {}
    try:
        names = sorted(os.listdir(_props_dir()))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(_props_dir(), name),
                      encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(rec, dict) and rec.get("tenant"):
            out[rec["tenant"]] = rec
    return out
