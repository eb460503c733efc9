"""The access-key gate of a serving host's tenant routes (`PIO_AUTH=on`).

The port's copy of `predictionio_tpu/tenancy/auth.py`. One host port
fronts many tenants, so with `PIO_AUTH=on` a query to
`/engines/<tenant>/queries.json` must carry an access key (the
`accessKey` query parameter or the `X-PIO-Access-Key` header) that the
AccessKeys DAO resolves to a live app; a slot whose `ServerConfig`
names an `accesskey` also requires that exact key. A refusal answers
401 with a body saying what was wrong (missing, not this tenant's,
unknown). Lookups are cached per key for `PIO_AUTH_CACHE_TTL_S` (30 s
by default), unknown keys too, so revoking a key takes up to the TTL;
a DAO error denies.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Tuple

from predictionio_tpu_torch.utils.http import Request, Response

logger = logging.getLogger(__name__)

HEADER = "x-pio-access-key"


def auth_enabled() -> bool:
    return os.environ.get("PIO_AUTH", "").strip().lower() in (
        "on", "1", "true", "yes")


def cache_ttl_s() -> float:
    try:
        return max(0.0, float(os.environ.get("PIO_AUTH_CACHE_TTL_S",
                                             "30.0")))
    except (TypeError, ValueError):
        return 30.0


def _deny(message: str) -> Response:
    return Response(401, {"message": message})


class AccessKeyGate:
    """TTL-cached access-key validator: `check(req, expected_key)` is
    None on success, else the 401 to answer."""

    def __init__(self, ttl_s: Optional[float] = None):
        self._ttl_s = cache_ttl_s() if ttl_s is None else float(ttl_s)
        self._lock = threading.Lock()
        # key -> (app id or None for an unknown key, expiry)
        self._cache: Dict[str, Tuple[Optional[int], float]] = {}

    @staticmethod
    def _extract(req: Request) -> Optional[str]:
        key = (req.params or {}).get("accessKey")
        if key:
            return str(key)
        key = (req.headers or {}).get(HEADER)
        return str(key) if key else None

    def _resolve(self, key: str) -> Optional[int]:
        """The app id of a valid key; None for an unknown or orphaned
        one, and on a DAO error (fail closed)."""
        from predictionio_tpu_torch.data.storage.registry import Storage
        try:
            ak = Storage.get_meta_data_access_keys().get(key)
            if ak is None:
                return None
            app = Storage.get_meta_data_apps().get(ak.appid)
            return ak.appid if app is not None else None
        except Exception:
            logger.warning("auth: access-key lookup failed; denying",
                           exc_info=True)
            return None

    def _lookup(self, key: str) -> Optional[int]:
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(key)
            if hit is not None and hit[1] > now:
                return hit[0]
        appid = self._resolve(key)
        with self._lock:
            if len(self._cache) >= 4096:
                # bounded: random keys must not grow it without limit
                self._cache.clear()
            self._cache[key] = (appid, now + self._ttl_s)
        return appid

    def check(self, req: Request,
              expected_key: Optional[str] = None) -> Optional[Response]:
        key = self._extract(req)
        if not key:
            return _deny("access key required: pass ?accessKey= or the "
                         "X-PIO-Access-Key header (PIO_AUTH=on)")
        if expected_key and key != expected_key:
            return _deny("access key is not authorized for this tenant")
        if self._lookup(key) is None:
            return _deny("access key is invalid or its app is gone")
        return None

    def invalidate(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._cache.clear()
            else:
                self._cache.pop(key, None)
