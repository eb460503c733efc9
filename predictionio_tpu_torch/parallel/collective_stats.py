"""Collective traffic, counted where the mesh's collectives are called.

The port's counterpart of `predictionio_tpu/parallel/collective_stats.py`.
The reference reads collectives out of compiled XLA HLO, since GSPMD
decides where they go. The port has no HLO: every collective it runs is
a `torch.distributed` call made through the thin wrappers of
`parallel/mesh.py` (`broadcast`, `all_gather`, `all_reduce`), and each
wrapper records its kind and the bytes of its output buffer here
(`record`). `collective_stats()` returns the reference's shape,
`{kind: {"count", "bytes"}, "total": {...}}`, with the reference's kind
names ("all-gather", "all-reduce", and "broadcast", which the reference
lowers to an all-reduce). A `since` snapshot gives the traffic of one
stretch of work, such as one query window.

`ici_seconds` is the reference's ring cost model over those bytes. It
takes the link's bandwidth from the caller and has no default: the port
states no interconnect figure of its own.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["record", "collective_stats", "snapshot", "ici_seconds",
           "KINDS"]

#: the kinds the mesh's wrappers record
KINDS = ("all-gather", "all-reduce", "broadcast")

_lock = threading.Lock()
_counts: Dict[str, list] = {}


def record(kind: str, nbytes: int) -> None:
    """Count one collective of `kind` whose output buffer holds
    `nbytes` bytes."""
    with _lock:
        ent = _counts.setdefault(kind, [0, 0])
        ent[0] += 1
        ent[1] += int(nbytes)


def snapshot() -> Dict[str, tuple]:
    """The raw cumulative counts, for a later `collective_stats(since=)`."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _counts.items()}


def collective_stats(since: Optional[Dict[str, tuple]] = None
                     ) -> Dict[str, dict]:
    """Per-kind counts and output bytes of the collectives this process
    ran (since `since`, a `snapshot()`), plus their `total`."""
    base = since or {}
    out: Dict[str, dict] = {}
    for kind, (count, nbytes) in snapshot().items():
        c0, b0 = base.get(kind, (0, 0))
        if count - c0:
            out[kind] = {"count": count - c0, "bytes": nbytes - b0}
    out["total"] = {"count": sum(v["count"] for v in out.values()),
                    "bytes": sum(v["bytes"] for v in out.values())}
    return out


def ici_seconds(stats: Dict[str, dict], n_devices: int,
                bytes_per_s: float) -> float:
    """Least wall time the collectives of `stats` spend on a link of
    `bytes_per_s`, by the reference's ring model: an all-reduce of
    payload P over n devices moves about 2 P (n-1)/n a link, an
    all-gather or a reduce-scatter P (n-1)/n, anything else (a
    broadcast, a permute) P."""
    if n_devices <= 1:
        return 0.0
    scale = (n_devices - 1) / n_devices
    total = 0.0
    for op, ent in stats.items():
        if op == "total":
            continue
        p = ent["bytes"]
        if op == "all-reduce":
            total += 2.0 * p * scale
        elif op in ("all-gather", "reduce-scatter"):
            total += p * scale
        else:
            total += p
    return total / float(bytes_per_s)
