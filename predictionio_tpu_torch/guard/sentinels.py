"""Numerical sentinels for the ALS train sweep and the fold-in.

The port's counterpart of `predictionio_tpu/guard/sentinels.py`: after
every iteration `als_train` checks each factor table on the device for
non-finite values and an exploded max row norm (one small reduction and
one scalar fetch per table), and keeps a device copy of the last clean
iteration. A breach returns the last clean model, or raises
`NumericalFault` when no iteration completed cleanly. The fold-in
(`online/fold_in.py`) checks only the rows a side solved
(`SweepSentinel.check_rows`, O(touched)) against a bound scaled from the
deployed model's max row norm (`host_max_norm`), and carries the largest
norm a passing check saw into the next tick (`observed_max`).

`PIO_GUARD=off` (or `0`/`false`) disables the sentinel. A breach is
logged, counted in `pio_guard_sentinel_breaches_total{site}`, recorded
as a `sentinel_breach` flight record and captured as an incident bundle.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _breach_counter():
    from predictionio_tpu_torch.obs import get_registry
    return get_registry().counter(
        "pio_guard_sentinel_breaches_total",
        "Numerical sentinel breaches (non-finite or norm-exploded "
        "factor rows) by site",
        labelnames=("site",))


def _breach_forensics(site: str, detail: str) -> None:
    """A breach is a flight record and an incident bundle, the evidence
    the poisoned tick is reconstructed from. Never raises."""
    try:
        from predictionio_tpu_torch.obs import FLIGHT, get_incidents
        FLIGHT.record("sentinel_breach", site=site, detail=detail)
        get_incidents().capture("sentinel_breach",
                                f"numerical fault in {site}",
                                context={"site": site, "detail": detail})
    except Exception:
        logger.debug("breach forensics failed", exc_info=True)


class NumericalFault(ArithmeticError):
    """A sweep produced non-finite or norm-exploded factor rows."""

    def __init__(self, site: str, detail: str):
        super().__init__(f"numerical fault in {site}: {detail}")
        self.site = site
        self.detail = detail


def guard_enabled() -> bool:
    """The PIO_GUARD kill switch: the sentinel is on unless the
    environment says off/0/false."""
    return os.environ.get("PIO_GUARD", "").strip().lower() \
        not in ("off", "0", "false")


def device_copy(table: torch.Tensor) -> torch.Tensor:
    """An independent copy on the table's device (the checkpoint must
    survive the next sweep's in-place updates)."""
    return table.clone()


def table_stats(table: torch.Tensor) -> Tuple[bool, float]:
    """(all finite, max row L2 norm) of a table, from one device
    reduction and one two-element fetch."""
    sq = (table.float() ** 2).sum(dim=-1)
    finite = torch.isfinite(table).all().float()
    max_sq = sq.max() if sq.numel() else sq.new_zeros(())
    vals = torch.stack([finite, max_sq]).cpu()
    return bool(vals[0] > 0.5), float(torch.sqrt(vals[1].clamp(min=0.0)))


def rows_stats(table: torch.Tensor, idx: np.ndarray) -> Tuple[bool, float]:
    """(all finite, max row L2 norm) over `table[idx]`: the fold's
    O(touched) check, from one gather, one reduction and one fetch."""
    if idx.size == 0:
        return True, 0.0
    return table_stats(table[torch.as_tensor(
        np.asarray(idx, dtype=np.int64), device=table.device)])


def host_max_norm(*tables: np.ndarray) -> float:
    """Max row L2 norm across host factor tables (non-finite readings
    skipped): the baseline the fold's explosion bound scales from."""
    mx = 0.0
    for t in tables:
        if t is None or t.size == 0:
            continue
        with np.errstate(over="ignore", invalid="ignore"):
            n = float(np.sqrt(np.max(np.einsum("ij,ij->i", t, t))))
        if np.isfinite(n):
            mx = max(mx, n)
    return mx


class SweepSentinel:
    """Breach detector: rows must be finite and their norms under
    `max(norm_floor, norm_ratio * baseline_norm)`. `observed_max` is the
    largest norm a passing `check_rows` saw (from the baseline up)."""

    def __init__(self, site: str, baseline_norm: float,
                 norm_ratio: float = 1e3, norm_floor: float = 1e4):
        self.site = site
        self.bound = max(norm_floor, norm_ratio * baseline_norm)
        self.breaches = 0
        self.observed_max = baseline_norm

    def _verdict(self, what: str, finite: bool,
                 max_norm: float) -> Optional[NumericalFault]:
        if finite and max_norm <= self.bound:
            return None
        self.breaches += 1
        _breach_counter().labels(site=self.site).inc()
        detail = (f"{what}: finite={finite} max_row_norm={max_norm:.4g} "
                  f"bound={self.bound:.4g}")
        logger.error("sentinel breach in %s — %s", self.site, detail)
        _breach_forensics(self.site, detail)
        return NumericalFault(self.site, detail)

    def check_rows(self, table: torch.Tensor, idx: np.ndarray, what: str
                   ) -> Optional[NumericalFault]:
        """Inspect the rows `idx` of `table` (the ones a fold side just
        solved); returns the fault or None. The caller decides whether to
        roll back or raise."""
        if not guard_enabled():
            return None
        finite, max_norm = rows_stats(table, idx)
        fault = self._verdict(what, finite, max_norm)
        if fault is None:
            self.observed_max = max(self.observed_max, max_norm)
        return fault

    def check_table(self, table: torch.Tensor, what: str
                    ) -> Optional[NumericalFault]:
        """Inspect a whole table; returns the fault or None. The caller
        decides whether to roll back or raise."""
        if not guard_enabled():
            return None
        return self._verdict(what, *table_stats(table))
