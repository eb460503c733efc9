"""Event-server bookkeeping counters.

The port's copy of `predictionio_tpu/data/api/stats.py`, the reference's
``Stats`` / ``StatsActor``
(reference: data/src/main/scala/io/prediction/data/api/Stats.scala:40-79,
StatsActor.scala:28-33): per-app counters of (event, entityType, status)
kept for the current and previous window, served on ``/stats.json``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple


class Stats:
    WINDOW_SEC = 3600.0  # reference rotates hourly

    def __init__(self):
        self._lock = threading.Lock()
        self._window_start = time.time()
        self._current: Dict[Tuple, int] = defaultdict(int)
        self._previous: Dict[Tuple, int] = defaultdict(int)

    def _maybe_rotate(self):
        now = time.time()
        elapsed = now - self._window_start
        if elapsed >= 2 * self.WINDOW_SEC:
            # idle gap spanning more than one full window: the stale
            # current window is not "previous" — at least one empty
            # window sat between it and now, so reporting it would
            # claim hour-old traffic as last-hour traffic. Both
            # windows start empty.
            self._previous = defaultdict(int)
            self._current = defaultdict(int)
            self._window_start = now
        elif elapsed >= self.WINDOW_SEC:
            self._previous = self._current
            self._current = defaultdict(int)
            self._window_start = now

    def update(self, app_id: int, event_name: str, entity_type: str,
               status: int, n: int = 1):
        """``n`` lets the columnar bulk-write route count a whole batch
        of identical (event, entityType) rows in one lock acquisition."""
        with self._lock:
            self._maybe_rotate()
            self._current[(app_id, event_name, entity_type, status)] += n

    def _render(self, counters: Dict[Tuple, int], app_id: Optional[int]):
        by_event: Dict[str, int] = defaultdict(int)
        by_entity: Dict[str, int] = defaultdict(int)
        by_status: Dict[str, int] = defaultdict(int)
        total = 0
        for (aid, ev, et, st), n in counters.items():
            if app_id is not None and aid != app_id:
                continue
            by_event[ev] += n
            by_entity[et] += n
            by_status[str(st)] += n
            total += n
        return {"count": total, "byEvent": dict(by_event),
                "byEntityType": dict(by_entity), "byStatus": dict(by_status)}

    def to_dict(self, app_id: Optional[int] = None) -> dict:
        with self._lock:
            self._maybe_rotate()
            return {
                "startTime": self._window_start,
                "currentWindow": self._render(self._current, app_id),
                "previousWindow": self._render(self._previous, app_id),
            }
