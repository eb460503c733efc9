"""Shared query/result shapes for the engine templates.

The port's copy of `predictionio_tpu/models/common.py`: the same JSON wire
dicts (`{"itemScores": [{"item": ..., "score": ...}, ...]}`) and the same
columnar `RatingsData` training payload.
"""

from __future__ import annotations

from collections import namedtuple
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.data.bimap import EntityIdIxMap


@dataclass(frozen=True)
class ItemScore:
    """Optional item properties ride along in the result JSON (the
    similar-product template's `return_properties`)."""
    item: str
    score: float
    properties: Optional[Mapping] = field(default=None, compare=False)

    def to_dict(self):
        d = {"item": self.item, "score": float(self.score)}
        if self.properties:
            # a property named "item"/"score" never clobbers the wire
            # fields
            d.update({k: v for k, v in self.properties.items()
                      if k not in ("item", "score")})
        return d


@dataclass(frozen=True)
class ItemScoreResult:
    item_scores: Sequence[ItemScore]

    def to_dict(self):
        return {"itemScores": [s.to_dict() for s in self.item_scores]}


#: one rating row, as iterating the reference's RatingsData yields it
RatingRow = namedtuple("Rating", ("user", "item", "rating", "t"))


class RatingsData:
    """Columnar (user, item, rating, t) quadruples: four flat numpy arrays
    instead of a list of per-event objects."""

    __slots__ = ("users", "items", "vals", "ts")

    def __init__(self, users, items, vals, ts=None):
        self.users = np.asarray(users)
        self.items = np.asarray(items)
        self.vals = np.asarray(vals, dtype=np.float32)
        self.ts = (np.zeros(len(self.vals), dtype=np.int64)
                   if ts is None else np.asarray(ts, dtype=np.int64))

    @staticmethod
    def from_rows(rows: Sequence) -> "RatingsData":
        """Rows with .user/.item/.rating (and optional .t) attributes."""
        return RatingsData(
            np.array([r.user for r in rows], dtype=str),
            np.array([r.item for r in rows], dtype=str),
            np.array([r.rating for r in rows], dtype=np.float32),
            np.array([getattr(r, "t", 0) for r in rows], dtype=np.int64))

    def __len__(self) -> int:
        return int(self.vals.shape[0])

    def select(self, mask_or_idx) -> "RatingsData":
        return RatingsData(self.users[mask_or_idx], self.items[mask_or_idx],
                           self.vals[mask_or_idx], self.ts[mask_or_idx])


def resolve_ids(ix_map: EntityIdIxMap, ids: Optional[Sequence[str]]
                ) -> np.ndarray:
    """String ids -> known dense indices (unknown ids dropped)."""
    if not ids:
        return np.array([], dtype=np.int32)
    ixs = ix_map.to_indices(list(ids))
    return ixs[ixs >= 0]


def top_scores_to_result(ix_map: EntityIdIxMap, scores: np.ndarray,
                         idx: np.ndarray,
                         properties_of=None) -> ItemScoreResult:
    """Dense (scores, item indices) -> the wire result. `properties_of`:
    optional callable dense index -> property dict merged into each
    ItemScore's JSON."""
    items = ix_map.ids_of(idx) if len(idx) else []
    if properties_of is None:
        return ItemScoreResult(tuple(
            ItemScore(item, float(s)) for item, s in zip(items, scores)))
    return ItemScoreResult(tuple(
        ItemScore(item, float(s), properties_of(int(i)))
        for item, s, i in zip(items, scores, idx)))
