"""Bidirectional id maps: string entity ids <-> dense integer indices.

The port's copy of `predictionio_tpu/data/bimap.py` (`BiMap`,
`EntityIdIxMap` with the fold-in's `grow`), cut to what the
recommendation and similar-product templates use. Ids are assigned in
sorted order, so every build of the same id set gives the same dense
indices as the reference package; `grow` appends unseen ids after them,
so a grown map is no longer sorted.
"""

from __future__ import annotations

from typing import Generic, Hashable, Iterable, List, Mapping, TypeVar

import numpy as np


class BiMap:
    """Immutable one-to-one map."""

    __slots__ = ("_fwd",)

    def __init__(self, forward: Mapping[Hashable, Hashable]):
        fwd = dict(forward)
        if len(set(fwd.values())) != len(fwd):
            raise ValueError("BiMap values must be unique")
        self._fwd = fwd

    def __getitem__(self, key):
        return self._fwd[key]

    def __contains__(self, key) -> bool:
        return key in self._fwd

    def __len__(self) -> int:
        return len(self._fwd)

    def get(self, key, default=None):
        return self._fwd.get(key, default)

    def items(self):
        return self._fwd.items()


class EntityIdIxMap:
    """entityId <-> dense row index, with a numpy inverse table for
    vectorized index->id translation."""

    def __init__(self, id_to_ix: BiMap):
        self._bimap = id_to_ix
        ids: List[str] = [""] * len(id_to_ix)
        for k, v in id_to_ix.items():
            ids[int(v)] = k
        self._ids = np.array(ids, dtype=object)
        self._sorted_view = None

    @staticmethod
    def from_ids(ids: Iterable[str]) -> "EntityIdIxMap":
        """Map whose dense index i is the i-th id, in the given order (a
        model's table rows already fix the order)."""
        return EntityIdIxMap(BiMap({str(k): i for i, k in enumerate(ids)}))

    @staticmethod
    def build(keys) -> "EntityIdIxMap":
        """Dense indices by sorted order of the distinct keys (the
        reference's `build(keys, sort=True)`), by one np.unique pass, which
        orders strings as `sorted` does."""
        uniq = np.unique(np.asarray(keys).astype(str))
        return EntityIdIxMap(BiMap({str(k): i for i, k in enumerate(uniq)}))

    @staticmethod
    def build_with_indices(ids: np.ndarray
                           ) -> "tuple[EntityIdIxMap, np.ndarray]":
        """One np.unique pass yields the sorted-order map and the dense
        index of every input row."""
        arr = np.asarray(ids)
        if arr.dtype == object:
            arr = arr.astype(str)
        uniq, inv = np.unique(arr, return_inverse=True)
        bm = BiMap({str(k): i for i, k in enumerate(uniq)})
        return EntityIdIxMap(bm), inv.astype(np.int32)

    def __getitem__(self, entity_id: str) -> int:
        return self._bimap[entity_id]

    def get(self, entity_id: str, default: int = -1) -> int:
        return self._bimap.get(entity_id, default)

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._bimap

    def __len__(self) -> int:
        return len(self._bimap)

    def id_of(self, ix: int) -> str:
        return str(self._ids[ix])

    def ids_of(self, ixs) -> List[str]:
        return [str(x) for x in self._ids[np.asarray(ixs, dtype=np.int64)]]

    def to_indices(self, entity_ids: Iterable[str]) -> np.ndarray:
        """id -> index per element; unknown ids map to -1."""
        return np.array([self._bimap.get(e, -1) for e in entity_ids],
                        dtype=np.int32)

    def to_indices_array(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized id -> index for numpy id arrays (unknowns -> -1):
        binary search against a sorted view of the key table, built once
        per map."""
        arr = np.asarray(ids)
        if arr.dtype == object:
            arr = arr.astype(str)
        keys = self._ids.astype(str)
        if len(keys) == 0 or arr.size == 0:
            return np.full(arr.shape, -1, dtype=np.int32)
        # a view built for fewer keys is stale (the reference re-checks
        # the length for the same reason)
        if self._sorted_view is None or len(self._sorted_view[0]) != len(
                keys):
            order = np.argsort(keys)
            self._sorted_view = (keys[order], order.astype(np.int32))
        sorted_keys, order = self._sorted_view
        pos = np.searchsorted(sorted_keys, arr)
        pos_safe = np.clip(pos, 0, len(sorted_keys) - 1)
        hit = sorted_keys[pos_safe] == arr
        return np.where(hit, order[pos_safe], -1).astype(np.int32)

    @property
    def ids(self) -> np.ndarray:
        """Ids by dense index (object array)."""
        return self._ids

    def grow(self, new_ids: Iterable[str]
             ) -> "tuple[EntityIdIxMap, np.ndarray]":
        """Append the unseen ids after the vocabulary, in first-occurrence
        order, so no existing dense index moves (factor row i keeps its
        entity across model versions). Returns (grown map, the indices
        given to the new ids); (self, empty) when nothing is new. The
        grown map is a new object with its own sorted view."""
        fresh: List[str] = []
        seen = set()
        for e in new_ids:
            e = str(e)
            if e not in self._bimap and e not in seen:
                seen.add(e)
                fresh.append(e)
        if not fresh:
            return self, np.empty(0, dtype=np.int32)
        base = len(self._bimap)
        fwd = dict(self._bimap.items())
        for i, e in enumerate(fresh):
            fwd[e] = base + i
        return (EntityIdIxMap(BiMap(fwd)),
                np.arange(base, base + len(fresh), dtype=np.int32))


V = TypeVar("V")


class EntityMap(Generic[V]):
    """Entity-id-keyed data with dense-index access (the reference's
    EntityMap)."""

    def __init__(self, data: Mapping[str, V],
                 ix_map: "EntityIdIxMap" = None):
        self._data = dict(data)
        self._ix = ix_map or EntityIdIxMap.build(list(self._data))

    def __getitem__(self, entity_id: str) -> V:
        return self._data[entity_id]

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._data

    def __len__(self) -> int:
        return len(self._data)

    def get_by_index(self, ix: int) -> V:
        return self._data[self._ix.id_of(ix)]

    @property
    def ix_map(self) -> "EntityIdIxMap":
        return self._ix
