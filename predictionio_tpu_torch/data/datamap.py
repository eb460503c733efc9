"""Typed JSON property bags.

The port's copy of `predictionio_tpu/data/datamap.py`: `DataMap`, an
immutable map of JSON values with typed accessors and merge helpers
(the reference's DataMap.scala:41-204), and `PropertyMap`, a DataMap
that carries the first/last-updated times of the `$set/$unset/$delete`
events folded into it (PropertyMap.scala:33).

Values are plain JSON types (None, bool, int, float, str, list, dict).
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Any, Iterator, Mapping, Optional, Type, TypeVar

T = TypeVar("T")


class DataMapException(Exception):
    """Raised on missing fields or type mismatches in a DataMap."""


def _coerce(key: str, value: Any, target: Optional[type]) -> Any:
    if target is None:
        return value
    if target is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise DataMapException(
                f"field {key}: cannot convert {value!r} to float")
        return float(value)
    if target is int:
        if isinstance(value, bool) or not isinstance(value, int):
            if isinstance(value, float) and value.is_integer():
                return int(value)
            raise DataMapException(
                f"field {key}: cannot convert {value!r} to int")
        return int(value)
    if target is bool:
        if not isinstance(value, bool):
            raise DataMapException(
                f"field {key}: cannot convert {value!r} to bool")
        return value
    if target is str:
        if not isinstance(value, str):
            raise DataMapException(
                f"field {key}: cannot convert {value!r} to str")
        return value
    if target is list:
        if not isinstance(value, list):
            raise DataMapException(
                f"field {key}: cannot convert {value!r} to list")
        return value
    if target is dict:
        if not isinstance(value, dict):
            raise DataMapException(
                f"field {key}: cannot convert {value!r} to dict")
        return value
    if isinstance(value, target):
        return value
    raise DataMapException(f"field {key}: cannot convert {value!r} to {target}")


class DataMap(Mapping[str, Any]):
    """An immutable map of JSON property values with typed accessors."""

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_fields", dict(fields or {}))

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key: object) -> bool:
        return key in self._fields

    def __eq__(self, other: object) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self):  # immutable enough for set membership by content
        return hash(json.dumps(self._fields, sort_keys=True, default=str))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"

    # -- reference API ------------------------------------------------------
    @property
    def fields(self) -> dict:
        return dict(self._fields)

    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapException(f"The field {name} is required.")

    def contains(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str, as_type: Optional[Type[T]] = None) -> T:
        """Typed, required field access (DataMap.scala `get[T]`)."""
        self.require(name)
        value = self._fields[name]
        if value is None:
            raise DataMapException(
                f"The required field {name} cannot be null.")
        return _coerce(name, value, as_type)

    def get_opt(self, name: str, as_type: Optional[Type[T]] = None) -> Optional[T]:
        """Optional typed field access (DataMap.scala `getOpt[T]`)."""
        value = self._fields.get(name)
        if value is None:
            return None
        return _coerce(name, value, as_type)

    def get_or_else(self, name: str, default: T) -> T:
        got = self.get_opt(name, type(default) if default is not None else None)
        return default if got is None else got

    def get_double(self, name: str) -> float:
        return self.get(name, float)

    def get_string_list(self, name: str) -> list:
        value = self.get(name, list)
        return [_coerce(name, v, str) for v in value]

    def get_double_list(self, name: str) -> list:
        value = self.get(name, list)
        return [_coerce(name, v, float) for v in value]

    def union(self, other: "DataMap") -> "DataMap":
        """Right-biased merge (DataMap.scala `++`)."""
        merged = dict(self._fields)
        merged.update(other._fields)
        return DataMap(merged)

    def __add__(self, other: "DataMap") -> "DataMap":
        return self.union(other)

    def minus(self, keys) -> "DataMap":
        """Key removal (DataMap.scala `--`)."""
        return DataMap({k: v for k, v in self._fields.items() if k not in keys})

    def __sub__(self, keys) -> "DataMap":
        return self.minus(keys)

    def is_empty(self) -> bool:
        return not self._fields

    @property
    def key_set(self) -> set:
        return set(self._fields)

    def to_json(self) -> str:
        return json.dumps(self._fields, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DataMap":
        parsed = json.loads(s)
        if not isinstance(parsed, dict):
            raise DataMapException(f"not a JSON object: {s!r}")
        return cls(parsed)


class PropertyMap(DataMap):
    """A DataMap produced by aggregating ``$set/$unset/$delete`` events,
    carrying the first/last event times that contributed to it
    (reference: PropertyMap.scala:33)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(self, fields: Optional[Mapping[str, Any]],
                 first_updated: _dt.datetime, last_updated: _dt.datetime):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:
        return (f"PropertyMap({self.fields!r}, firstUpdated={self.first_updated},"
                f" lastUpdated={self.last_updated})")

    def __eq__(self, other: object) -> bool:
        if isinstance(other, PropertyMap):
            return (self.fields == other.fields
                    and self.first_updated == other.first_updated
                    and self.last_updated == other.last_updated)
        return super().__eq__(other)

    __hash__ = DataMap.__hash__
