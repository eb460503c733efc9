"""Typed component parameters.

The port's copy of `predictionio_tpu/core/params.py`: the `Params` marker
and the JSON extraction of engine.json `params` blocks into component
dataclasses by field name, with strict typing (the reference's
Params.scala:23 and WorkflowUtils.scala:132-204 `extractParams`).
`params_to_dict` refuses a value with no JSON form, naming the field, so
an engine instance never records params it could not restore.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import types
import typing
from typing import Any, Dict, Optional, Type

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Params:
    """Marker base class for component parameters."""


@dataclasses.dataclass(frozen=True)
class EmptyParams(Params):
    pass


def _coerce_field(value, hint, where: str):
    """Validate/convert one JSON value against a field's type annotation —
    the typed-extraction step of the reference's JsonExtractor
    (workflow/JsonExtractor.scala + json4s strict extraction): wrong
    types fail HERE with the field named, instead of deep inside a jitted
    solver. JSON-native conversions only: arrays become tuples for
    Tuple[...] fields, ints widen to float; strings never silently parse
    into numbers. Unrecognized annotations (domain classes, Any, dicts)
    pass through unvalidated."""
    if hint is Any or hint is None:
        return value
    origin = typing.get_origin(hint)
    args = typing.get_args(hint)
    # typing.Union AND PEP 604 `X | Y` (types.UnionType on 3.10+)
    if origin is typing.Union or origin is types.UnionType:
        if value is None and type(None) in args:
            return None
        errors = []
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce_field(value, a, where)
            except (TypeError, ValueError) as e:
                errors.append(str(e))
        # arm messages already carry the `where` prefix
        raise ValueError(" / ".join(errors))
    if origin in (tuple,):
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{where}: expected an array, got "
                             f"{type(value).__name__} ({value!r})")
        if args and args[-1] is Ellipsis:
            elem = args[0]
            return tuple(_coerce_field(v, elem, f"{where}[{i}]")
                         for i, v in enumerate(value))
        if args and len(value) != len(args):
            raise ValueError(f"{where}: expected {len(args)} elements, "
                             f"got {len(value)}")
        return tuple(_coerce_field(v, a, f"{where}[{i}]")
                     for i, (v, a) in enumerate(zip(value, args))) \
            if args else tuple(value)
    if origin in (list,):
        if not isinstance(value, (list, tuple)):
            raise ValueError(f"{where}: expected an array, got "
                             f"{type(value).__name__} ({value!r})")
        elem = args[0] if args else Any
        return [_coerce_field(v, elem, f"{where}[{i}]")
                for i, v in enumerate(value)]
    if hint is bool:
        if not isinstance(value, bool):
            raise ValueError(f"{where}: expected a boolean, got "
                             f"{type(value).__name__} ({value!r})")
        return value
    if hint is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{where}: expected an integer, got "
                             f"{type(value).__name__} ({value!r})")
        if isinstance(value, float):
            if not value.is_integer():
                raise ValueError(f"{where}: expected an integer, got "
                                 f"{value!r}")
            return int(value)
        return value
    if hint is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{where}: expected a number, got "
                             f"{type(value).__name__} ({value!r})")
        return float(value)
    if hint is str:
        if not isinstance(value, str):
            raise ValueError(f"{where}: expected a string, got "
                             f"{type(value).__name__} ({value!r})")
        return value
    return value    # domain classes, dicts, Any: pass through


def params_from_dict(cls: Optional[Type[Params]], d: Optional[Dict[str, Any]]):
    """Build a Params instance from a JSON dict, tolerating missing optional
    fields, rejecting unknown ones, and type-checking every provided value
    against the dataclass annotations (matching json4s strict
    extraction)."""
    if cls is None or cls is EmptyParams:
        return EmptyParams()
    d = d or {}
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"params class {cls} must be a dataclass")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"Unknown parameter(s) {sorted(unknown)} for {cls.__name__}; "
            f"expected subset of {sorted(names)}")
    missing = [f.name for f in dataclasses.fields(cls)
               if f.name not in d and f.default is dataclasses.MISSING
               and f.default_factory is dataclasses.MISSING]
    if missing:
        raise ValueError(
            f"Missing required parameter(s) {missing} for {cls.__name__}")
    try:
        hints = typing.get_type_hints(cls)
    except NameError as e:
        # a genuinely unresolvable annotation (typo, missing import):
        # downgrade to unvalidated extraction, but say so — silently
        # skipping ALL checks would defeat the feature invisibly
        logger.warning("cannot resolve type annotations of %s (%s); "
                       "params extracted without type validation",
                       cls.__name__, e)
        hints = {}
    coerced = {k: _coerce_field(v, hints.get(k, Any),
                                f"{cls.__name__}.{k}")
               for k, v in d.items()}
    return cls(**coerced)


def params_to_dict(p: Optional[Params]) -> Dict[str, Any]:
    """The JSON form of a params dataclass (or dict): its fields by
    name. Raises ValueError naming the first field whose value has no
    JSON form."""
    if p is None:
        return {}
    if dataclasses.is_dataclass(p):
        d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    elif isinstance(p, dict):
        d = dict(p)
    else:
        raise TypeError(f"cannot serialize params {p!r}")
    for k, v in d.items():
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            raise ValueError(
                f"{type(p).__name__}.{k} holds a {type(v).__name__}, which "
                "has no JSON form; an engine instance records its params "
                "as JSON") from None
    return d
