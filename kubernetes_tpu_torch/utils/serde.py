"""Dataclass <-> JSON-dict serialization with Kubernetes-style camelCase keys.

The reference's API types round-trip through JSON with camelCase field names
(e.g. staging/src/k8s.io/api/core/v1/types.go struct tags). Here every API
dataclass gets the same property via type-hint driven generic serde instead
of per-type generated codecs (the reference generates these with
k8s.io/code-generator).

Conventions:
  - snake_case python field  <->  camelCase JSON key
  - a field may override its JSON key with metadata={"json": "name"}
  - zero-valued fields (None, "", 0, False, empty list/dict) are omitted on
    serialization (matches Go `omitempty`)
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, Optional, Type, TypeVar, Union, get_args, get_origin

T = TypeVar("T")


def snake_to_camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.title() for p in parts[1:])


def _json_key(field: dataclasses.Field) -> str:
    return field.metadata.get("json", snake_to_camel(field.name))


def _is_optional(tp: Any) -> bool:
    return get_origin(tp) is Union and type(None) in get_args(tp)


def _unwrap_optional(tp: Any) -> Any:
    if _is_optional(tp):
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


# Per-class field plan: (attr name, json key, resolved type, is_optional).
# typing.get_type_hints re-evaluates string annotations with compile() on
# EVERY call — uncached it was ~2.8ms per Pod round-trip, the single
# hottest host cost on the apiserver write path.
_PLAN_CACHE: Dict[type, list] = {}


def _field_plan(cls: type) -> list:
    plan = _PLAN_CACHE.get(cls)
    if plan is None:
        hints = typing.get_type_hints(cls)
        plan = [
            (
                f.name,
                _json_key(f),
                hints.get(f.name, f.type),
                _is_optional(hints.get(f.name, f.type)),
            )
            for f in dataclasses.fields(cls)
        ]
        _PLAN_CACHE[cls] = plan
    return plan


def to_dict(obj: Any) -> Any:
    """Serialize a dataclass (or container of them) to JSON-compatible dicts."""
    if obj is None:
        return None
    custom = getattr(obj, "__serde_to_dict__", None)
    if custom is not None and not isinstance(obj, type):
        return custom()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: Dict[str, Any] = {}
        for name, key, _tp, is_opt in _field_plan(type(obj)):
            v = getattr(obj, name)
            if v is None:
                continue
            # Optional fields mirror Go pointers: a present zero value (e.g.
            # *int32 replicas = 0) is serialized, only nil is omitted.
            if not is_opt and (
                v == "" or v == 0 or v is False or v == [] or v == {}
            ):
                continue
            out[key] = to_dict(v)
        return out
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def from_dict(cls: Type[T], data: Any) -> T:
    """Deserialize JSON-compatible data into dataclass `cls` using type hints."""
    return _from_value(cls, data)


def _from_value(tp: Any, data: Any) -> Any:
    if data is None:
        return None
    tp = _unwrap_optional(tp)
    origin = get_origin(tp)
    if origin in (list, tuple):
        (elem_tp,) = get_args(tp) or (Any,)
        return [_from_value(elem_tp, v) for v in data]
    if origin is dict:
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: _from_value(val_tp, v) for k, v in data.items()}
    if isinstance(tp, type) and hasattr(tp, "__serde_from_dict__"):
        return tp.__serde_from_dict__(data)
    if dataclasses.is_dataclass(tp):
        kwargs = {}
        for name, key, field_tp, _is_opt in _field_plan(tp):
            if key in data:
                kwargs[name] = _from_value(field_tp, data[key])
        return tp(**kwargs)
    if tp in (Any, object) or isinstance(tp, TypeVar):
        return data
    if tp is float and isinstance(data, int):
        return float(data)
    return data
