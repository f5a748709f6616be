"""Wire codec: camelCase documents → typed API objects.

Counterpart of the decode half of ``grove_tpu/api/wire.py`` for the kinds
the scheduler round and the disruption layer read: Pod, PodGang, PodClique,
Queue, PodCliqueSet, and the generic HorizontalPodAutoscaler and NodeDrain
(``GenericObject``: the spec stays a dict). A document the
JAX package writes (``grove_tpu/api/serialize.py::export_object``) decodes
here into the port's own classes; keys a class does not model go into its
``extra`` field when it has one and are dropped otherwise.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Any, Dict

from grove_tpu_torch.api.meta import ObjectMeta, parse_quantity
from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.types import (
    Container,
    GenericObject,
    PodClique,
    PodCliqueSet,
    PodGang,
    Queue,
    parse_duration,
)

# kind -> (class, namespaced)
KINDS: Dict[str, tuple] = {
    "Pod": (Pod, True),
    "PodGang": (PodGang, True),
    "PodClique": (PodClique, True),
    "Queue": (Queue, False),
    "PodCliqueSet": (PodCliqueSet, True),
    "HorizontalPodAutoscaler": (GenericObject, True),
    # the persisted node-drain intent (disruption/drain.py)
    "NodeDrain": (GenericObject, False),
}


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _coerce_scalar(hint: type, value: Any, quantity: bool = False) -> Any:
    if hint is float:
        if isinstance(value, str):
            # resource maps hold quantities ("200m" = 0.2 cpu), scalar
            # float fields durations ("4h"): the m/h suffixes collide
            if quantity:
                return parse_quantity(value)
            try:
                return parse_duration(value)
            except ValueError:
                return parse_quantity(value)
        return float(value)
    if hint is int:
        return int(value)
    if hint is bool:
        return bool(value)
    if hint is str:
        return str(value)
    return value


@functools.lru_cache(maxsize=None)
def _class_fields(cls: type) -> Dict[str, Any]:
    return {f.name: f for f in dataclasses.fields(cls)}


@functools.lru_cache(maxsize=None)
def _field_hint(cls: type, fname: str) -> Any:
    """The field's type hint with Optional[X] unwrapped to X."""
    hint = typing.get_type_hints(cls)[fname]
    if typing.get_origin(hint) is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return args[0] if args else Any
    return hint


def _decode_value(hint: Any, value: Any) -> Any:
    if value is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _decode_value(args[0], value) if args else value
    if origin in (list, typing.List):
        (item_hint,) = typing.get_args(hint) or (Any,)
        return [_decode_value(item_hint, v) for v in value]
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        val_hint = args[1] if len(args) == 2 else Any
        if val_hint in (float, int):
            return {k: _coerce_scalar(val_hint, v, quantity=True) for k, v in value.items()}
        return dict(value)
    if dataclasses.is_dataclass(hint):
        return decode_dataclass(hint, value)
    if hint in (float, int, bool, str):
        return _coerce_scalar(hint, value)
    return value


def decode_dataclass(cls: type, doc: Dict[str, Any]):
    """A wire dict as an instance of the dataclass ``cls``."""
    if not isinstance(doc, dict):
        raise ValueError(f"expected object for {cls.__name__}, got {doc!r}")
    doc = dict(doc)
    if cls is Container and "resources" in doc:
        # the reference container format nests requests/limits
        res = doc.pop("resources") or {}
        doc.setdefault("requests", res.get("requests") or {})
        doc.setdefault("limits", res.get("limits") or {})
    fields = _class_fields(cls)
    kwargs: Dict[str, Any] = {}
    leftovers: Dict[str, Any] = {}
    for key, value in doc.items():
        fname = key if key in fields else _snake(key)
        if fname in fields:
            kwargs[fname] = _decode_value(_field_hint(cls, fname), value)
        else:
            leftovers[key] = value
    if leftovers and "extra" in fields:
        extra = dict(kwargs.get("extra") or {})
        for k, v in leftovers.items():
            extra.setdefault(k, v)
        kwargs["extra"] = extra
    return cls(**kwargs)


def decode_object(doc: Dict[str, Any]):
    """A whole document (apiVersion/kind/metadata/spec/status) as an object."""
    kind = doc.get("kind")
    if kind not in KINDS:
        raise ValueError(f"unsupported kind {kind!r}")
    cls, namespaced = KINDS[kind]
    meta = decode_dataclass(ObjectMeta, doc.get("metadata") or {})
    if not meta.namespace:
        meta.namespace = "default"
    if not namespaced:
        meta.namespace = ""
    if cls is GenericObject:
        return GenericObject(kind=kind, metadata=meta, spec=dict(doc.get("spec") or {}))
    kwargs: Dict[str, Any] = {"metadata": meta}
    for part in ("spec", "status"):
        if doc.get(part) is not None:
            kwargs[part] = _decode_value(_field_hint(cls, part), doc[part])
    return cls(**kwargs)
