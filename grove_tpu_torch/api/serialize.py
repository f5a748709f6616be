"""Object → YAML-able dict export (kubectl get -o yaml UX).

Counterpart of ``grove_tpu/api/serialize.py``.

Round-trips the camelCase wire convention of the manifest format: snake_case
dataclass fields become camelCase keys; metadata/status included so operators
can inspect live state from the CLI.

The encoder is compiled per dataclass type (field list + camelCase names
resolved once, cached): the WAL serializes every store commit through this
module (grove_tpu/durability), which turned the naive
fields()-walk-per-object into measurable control-plane overhead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

_EMPTY = (None, [], {}, "")

# exact-type fast sets: `type(x) in set` is one hash lookup vs a chain of
# isinstance calls per node (this function visits ~100 nodes per pod)
_SCALARS = frozenset((str, int, float, bool, type(None)))


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


# type -> [(field name, camelCase key)]; dataclass shapes are static, so
# the dataclasses.fields() walk and the camelization happen once per type
_FIELD_CACHE: Dict[type, List[Tuple[str, str]]] = {}


def _fields_of(cls: type) -> List[Tuple[str, str]]:
    cached = _FIELD_CACHE.get(cls)
    if cached is None:
        cached = _FIELD_CACHE[cls] = [
            (f.name, _camel(f.name)) for f in dataclasses.fields(cls)
        ]
    return cached


def to_dict(obj: Any) -> Any:
    t = obj.__class__
    if t in _SCALARS:
        return obj
    if t is dict:
        return {k: to_dict(v) for k, v in obj.items()}
    if t is list or t is tuple:
        return [to_dict(v) for v in obj]
    fields = _FIELD_CACHE.get(t)
    if fields is None:
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            fields = _fields_of(t)
        elif isinstance(obj, dict):  # dict subclass
            return {k: to_dict(v) for k, v in obj.items()}
        elif isinstance(obj, (list, tuple)):  # sequence subclass
            return [to_dict(v) for v in obj]
        else:
            return obj
    out = {}
    for fname, key in fields:
        value = getattr(obj, fname)
        if value.__class__ in _SCALARS:
            # inlined leaf case (scalars dominate field counts); the drop
            # rule for scalars reduces to None/"" — 0/0.0/False survive
            # `value in (None, [], {}, "")` and must keep surviving here
            if value is None or value == "":
                continue
            out[key] = value
            continue
        value = to_dict(value)
        if value in _EMPTY:
            continue
        out[key] = value
    return out


_API_VERSIONS = {
    "PodGang": "scheduler.grove.io/v1alpha1",
    "PodCliqueSet": "grove.io/v1alpha1",
    "PodClique": "grove.io/v1alpha1",
    "PodCliqueScalingGroup": "grove.io/v1alpha1",
    "ClusterTopology": "grove.io/v1alpha1",
    "Pod": "v1",
    "Service": "v1",
    "ServiceAccount": "v1",
    "Secret": "v1",
    "Event": "v1",
    "Role": "rbac.authorization.k8s.io/v1",
    "RoleBinding": "rbac.authorization.k8s.io/v1",
    "HorizontalPodAutoscaler": "autoscaling/v2",
    "Lease": "coordination.k8s.io/v1",
    "NodeDrain": "scheduler.grove.io/v1alpha1",
}


def export_object(obj) -> dict:
    doc = to_dict(obj)
    kind = doc.pop("kind", getattr(obj, "kind", ""))
    return {
        "apiVersion": _API_VERSIONS.get(kind, "grove.io/v1alpha1"),
        "kind": kind,
        **doc,
    }


def export_object_shared(obj, memo: Dict[int, tuple]) -> dict:
    """export_object with an id-keyed memo over TOP-LEVEL subtrees
    (spec/status/metadata). The store's structural-sharing commits make
    sibling objects share subtree IDENTITY (e.g. every pod of a clique
    created from one desired-state template shares its spec object), so a
    batch exporter — the WAL's group-commit flush — serializes each
    shared subtree once per batch instead of once per object. The memo
    holds ``id -> (subtree ref, doc)``; keeping the ref pins the id for
    the memo's lifetime, and the caller must scope the memo to one batch
    whose objects it holds alive."""
    kind = getattr(obj, "kind", "")
    out = {
        "apiVersion": _API_VERSIONS.get(kind, "grove.io/v1alpha1"),
        "kind": kind,
    }
    for fname, key in _fields_of(type(obj)):
        if fname == "kind":
            continue
        value = getattr(obj, fname)
        if value.__class__ in _SCALARS:
            if value is None or value == "":
                continue
            out[key] = value
            continue
        cached = memo.get(id(value))
        if cached is None or cached[0] is not value:
            cached = (value, to_dict(value))
            memo[id(value)] = cached
        doc = cached[1]
        if doc in _EMPTY:
            continue
        out[key] = doc
    return out
