"""Wire codec: camelCase JSON/YAML documents → typed API objects.

Counterpart of ``grove_tpu/api/wire.py``: a reflective dataclass decoder
keyed on type hints (the decode half of ``api/serialize.py``'s export) with
the reference format's quirks (nested container ``resources``,
``cliqueStartupType``, ``podCliqueScalingGroups``, quantity and duration
strings), and the kind registry (group, version, plural) of the CRDs.
"""

from __future__ import annotations

import dataclasses
import functools
import typing
from typing import Any, Dict, Optional

from grove_tpu_torch.api.meta import ObjectMeta, parse_quantity
from grove_tpu_torch.api.pod import Pod
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.types import (
    Container,
    GenericObject,
    PodClique,
    PodCliqueScalingGroup,
    PodCliqueSet,
    PodCliqueSetTemplateSpec,
    PodGang,
    Queue,
    parse_duration,
)

# ---------------------------------------------------------------------------
# Kind registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KindInfo:
    kind: str
    cls: type
    group: str  # "" = core
    version: str
    plural: str
    namespaced: bool = True

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


_KINDS = [
    KindInfo("PodCliqueSet", PodCliqueSet, "grove.io", "v1alpha1", "podcliquesets"),
    KindInfo("PodClique", PodClique, "grove.io", "v1alpha1", "podcliques"),
    KindInfo(
        "PodCliqueScalingGroup",
        PodCliqueScalingGroup,
        "grove.io",
        "v1alpha1",
        "podcliquescalinggroups",
    ),
    KindInfo(
        "ClusterTopology",
        ClusterTopology,
        "grove.io",
        "v1alpha1",
        "clustertopologies",
        namespaced=False,
    ),
    KindInfo(
        "PodGang", PodGang, "scheduler.grove.io", "v1alpha1", "podgangs"
    ),
    # multi-tenant quota queue (docs/quota.md) — cluster-scoped like
    # ClusterTopology; lives in the scheduler group (fair-share ordering
    # and reclaim are scheduler-side semantics)
    KindInfo(
        "Queue",
        Queue,
        "scheduler.grove.io",
        "v1alpha1",
        "queues",
        namespaced=False,
    ),
    KindInfo("Pod", Pod, "", "v1", "pods"),
    # generic child kinds the operator materializes (sim-shaped spec dicts)
    KindInfo("Service", GenericObject, "", "v1", "services"),
    KindInfo("ServiceAccount", GenericObject, "", "v1", "serviceaccounts"),
    KindInfo("Secret", GenericObject, "", "v1", "secrets"),
    KindInfo("Event", GenericObject, "", "v1", "events"),
    KindInfo(
        "Role", GenericObject, "rbac.authorization.k8s.io", "v1", "roles"
    ),
    KindInfo(
        "RoleBinding",
        GenericObject,
        "rbac.authorization.k8s.io",
        "v1",
        "rolebindings",
    ),
    KindInfo(
        "HorizontalPodAutoscaler",
        GenericObject,
        "autoscaling",
        "v2",
        "horizontalpodautoscalers",
    ),
    # leader-election lease (coordination.k8s.io/v1, manager.go:84-98)
    KindInfo("Lease", GenericObject, "coordination.k8s.io", "v1", "leases"),
    # persisted node-drain intent (grove_tpu/disruption/drain.py): stored —
    # not controller memory — so a leader failover resumes in-flight drains
    KindInfo(
        "NodeDrain",
        GenericObject,
        "scheduler.grove.io",
        "v1alpha1",
        "nodedrains",
        namespaced=False,
    ),
]

KIND_REGISTRY: Dict[str, KindInfo] = {k.kind: k for k in _KINDS}
PLURAL_REGISTRY: Dict[str, KindInfo] = {k.plural: k for k in _KINDS}


# ---------------------------------------------------------------------------
# Reflective decoder
# ---------------------------------------------------------------------------


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


# wire key → field name aliases where the reference format diverges from
# plain camelization (reference podcliqueset.go:123-156)
_FIELD_ALIASES: Dict[type, Dict[str, str]] = {
    PodCliqueSetTemplateSpec: {
        "cliqueStartupType": "startup_type",
        "podCliqueScalingGroups": "pod_clique_scaling_group_configs",
        # our own export camelizes the field name — accept it back
        "startupType": "startup_type",
        "podCliqueScalingGroupConfigs": "pod_clique_scaling_group_configs",
    },
}


def _coerce_scalar(hint: type, value: Any, quantity: bool = False) -> Any:
    if hint is float:
        if isinstance(value, str):
            # resource maps carry quantity strings ("200m" = 0.2 cpu);
            # scalar float fields carry durations ("4h") — the two notations
            # collide on the m/h suffixes, so context decides
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


# -- per-class decode plans (the process-boundary codec shave) --------------
#
# `typing.get_type_hints` re-evaluates every stringified annotation (PEP 563)
# through `_eval_type` on EVERY call — profiled at >75% of decode wall on the
# worker-process boundary, where the coordinator decodes each worker commit
# envelope and every worker decodes the sync stream (docs/control-plane.md
# §5). Hints, field tables and Optional-unwrapped per-field hints are all
# pure functions of the class object, so they memoize exactly once.


# NO_MEMO restores the reflective path (a fresh ``get_type_hints`` and
# fields walk per decode). Only ``sim/parallel.process_codec_ab``'s "off" arm
# sets it, to time the memoized decode against it in one process; the
# decoded objects are the same either way.
NO_MEMO = False


@functools.lru_cache(maxsize=None)
def _class_hints(cls: type) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


@functools.lru_cache(maxsize=None)
def _class_fields(cls: type) -> Dict[str, Any]:
    return {f.name: f for f in dataclasses.fields(cls)}


@functools.lru_cache(maxsize=None)
def _field_hint(cls: type, fname: str) -> Any:
    """The field's hint with Optional[X] pre-unwrapped to X — the per-value
    decoder then skips the Union branch entirely on the hot path."""
    hint = _class_hints(cls)[fname]
    if typing.get_origin(hint) is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return args[0] if args else Any
    return hint


def _decode_value(hint: Any, value: Any) -> Any:
    if value is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _decode_value(args[0], value) if args else value
    if origin in (list, typing.List):
        (item_hint,) = typing.get_args(hint) or (Any,)
        return [_decode_value(item_hint, v) for v in value]
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        val_hint = args[1] if len(args) == 2 else Any
        if val_hint in (float, int):
            return {
                k: _coerce_scalar(val_hint, v, quantity=True)
                for k, v in value.items()
            }
        return dict(value)
    if dataclasses.is_dataclass(hint):
        return decode_dataclass(hint, value)
    if hint in (float, int, bool, str):
        return _coerce_scalar(hint, value)
    return value


def decode_dataclass(cls: type, doc: Dict[str, Any]):
    """Wire dict → dataclass instance (inverse of serialize.to_dict)."""
    if not isinstance(doc, dict):
        raise ValueError(f"expected object for {cls.__name__}, got {doc!r}")
    doc = dict(doc)
    if cls is Container and "resources" in doc:
        # reference container format nests requests/limits under `resources`
        res = doc.pop("resources") or {}
        doc.setdefault("requests", res.get("requests") or {})
        doc.setdefault("limits", res.get("limits") or {})
    if NO_MEMO:  # the reflective path (process_codec_ab's "off" arm only)
        hints = typing.get_type_hints(cls)
        fields = {f.name: f for f in dataclasses.fields(cls)}
    else:
        hints = None
        fields = _class_fields(cls)
    aliases = _FIELD_ALIASES.get(cls, {})
    kwargs: Dict[str, Any] = {}
    leftovers: Dict[str, Any] = {}
    for key, value in doc.items():
        fname = aliases.get(key) or (
            key if key in fields else _snake(key)
        )
        if fname in fields:
            hint = hints[fname] if hints is not None else _field_hint(cls, fname)
            kwargs[fname] = _decode_value(hint, value)
        else:
            leftovers[key] = value
    # unmodeled keys pass through into `extra` when the type carries one
    # (Container/PodSpec — keeps template hashing change-sensitive)
    if leftovers and "extra" in fields:
        extra = dict(kwargs.get("extra") or {})
        for k, v in leftovers.items():
            extra.setdefault(k, v)
        kwargs["extra"] = extra
    return cls(**kwargs)


def _decode_metadata(doc: Dict[str, Any]) -> ObjectMeta:
    meta = decode_dataclass(ObjectMeta, doc or {})
    if not meta.namespace:
        meta.namespace = "default"
    return meta


def decode_object(doc: Dict[str, Any]):
    """Full CR document (apiVersion/kind/metadata/spec/status) → object."""
    kind = doc.get("kind")
    info = KIND_REGISTRY.get(kind or "")
    if info is None:
        raise ValueError(f"unsupported kind {kind!r}")
    cls = info.cls
    meta = _decode_metadata(doc.get("metadata") or {})
    if not info.namespaced:
        meta.namespace = ""
    if cls is GenericObject:
        return GenericObject(kind=kind, metadata=meta, spec=dict(doc.get("spec") or {}))
    hints = typing.get_type_hints(cls) if NO_MEMO else _class_hints(cls)
    kwargs: Dict[str, Any] = {"metadata": meta}
    if "spec" in hints and doc.get("spec") is not None:
        kwargs["spec"] = _decode_value(
            hints["spec"] if NO_MEMO else _field_hint(cls, "spec"), doc["spec"])
    if "status" in hints and doc.get("status") is not None:
        kwargs["status"] = _decode_value(
            hints["status"] if NO_MEMO else _field_hint(cls, "status"), doc["status"])
    obj = cls(**kwargs)
    return obj


def resolve_path_kind(group: str, version: str, plural: str) -> Optional[KindInfo]:
    info = PLURAL_REGISTRY.get(plural)
    if info is None:
        return None
    if info.group != group or info.version != version:
        return None
    return info
