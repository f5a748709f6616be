"""CRD manifest generation from the typed API model.

Counterpart of ``grove_tpu/cluster/crdgen.py``, with the same names, wire
format and status codes.

The counterpart of the reference's embedded CRD YAML
(upstream operator/api/core/v1alpha1/crds/,
upstream scheduler/api/core/v1alpha1/crds/): structural
openAPIV3Schema derived reflectively from the dataclasses, so the manifests
can never drift from the Go^H^Hpython types (the reference enforces the same
with `make check` codegen drift detection, SURVEY §4.4).

``render_crds`` returns them and ``write_crds`` writes them; deploy/crds/
holds the committed copies (tests/test_torch_clustertools.py holds this
module's output to them byte for byte).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict, List, Optional

import yaml

from grove_tpu_torch.api.wire import KIND_REGISTRY, KindInfo

# kinds that ship as CRDs (core kinds like Pod are built-in, not CRDs)
CRD_KINDS = (
    "PodCliqueSet",
    "PodClique",
    "PodCliqueScalingGroup",
    "ClusterTopology",
    "PodGang",
    "Queue",
)


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


def _schema_for(hint: Any, depth: int = 0) -> Dict[str, Any]:
    if depth > 12:  # defensive: no recursive types in the model
        return {"x-kubernetes-preserve-unknown-fields": True}
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _schema_for(args[0], depth) if args else {}
    if origin in (list, typing.List):
        (item,) = typing.get_args(hint) or (Any,)
        return {"type": "array", "items": _schema_for(item, depth + 1)}
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        val = args[1] if len(args) == 2 else Any
        if val is Any:
            return {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
        return {
            "type": "object",
            "additionalProperties": _schema_for(val, depth + 1),
        }
    if dataclasses.is_dataclass(hint):
        hints = typing.get_type_hints(hint)
        props = {}
        for f in dataclasses.fields(hint):
            if f.name == "kind":
                continue
            props[_camel(f.name)] = _schema_for(hints[f.name], depth + 1)
        return {"type": "object", "properties": props}
    if hint is bool:
        return {"type": "boolean"}
    if hint is int:
        return {"type": "integer"}
    if hint is float:
        # quantities/durations arrive as strings in user manifests
        return {"x-kubernetes-int-or-string": True}
    if hint is str:
        return {"type": "string"}
    return {"x-kubernetes-preserve-unknown-fields": True}


def generate_crd(kind: str) -> Dict[str, Any]:
    info: KindInfo = KIND_REGISTRY[kind]
    hints = typing.get_type_hints(info.cls)
    spec_schema = (
        _schema_for(hints["spec"]) if "spec" in hints else {"type": "object"}
    )
    status_schema = (
        _schema_for(hints["status"])
        if "status" in hints
        else {"type": "object", "x-kubernetes-preserve-unknown-fields": True}
    )
    versions = [
        {
            "name": info.version,
            "served": True,
            "storage": True,
            "subresources": {"status": {}},
            "schema": {
                "openAPIV3Schema": {
                    "type": "object",
                    "properties": {
                        "apiVersion": {"type": "string"},
                        "kind": {"type": "string"},
                        "metadata": {"type": "object"},
                        "spec": spec_schema,
                        "status": status_schema,
                    },
                }
            },
        }
    ]
    singular = kind.lower()
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{info.plural}.{info.group}"},
        "spec": {
            "group": info.group,
            "names": {
                "kind": kind,
                "listKind": f"{kind}List",
                "plural": info.plural,
                "singular": singular,
            },
            "scope": "Namespaced" if info.namespaced else "Cluster",
            "versions": versions,
        },
    }


def render_crds(kinds=CRD_KINDS) -> str:
    docs = [generate_crd(k) for k in kinds]
    return "\n---\n".join(
        yaml.safe_dump(d, sort_keys=False, default_flow_style=False)
        for d in docs
    )


def write_crds(directory: str, kinds=CRD_KINDS) -> List[str]:
    import pathlib

    out = []
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for kind in kinds:
        crd = generate_crd(kind)
        path = d / f"{crd['metadata']['name']}.yaml"
        path.write_text(yaml.safe_dump(crd, sort_keys=False, default_flow_style=False))
        out.append(str(path))
    return out
