"""YAML loading for reference-format manifests.

Counterpart of ``grove_tpu/api/load.py``.

Accepts the exact CR format of the reference samples
(reference operator/samples/simple/simple1.yaml etc.), so a Grove user
can apply their manifests unchanged.
"""

from __future__ import annotations

from typing import List

import yaml

from grove_tpu_torch.api.types import PodCliqueSet


def load_podcliquesets(text: str) -> List[PodCliqueSet]:
    out: List[PodCliqueSet] = []
    for doc in yaml.safe_load_all(text):
        if not doc:
            continue
        kind = doc.get("kind")
        if kind != "PodCliqueSet":
            raise ValueError(f"unsupported kind {kind!r}")
        out.append(PodCliqueSet.from_dict(doc))
    return out


def load_podcliqueset_file(path: str) -> PodCliqueSet:
    with open(path) as f:
        sets = load_podcliquesets(f.read())
    if len(sets) != 1:
        raise ValueError(f"{path}: expected exactly one PodCliqueSet, got {len(sets)}")
    return sets[0]


def load_manifest_objects(text: str) -> list:
    """Multi-doc manifest → typed objects for ANY wire-registered kind.

    PodCliqueSet keeps the hand-written ``from_dict`` path (the compat
    contract with reference-format manifests); every other kind —
    ClusterTopology, PodGang, ... — decodes through the wire kind
    registry. Offline consumers (CLI validate/apply, tests) share this so
    mixed-kind manifests behave identically everywhere.
    """
    from grove_tpu_torch.api.wire import decode_object

    out = []
    for doc in yaml.safe_load_all(text):
        if not doc:
            continue
        if doc.get("kind") == "PodCliqueSet":
            out.append(PodCliqueSet.from_dict(doc))
        else:
            out.append(decode_object(doc))
    return out
