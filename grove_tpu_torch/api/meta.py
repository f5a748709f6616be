"""Object metadata, owner references, conditions and resource quantities.

Counterpart of ``grove_tpu/api/meta.py``. Timestamps are float seconds from
an injectable clock. Uids carry a per-incarnation token
(``uid-<token>-<n>``): ``api/hashing.py`` caches template hashes keyed on
``(uid, generation)``, so a restarted sequence must never hand out a uid an
earlier incarnation used (``reset_uid_namespace``).
"""

from __future__ import annotations

import copy
import itertools
import pickle
import re
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# ---------------------------------------------------------------------------
# Resource quantities
# ---------------------------------------------------------------------------

_QTY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)([a-zA-Z]*)$")

_SUFFIX = {
    "": 1.0,
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "Ki": 2.0**10,
    "Mi": 2.0**20,
    "Gi": 2.0**30,
    "Ti": 2.0**40,
    "Pi": 2.0**50,
}


def parse_quantity(value: Any) -> float:
    """Parse a k8s-style resource quantity ('10m', '4Gi', 2, '2') into a float.

    Mirrors the subset of resource.Quantity the reference samples use
    (reference operator/samples/simple/simple1.yaml requests cpu '10m').
    """
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {value!r}")
    num, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"invalid quantity suffix: {value!r}")
    return float(num) * _SUFFIX[suffix]


def parse_resource_map(raw: Optional[Dict[str, Any]]) -> Dict[str, float]:
    return {k: parse_quantity(v) for k, v in (raw or {}).items()}


# ---------------------------------------------------------------------------
# Conditions
# ---------------------------------------------------------------------------


@dataclass
class Condition:
    """metav1.Condition equivalent (type/status/reason/message/lastTransitionTime)."""

    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0

    def is_true(self) -> bool:
        return self.status == "True"


def get_condition(conditions: List[Condition], ctype: str) -> Optional[Condition]:
    for c in conditions:
        if c.type == ctype:
            return c
    return None


def set_condition(conditions: List[Condition], new: Condition, now: float) -> bool:
    """Upsert, bumping last_transition_time only on status change.

    Mirrors apimachinery meta.SetStatusCondition, which the reference uses for
    MinAvailableBreached / PodCliqueScheduled breach-age computation
    (gangterminate.go computes breach duration from lastTransitionTime).
    Returns True if the condition changed.
    """
    existing = get_condition(conditions, new.type)
    if existing is None:
        new.last_transition_time = now
        conditions.append(new)
        return True
    changed = (
        existing.status != new.status
        or existing.reason != new.reason
        or existing.message != new.message
    )
    if existing.status != new.status:
        existing.last_transition_time = now
    existing.status = new.status
    existing.reason = new.reason
    existing.message = new.message
    return changed


# ---------------------------------------------------------------------------
# ObjectMeta
# ---------------------------------------------------------------------------

_uid_counter = itertools.count(1)
# Store-incarnation token: purely sequential uids repeat across apiserver
# restarts, so an operator surviving a restart (HttpStore reconnect) could
# see a RE-created object reuse a (uid, generation) pair and serve a stale
# cached template hash (api/hashing.py keys on exactly that pair — wrong
# pod-template-hash labels, missed rolling updates). The random token makes
# uids unique per store incarnation, like k8s's uuid-based object UIDs.
_UID_TOKEN = uuid.uuid4().hex[:8]


def next_uid() -> str:
    return f"uid-{_UID_TOKEN}-{next(_uid_counter)}"


def reset_uid_namespace() -> None:
    """Restart the uid sequence under a FRESH incarnation token.

    The only sanctioned way to reset `_uid_counter`: resetting the
    counter alone re-creates (uid, generation) pairs, and every
    process-global memo keyed on them (api/hashing.py's template-hash
    cache) would serve another incarnation's stale value — observed as a
    wrong currentGenerationHash in a later harness when the cache was
    warm enough that the colliding entry survived eviction. Rotating the
    token keeps restarted sequences disjoint, exactly like a store
    restart does."""
    global _uid_counter, _UID_TOKEN
    _uid_counter = itertools.count(1)
    _UID_TOKEN = uuid.uuid4().hex[:8]


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str = ""
    controller: bool = True


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    generation: int = 0
    resource_version: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)

    def controller_owner(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None


@dataclass(frozen=True, order=True)
class NamespacedName:
    """scheduler/api/core/v1alpha1/podgang.go:129-137 equivalent."""

    namespace: str
    name: str

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        return f"{self.namespace}/{self.name}"


def clone_status(status):
    """Cheap private clone of a status object for a condition-writing flow:
    shallow copy plus PRIVATE Condition copies. Safe because status flows
    only REPLACE fields by assignment or call set_condition (which mutates
    Condition objects and appends to the conditions list) — a flow that
    mutates any OTHER nested status field in place (e.g. container
    statuses) must use deep_copy instead. An order of magnitude cheaper
    than the pickled deep copy on the per-reconcile status hot path."""
    st = copy.copy(status)
    st.conditions = [copy.copy(c) for c in status.conditions]
    return st


def deep_copy(obj):
    """Deep-copy an API object. pickle round-trip is several times faster
    than copy.deepcopy for plain dataclass trees (the store copies on every
    read/write, so this is the control plane's hottest function)."""
    try:
        return pickle.loads(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:
        return copy.deepcopy(obj)
