"""Object metadata, conditions and resource quantities.

Counterpart of ``grove_tpu/api/meta.py``, cut to what the scheduler round
reads and writes. Timestamps are float seconds from an injectable clock.
"""

from __future__ import annotations

import copy
import itertools
import pickle
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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
    """A Kubernetes resource quantity ('10m', '4Gi', 2, '2') as a float."""
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


@dataclass
class Condition:
    """metav1.Condition (type/status/reason/message/lastTransitionTime)."""

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
    """Upsert, moving last_transition_time only when the status changes
    (apimachinery's SetStatusCondition). Returns True if anything changed."""
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


_uid_counter = itertools.count(1)


def next_uid() -> str:
    return f"uid-{next(_uid_counter)}"


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


@dataclass(frozen=True, order=True)
class NamespacedName:
    namespace: str
    name: str


def clone_status(status):
    """Private clone of a status for a condition-writing flow: a shallow
    copy with private Condition copies (flows only replace fields or call
    set_condition)."""
    st = copy.copy(status)
    st.conditions = [copy.copy(c) for c in status.conditions]
    return st


def deep_copy(obj):
    """Deep copy of an API object (a pickle round trip)."""
    try:
        return pickle.loads(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
    except Exception:
        return copy.deepcopy(obj)
