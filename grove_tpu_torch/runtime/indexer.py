"""Stable pod hostname index allocation.

Counterpart of ``grove_tpu/runtime/indexer.py``.

Re-host of reference operator/internal/index/tracker.go:32-108: pods of
a clique get stable hostnames `<pclq>-<N>`; indices freed by inactive pods are
reused (lowest hole first); duplicate active indices are an error.
"""

from __future__ import annotations

import re
from typing import Iterable, List

from grove_tpu_torch.runtime.errors import GroveError

ERR_DUPLICATE_INDEX = "ERR_DUPLICATE_POD_INDEX"


def parse_index(pclq_name: str, pod_name: str) -> int:
    """Extract N from `<pclq>-<N>`; -1 if the name doesn't match."""
    m = re.fullmatch(re.escape(pclq_name) + r"-(\d+)", pod_name)
    return int(m.group(1)) if m else -1


def active_indices(pclq_name: str, active_pod_names: Iterable[str]) -> List[int]:
    indices: List[int] = []
    seen = set()
    for name in active_pod_names:
        idx = parse_index(pclq_name, name)
        if idx < 0:
            continue
        if idx in seen:
            raise GroveError(
                ERR_DUPLICATE_INDEX,
                f"duplicate active pod index {idx} in clique {pclq_name}",
                "allocate-index",
            )
        seen.add(idx)
        indices.append(idx)
    return sorted(indices)


def allocate_indices(
    pclq_name: str, active_pod_names: Iterable[str], count: int
) -> List[int]:
    """Lowest `count` free indices, filling holes first (tracker.go:62-108)."""
    used = set(active_indices(pclq_name, active_pod_names))
    out: List[int] = []
    candidate = 0
    while len(out) < count:
        if candidate not in used:
            out.append(candidate)
        candidate += 1
    return out
