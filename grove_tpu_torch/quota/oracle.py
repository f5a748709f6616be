"""Reference oracle: plain-numpy fair-share ordering and usage accounting.

Counterpart of ``grove_tpu/quota/oracle.py``: a loop over the same float32
operations as the ordering scan, so the two are bit-equal.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.pod import is_scheduled, is_terminating
from grove_tpu_torch.quota.ordering import BIG


def dominant_share(usage: np.ndarray, deserved: np.ndarray) -> np.ndarray:
    """[Q] dominant shares from [Q, R] float32 tensors (usage/deserved
    where entitled, usage*BIG where zero-deserved)."""
    usage = np.asarray(usage, np.float32)
    deserved = np.asarray(deserved, np.float32)
    safe = np.where(deserved > 0, deserved, np.float32(1.0))
    share = np.where(deserved > 0, usage / safe, usage * BIG)
    if share.ndim == 2 and share.shape[1]:
        return share.max(axis=1)
    return np.zeros((share.shape[0],), np.float32)


def dominant_share_of(usage: Dict[str, float], deserved: Dict[str, float]) -> float:
    """One queue's dominant share from resource dicts, over the union of
    their resources."""
    resources = sorted(set(usage) | set(deserved))
    if not resources:
        return 0.0
    u = np.array([[usage.get(r, 0.0) for r in resources]], np.float32)
    d = np.array([[deserved.get(r, 0.0) for r in resources]], np.float32)
    return float(dominant_share(u, d)[0])


def fair_order_oracle(
    deserved: np.ndarray,  # [Q, R]
    usage: np.ndarray,  # [Q, R]
    demand: np.ndarray,  # [Q, G, R]
    counts: np.ndarray,  # [Q]
) -> np.ndarray:
    """Sequential greedy ordering, one queue pick per step: the same
    [T, 2] int32 (queue, slot) rows as ``ordering.fair_order``."""
    deserved = np.asarray(deserved, np.float32)
    u = np.array(usage, np.float32, copy=True)
    demand = np.asarray(demand, np.float32)
    counts = np.asarray(counts, np.int64)
    q_dim = deserved.shape[0]
    taken = np.zeros((q_dim,), np.int64)
    out: List[Tuple[int, int]] = []
    for _ in range(int(counts.sum())):
        dom = dominant_share(u, deserved)
        active = taken < counts
        if not active.any():
            break
        key = np.where(active, dom, np.float32(np.inf))
        q = int(np.argmin(key))
        slot = int(taken[q])
        out.append((q, slot))
        if demand.ndim == 3 and demand.shape[2]:
            u[q] = u[q] + demand[q, slot]
        taken[q] += 1
    return np.array(out, dtype=np.int32).reshape(-1, 2)


def usage_oracle(pods, default_queue: str) -> Dict[str, Dict[str, float]]:
    """Per-queue usage by a full rescan: every bound, non-terminating pod
    adds its requests to its queue."""
    out: Dict[str, Dict[str, float]] = {}
    for pod in pods:
        if not is_scheduled(pod) or is_terminating(pod):
            continue
        queue = pod.metadata.labels.get(namegen.LABEL_QUEUE) or default_queue
        acc = out.setdefault(queue, {})
        for r, v in pod.spec.total_requests().items():
            acc[r] = acc.get(r, 0.0) + v
    return out
