"""QuotaManager: the scheduler-facing face of the quota subsystem.

Counterpart of ``grove_tpu/quota/manager.py``: owns the usage accountant,
reads the queue tree, holds gangs past their queue's ceiling, and runs the
DRF ordering pass (``ordering.fair_order``, on the scheduler's device) that
replaces the flat ``(-priority, name)`` sort when Queue CRs exist. With no
Queue CRs the order is exactly the flat sort. ``warm`` grows the padded
shape ahead of a workload and runs the pass once at it (the JAX package
compiles its scan there; here the DRF kernels build and load, and each
launches once). ``quota_snapshot`` is the full-scan per-queue summary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import get_condition
from grove_tpu_torch.api.types import COND_PODGANG_SCHEDULED, DEFAULT_QUEUE
from grove_tpu_torch.quota.accountant import QuotaAccountant
from grove_tpu_torch.quota.oracle import dominant_share, dominant_share_of, usage_oracle
from grove_tpu_torch.quota.ordering import fair_order

_EPS = 1e-9


def _flat_key(spec: dict):
    """The order without quota: priority first, then name."""
    return (-spec["priority"], spec["name"])


def spec_demand(spec: dict) -> Dict[str, float]:
    """Resources a gang charges its queue when admitted: per-pod demand x
    pod count, summed over its groups."""
    out: Dict[str, float] = {}
    for group in spec["groups"]:
        for r, v in group["demand"].items():
            out[r] = out.get(r, 0.0) + v * group["count"]
    return out


def _pow2(n: int, floor: int = 1) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


class QuotaManager:
    def __init__(self, store, default_queue: str = DEFAULT_QUEUE, device=None) -> None:
        self.store = store
        self.default_queue = default_queue
        self.device = device  # where the ordering scan runs
        self.accountant = QuotaAccountant(default_queue)
        # a sharded store delivers per shard: a pod's events never
        # straddle shards, so the per-queue fold stays exact
        if getattr(store, "num_shards", 1) > 1:
            store.subscribe_system_per_shard(self.accountant.on_event)
        else:
            store.subscribe_system(self.accountant.on_event)
        # last ordering pass's per-queue rows (status writes)
        self.last_rows: List[dict] = []
        # sticky padding, as in the JAX package: the scan's shape grows to
        # the widest seen and never shrinks
        self._pad_q = 1
        self._pad_g = 1
        self._pad_r = 1

    def queue_crs(self) -> Dict[str, object]:
        """name -> readonly Queue CR."""
        return {q.metadata.name: q for q in self.store.scan("Queue")}

    def active(self) -> bool:
        for _ in self.store.scan("Queue"):
            return True
        return False

    def _usage_snapshot(self) -> Dict[str, Dict[str, float]]:
        self.accountant.ensure_built(self.store)
        return self.accountant.snapshot()

    def warm(self, n_queues: int, n_gangs: int, n_resources: int = 1) -> None:
        """Grow the padded shape to what this workload will reach and run
        the ordering pass once at it, so the kernels' build and load land
        outside the measured rounds."""
        self._pad_q = max(self._pad_q, _pow2(max(n_queues, 1)))
        self._pad_g = max(self._pad_g, _pow2(max(n_gangs, 1)))
        self._pad_r = max(self._pad_r, _pow2(max(n_resources, 1)))
        fair_order(
            np.zeros((self._pad_q, self._pad_r), np.float32),
            np.zeros((self._pad_q, self._pad_r), np.float32),
            np.zeros((self._pad_q, self._pad_g, self._pad_r), np.float32),
            np.ones((self._pad_q,), np.int32),
            device=self.device,
        )

    def order_specs(
        self,
        gang_specs: List[dict],
        crs: Optional[Dict[str, object]] = None,
        usage: Optional[Dict[str, Dict[str, float]]] = None,
        record_rows: bool = True,
    ) -> Tuple[List[dict], List[Tuple[dict, str]]]:
        """The gang solve order. Returns (ordered_specs, held): held is
        [(spec, reason)] for gangs whose queue is at its ceiling.
        ``crs``/``usage`` replace the live queue tree and usage (the
        explain engine's what-if trials). ``record_rows=False`` leaves
        ``last_rows``, the rows the round's status writer reads, alone."""
        if crs is None:
            crs = self.queue_crs()
        if not crs:
            if record_rows:
                self.last_rows = []
            return sorted(gang_specs, key=_flat_key), []

        if usage is None:
            usage = self._usage_snapshot()
        # pending gangs per queue, the flat order inside each
        buckets: Dict[str, List[dict]] = {}
        for spec in gang_specs:
            buckets.setdefault(spec["queue"], []).append(spec)
        for bucket in buckets.values():
            bucket.sort(key=_flat_key)

        # ceiling holds (best-effort FIFO: a gang that would cross the cap
        # is held; smaller gangs behind it may still pass)
        held: List[Tuple[dict, str]] = []
        for name, bucket in buckets.items():
            cr = crs.get(name)
            ceiling = cr.spec.ceiling if cr is not None else {}
            if not ceiling:
                continue
            cum = dict(usage.get(name, {}))
            kept = []
            for spec in bucket:
                demand = spec_demand(spec)
                over = [
                    r
                    for r, cap in ceiling.items()
                    if cum.get(r, 0.0) + demand.get(r, 0.0) > cap + _EPS
                ]
                if over:
                    held.append(
                        (spec, f"queue {name} at ceiling for {'/'.join(sorted(over))}")
                    )
                    continue
                kept.append(spec)
                for r, v in demand.items():
                    cum[r] = cum.get(r, 0.0) + v
            buckets[name] = kept

        # dense tensors: queues by name (the argmin's tie-break), resources
        # by name; shapes padded to powers of two
        names = sorted(set(crs) | set(buckets))
        # resources: deserved, pending demand and held usage (a queue that
        # holds a resource nobody deserves still pays usage*BIG for it)
        resources = sorted(
            {r for cr in crs.values() for r in cr.spec.deserved}
            | {r for bucket in buckets.values() for spec in bucket for r in spec_demand(spec)}
            | {r for name in names for r in usage.get(name, {})}
        ) or ["cpu"]
        self._pad_q = q_dim = max(self._pad_q, _pow2(len(names)))
        self._pad_r = r_dim = max(self._pad_r, _pow2(len(resources)))
        self._pad_g = g_dim = max(
            self._pad_g, _pow2(max((len(b) for b in buckets.values()), default=0))
        )
        deserved = np.zeros((q_dim, r_dim), np.float32)
        usage_t = np.zeros((q_dim, r_dim), np.float32)
        demand_t = np.zeros((q_dim, g_dim, r_dim), np.float32)
        counts = np.zeros((q_dim,), np.int32)
        r_index = {r: i for i, r in enumerate(resources)}
        for qi, name in enumerate(names):
            cr = crs.get(name)
            if cr is not None:
                for r, v in cr.spec.deserved.items():
                    deserved[qi, r_index[r]] = v
            for r, v in usage.get(name, {}).items():
                usage_t[qi, r_index[r]] = v
            bucket = buckets.get(name, [])
            counts[qi] = len(bucket)
            for gi, spec in enumerate(bucket):
                for r, v in spec_demand(spec).items():
                    demand_t[qi, gi, r_index[r]] = v

        order = fair_order(deserved, usage_t, demand_t, counts, device=self.device)
        ordered = [buckets[names[qi]][slot] for qi, slot in order]

        # per-queue rows for the status writes (pre-round shares); pending
        # counts ceiling-held gangs too
        held_by_queue: Dict[str, int] = {}
        for spec, _reason in held:
            held_by_queue[spec["queue"]] = held_by_queue.get(spec["queue"], 0) + 1
        shares = dominant_share(usage_t[: len(names)], deserved[: len(names)])
        rows = [
            {
                "name": name,
                "cr": crs.get(name),
                "dominant_share": float(shares[qi]),
                "usage": dict(usage.get(name, {})),
                "pending": int(counts[qi]) + held_by_queue.get(name, 0),
            }
            for qi, name in enumerate(names)
        ]
        if record_rows:
            self.last_rows = rows
        return ordered, held


def quota_snapshot(store, default_queue: str = DEFAULT_QUEUE) -> List[dict]:
    """Full-scan per-queue summary: deserved and ceiling from the Queue
    CRs, usage from the pod population, admitted and pending gangs from
    the PodGangs' Scheduled condition. Includes implicit queues (usage or
    gangs without a Queue CR)."""
    crs = {q.metadata.name: q for q in store.scan("Queue")}
    usage = usage_oracle(store.scan("Pod"), default_queue)
    admitted: Dict[str, int] = {}
    pending: Dict[str, int] = {}
    for gang in store.scan("PodGang"):
        queue = gang.metadata.labels.get(namegen.LABEL_QUEUE) or default_queue
        cond = get_condition(gang.status.conditions, COND_PODGANG_SCHEDULED)
        if cond is not None and cond.is_true():
            admitted[queue] = admitted.get(queue, 0) + 1
        else:
            pending[queue] = pending.get(queue, 0) + 1
    out = []
    for name in sorted(set(crs) | set(usage) | set(admitted) | set(pending)):
        cr = crs.get(name)
        deserved = dict(cr.spec.deserved) if cr is not None else {}
        out.append(
            {
                "name": name,
                "parent": cr.spec.parent if cr is not None else "",
                "defined": cr is not None,
                "deserved": deserved,
                "ceiling": dict(cr.spec.ceiling) if cr is not None else {},
                "usage": dict(usage.get(name, {})),
                "dominantShare": dominant_share_of(usage.get(name, {}), deserved),
                "admittedGangs": admitted.get(name, 0),
                "pendingGangs": pending.get(name, 0),
            }
        )
    return out
