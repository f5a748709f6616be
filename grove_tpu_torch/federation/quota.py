"""Cross-cluster tenant quota: the level-3 fold.

Counterpart of ``grove_tpu/federation/quota.py``.

Level 1 is the per-shard pod aggregate, level 2 the per-store
``ShardSummaryTree`` (runtime/shards.py) — this is the same idiom one
level up: each CLUSTER's quota accountant snapshot (queue → resource →
usage) is a leaf partial, folded upward with fan-in ``FOLD_FAN_IN`` so
no fold at any level sees more than ``fan_in`` rows and a global
usage read is O(K) over partials, never a scan of any cluster's pod
population. The root is what makes a tenant's deserved share GLOBAL:
the router feeds it as the ``usage`` argument to the DRF ordering, so
a tenant saturated in one region is ordered behind hungrier tenants
everywhere (docs/federation.md "Global quota fold").
"""

from __future__ import annotations

from typing import Dict, List

from grove_tpu_torch.runtime.shards import FOLD_FAN_IN

# queue → resource → usage; the shape accountant.snapshot() returns
QuotaPartial = Dict[str, Dict[str, float]]


def _merge(rows: List[QuotaPartial]) -> QuotaPartial:
    out: QuotaPartial = {}
    for row in rows:
        for queue, usage in row.items():
            acc = out.setdefault(queue, {})
            for res, val in usage.items():
                acc[res] = acc.get(res, 0.0) + val
    return out


class GlobalQuotaFold:
    """Level-3 hierarchical fold over per-cluster quota partials."""

    __slots__ = ("num_clusters", "fan_in", "levels")

    def __init__(self, num_clusters: int, fan_in: int = FOLD_FAN_IN) -> None:
        self.num_clusters = max(1, num_clusters)
        self.fan_in = max(2, fan_in)
        # levels[0] = per-cluster leaves, levels[-1] = single root
        self.levels: List[List[QuotaPartial]] = []
        width = self.num_clusters
        while True:
            self.levels.append([{} for _ in range(width)])
            if width == 1:
                break
            width = (width + self.fan_in - 1) // self.fan_in

    @property
    def depth(self) -> int:
        return len(self.levels)

    def refold(self, partials: List[QuotaPartial]) -> None:
        """Fold fresh leaf partials up the tree (one call per router
        scoring round — O(K) over partials)."""
        self.levels[0] = list(partials)
        for li in range(1, len(self.levels)):
            below = self.levels[li - 1]
            level = []
            # each parent folds at most fan_in children
            for i in range(0, len(below), self.fan_in):
                level.append(_merge(below[i : i + self.fan_in]))
            self.levels[li] = level

    def update_leaf(self, index: int, partial: QuotaPartial) -> None:
        """Path refold: one cluster's accountant moved — refold only its
        ancestor chain, O(depth × fan_in) instead of O(K)."""
        self.levels[0][index] = partial
        child = index
        for li in range(1, len(self.levels)):
            parent = child // self.fan_in
            base = parent * self.fan_in
            below = self.levels[li - 1]
            self.levels[li][parent] = _merge(below[base : base + self.fan_in])
            child = parent

    def root(self) -> QuotaPartial:
        return self.levels[-1][0]

    def fold_depth_histogram(self) -> List[int]:
        """Nodes per fold level, leaves first — the proof the global
        usage read is a tree fold, not a flat rescan."""
        return [len(level) for level in self.levels]
