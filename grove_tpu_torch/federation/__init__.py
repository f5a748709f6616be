"""Multi-cluster federation tier.

Counterpart of ``grove_tpu/federation``.

A :class:`FederationRouter` owns K independent simulated clusters —
each a full ``SimHarness`` with its own store shards, WAL dir, quota
accountant, monitor/broker/drainer, and optional workers — and places
incoming PodGangs across them: home-cluster affinity first, spillover
when the home cluster's explain verdict says it cannot admit now,
candidate targets ranked by the frontier-style (headroom,
fragmentation delta, queue age) score in global DRF order, and
cross-cluster tenant quota as a level-3 fold over the per-cluster
accountants (:class:`GlobalQuotaFold`, the ShardSummaryTree idiom one
level up).
"""

from grove_tpu_torch.federation.quota import GlobalQuotaFold
from grove_tpu_torch.federation.router import (
    FederatedCluster,
    FederationRouter,
    federation_artifact,
)

__all__ = [
    "FederatedCluster",
    "FederationRouter",
    "GlobalQuotaFold",
    "federation_artifact",
]
