"""PCS replica component: gang termination.

Counterpart of ``grove_tpu/controller/podcliqueset/components/replica.py``.

Re-host of reference operator/internal/controller/podcliqueset/components/
podcliquesetreplica/gangterminate.go:42-213: a PCS replica whose standalone
PCLQ or PCSG has had MinAvailableBreached=True for longer than
TerminationDelay gets ALL its PodCliques deleted (gang-level restart — the
normal sync then recreates them); otherwise requeue with the minimum
remaining wait.
"""

from __future__ import annotations

from typing import List, Optional

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import get_condition
from grove_tpu_torch.api.types import COND_MIN_AVAILABLE_BREACHED, PodCliqueSet
from grove_tpu_torch.controller.common import OperatorContext


def sync(ctx: OperatorContext, pcs: PodCliqueSet, snap=None) -> Optional[float]:
    """Returns the minimum remaining breach wait (requeue hint) or None.
    ``snap``: the reconcile's shared ChildSnapshot (one informer fetch per
    reconcile under cache lag) — None falls back to per-replica scans."""
    delay = pcs.spec.template.termination_delay or 0.0
    now = ctx.clock.now()
    min_wait: Optional[float] = None
    for replica in range(pcs.spec.replicas):
        since = _replica_breach_since(ctx, pcs, replica, snap)
        if since is None:
            continue
        age = now - since
        if age >= delay:
            _terminate_replica(ctx, pcs, replica)
        else:
            remaining = delay - age
            min_wait = remaining if min_wait is None else min(min_wait, remaining)
    return min_wait


def _replica_breach_since(
    ctx: OperatorContext, pcs: PodCliqueSet, replica: int, snap=None
) -> Optional[float]:
    """Earliest still-True breach among the replica's standalone PCLQs and its
    PCSGs (gangterminate.go:67-105; PCSG aggregation covers base replicas)."""
    ns = pcs.metadata.namespace
    breach_times: List[float] = []
    if snap is not None:
        standalone = snap.pclqs_for_replica(
            replica, namegen.COMPONENT_PCS_PODCLIQUE
        )
        pcsgs = snap.pcsgs_for_replica(replica)
    else:
        standalone = ctx.store.scan(
            "PodClique",
            ns,
            {
                **namegen.default_labels(pcs.metadata.name),
                namegen.LABEL_COMPONENT: namegen.COMPONENT_PCS_PODCLIQUE,
                namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
            },
            cached=True,
        )
        pcsgs = ctx.store.scan(
            "PodCliqueScalingGroup",
            ns,
            {
                **namegen.default_labels(pcs.metadata.name),
                namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
            },
            cached=True,
        )
    for pclq in standalone:
        cond = get_condition(pclq.status.conditions, COND_MIN_AVAILABLE_BREACHED)
        if cond is not None and cond.is_true():
            breach_times.append(cond.last_transition_time)
    for pcsg in pcsgs:
        cond = get_condition(pcsg.status.conditions, COND_MIN_AVAILABLE_BREACHED)
        if cond is not None and cond.is_true():
            breach_times.append(cond.last_transition_time)
    return min(breach_times) if breach_times else None


def _terminate_replica(ctx: OperatorContext, pcs: PodCliqueSet, replica: int) -> None:
    """DeleteAllOf PodCliques for the replica (gangterminate.go:190-213)."""
    ns = pcs.metadata.namespace
    n = ctx.store.delete_collection(
        "PodClique",
        ns,
        {
            **namegen.default_labels(pcs.metadata.name),
            namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
        },
    )
    ctx.record_event(
        "PodCliqueSet",
        "GangTerminated",
        f"{pcs.metadata.name} replica {replica}: deleted {n} PodCliques",
        namespace=ns,
        name=pcs.metadata.name,
    )
