"""PodClique pod component: create/delete/ungate pods.

Counterpart of ``grove_tpu/controller/podclique/pods.py``.

Re-host of reference operator/internal/controller/podclique/components/pod/
(pod.go, syncflow.go, initcontainer.go):
- pods are created WITH the `grove.io/podgang-pending-creation` scheduling gate
- identity env vars + stable hostname `<pclq>-<idx>` via the index allocator
- replica diff folds the expectations store over the (possibly stale) cache
- the gate is removed only when (1) the pod is referenced by its PodGang and
  (2) for scaled gangs, the base PodGang is scheduled (syncflow.go:242-387)
- excess pods are deleted worst-first (DeletionSorter equivalent)
"""

from __future__ import annotations

import copy
import json
from typing import List, Optional

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.pod import (
    Pod,
    is_ready,
    is_schedule_gated,
    is_scheduled,
    is_terminating,
)
from grove_tpu_torch.api.types import (
    PODGANG_SCHEDULING_GATE,
    PodClique,
    PodGang,
)
from grove_tpu_torch.controller.common import OperatorContext
from grove_tpu_torch.runtime import indexer
from grove_tpu_torch.runtime.store import commit_spec

STARTUP_DEPS_ANNOTATION = "grove.io/startup-dependencies"  # JSON on the PCLQ


def owner_pcs_name(pclq: PodClique) -> str:
    return pclq.metadata.labels.get(namegen.LABEL_PART_OF, "")


def sync_pods(
    ctx: OperatorContext, pclq: PodClique, pods, base_sched_memo=None
) -> int:
    """Create/delete pods to match spec.replicas; returns pods still gated.

    ``pods``: the reconciler's pre-scanned pod list (read-only views),
    shared between this flow and the gate pass — both always decided
    against the pre-sync snapshot (the replica diff covers in-flight
    creates via expectations), so sharing one scan is behavior-identical
    and halves the per-reconcile scan cost (one LIST instead of two in
    HttpStore cluster mode).

    ``base_sched_memo``: optional per-drain-batch memo for the base-gang-
    scheduled check — scaled PCLQs of one set share a base gang, and under
    cache lag the cached view is frozen for the whole round, so one check
    serves every sibling in the batch."""
    ns = pclq.metadata.namespace
    cached_pods = [p for p in pods if not is_terminating(p)]
    observed_uids = [p.metadata.uid for p in cached_pods]
    key = f"{ns}/{pclq.metadata.name}"
    pending_creates, pending_deletes = ctx.pod_expectations.pending(key, observed_uids)

    # diff = existing + expectedCreates − desired − expectedDeletes
    # (syncflow.go:171-186)
    diff = (
        len(cached_pods)
        + len(pending_creates)
        - pclq.spec.replicas
        - len(pending_deletes)
    )
    created_pods: List[Pod] = []
    if diff < 0:
        created_pods = _create_pods(ctx, pclq, -diff, cached_pods)
    elif diff > 0:
        _delete_excess_pods(ctx, pclq, diff, cached_pods, pending_deletes)

    _process_pending_updates(ctx, pclq, cached_pods, pending_deletes)

    # Pods created THIS reconcile are born schedule-gated and may not be
    # visible to the cached gate scan yet (informer lag) — feed their fresh
    # store copies straight into the gate pass: a pod recreated while its
    # gang is already scheduled ungates IN THIS reconcile instead of waiting
    # out the GATE_RETRY_SECONDS requeue. Pods the gang does not reference yet still count as
    # gated, so the reconciler schedules the gate-retry requeue — without
    # that, a creating reconcile could return "all clear" and, with
    # pod-ADDED events predicate-filtered (reference podPredicate
    # CreateFunc=false, podclique/register.go:102), nothing would ever
    # revisit the gate.
    return _remove_scheduling_gates(
        ctx, pclq, cached_pods + created_pods, base_sched_memo
    )


def _process_pending_updates(
    ctx: OperatorContext, pclq: PodClique, pods, pending_deletes
) -> None:
    """Pod-by-pod rolling replacement (components/pod/rollingupdate.go:55-244):
    pods whose template hash doesn't match the PCLQ's are replaced — all
    not-ready stale pods at once, then ready pods ONE at a time, each only
    after the previous replacement is Ready again."""
    current_hash = pclq.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH)
    if not current_hash:
        return
    ns = pclq.metadata.namespace
    key = f"{ns}/{pclq.metadata.name}"
    # refresh delete expectations: scale-in may have recorded deletions in
    # this same sync pass (stale snapshot would allow a double replacement)
    _, pending_deletes = ctx.pod_expectations.pending(
        key, [p.metadata.uid for p in pods]
    )
    live = [p for p in pods if p.metadata.uid not in pending_deletes]
    stale = [
        p
        for p in live
        if p.metadata.labels.get(namegen.LABEL_POD_TEMPLATE_HASH) != current_hash
    ]
    if not stale:
        return

    not_ready_stale = [p for p in stale if not is_ready(p)]
    if not_ready_stale:
        # pending/unhealthy stale pods carry no availability — replace at once
        for pod in not_ready_stale:
            ctx.pod_expectations.expect_deletions(key, [pod.metadata.uid])
            ctx.store.delete("Pod", ns, pod.metadata.name)
            ctx.record_event(
                "Pod",
                "PodUpdateDeleteSuccessful",
                pod.metadata.name,
                namespace=ns,
                name=pod.metadata.name,
            )
        return

    # every pod is ready; only proceed when no replacement is still missing
    # (one in-flight replacement at a time)
    if len(live) < pclq.spec.replicas or not all(is_ready(p) for p in live):
        return
    victim = sorted(stale, key=deletion_order)[0]
    ctx.pod_expectations.expect_deletions(key, [victim.metadata.uid])
    ctx.store.delete("Pod", ns, victim.metadata.name)
    ctx.record_event(
        "Pod",
        "PodUpdateDeleteSuccessful",
        victim.metadata.name,
        namespace=ns,
        name=victim.metadata.name,
    )


def _create_pods(
    ctx: OperatorContext, pclq: PodClique, count: int, existing: List[Pod]
) -> List[Pod]:
    """Create `count` pods; returns the created store copies so the caller's
    gate pass can consider them in the same reconcile."""
    from grove_tpu_torch.runtime.errors import GroveError
    from grove_tpu_torch.utils.concurrent import Task, run_concurrently_with_slow_start

    ns = pclq.metadata.namespace
    active_names = [p.metadata.name for p in existing]
    indices = indexer.allocate_indices(pclq.metadata.name, active_names, count)
    key = f"{ns}/{pclq.metadata.name}"
    created_pods: List[Pod] = []  # list.append is atomic across task threads

    def make_create(idx: int):
        def create() -> None:
            pod = build_pod(ctx, pclq, idx)
            # ownership-transfer create: the freshly built pod becomes the
            # committed object directly (no private pickled copy); the gate
            # pass below only READS it
            created = ctx.store.create(pod, consume=True)
            ctx.pod_expectations.expect_creations(key, [created.metadata.uid])
            ctx.record_event(
                "Pod",
                "PodCreateSuccessful",
                created.metadata.name,
                namespace=ns,
                name=created.metadata.name,
            )
            created_pods.append(created)

        return create

    # slow-start batches (1,2,4,…) — a failing apiserver is detected after a
    # handful of creates, not a burst (reference utils/concurrent.go:69-90)
    result = run_concurrently_with_slow_start(
        [
            Task(name=namegen.pod_name(pclq.metadata.name, idx), fn=make_create(idx))
            for idx in indices
        ]
    )
    if result.has_errors:
        raise GroveError(
            "ERR_SYNC_PODS", result.summary(), f"create-pods {pclq.metadata.name}"
        )
    created_pods.sort(key=lambda p: p.metadata.name)  # deterministic order
    return created_pods


def build_pod(ctx: OperatorContext, pclq: PodClique, pod_index: int) -> Pod:
    """pod.go:135-264: labels, gate, identity env, hostname, init waiter."""
    pcs_name = owner_pcs_name(pclq)
    pcs_replica = pclq.metadata.labels.get(namegen.LABEL_PCS_REPLICA_INDEX, "0")
    name = namegen.pod_name(pclq.metadata.name, pod_index)
    pod_spec = _clone_pod_spec(pclq)
    pod_spec.scheduling_gates = [PODGANG_SCHEDULING_GATE]
    pod_spec.hostname = name
    pod_spec.subdomain = namegen.headless_service_name(pcs_name, int(pcs_replica))
    pod_spec.service_account_name = namegen.pod_service_account_name(pcs_name)

    headless_addr = namegen.headless_service_address(
        pcs_name, int(pcs_replica), pclq.metadata.namespace
    )
    env = {
        "GROVE_PCS_NAME": pcs_name,
        "GROVE_PCS_INDEX": pcs_replica,
        "GROVE_PCLQ_NAME": pclq.metadata.name,
        "GROVE_HEADLESS_SERVICE": headless_addr,
        "GROVE_PCLQ_POD_INDEX": str(pod_index),
    }
    for container in pod_spec.containers + pod_spec.init_containers:
        for k, v in env.items():
            container.set_env(k, v)

    # init waiter (startup ordering) — initcontainer.go:50-158
    deps_json = pclq.metadata.annotations.get(STARTUP_DEPS_ANNOTATION)
    if deps_json:
        pod_spec.extra["groveInitWaiter"] = {
            "podcliques": json.loads(deps_json),
            "podgang": pclq.metadata.labels.get(namegen.LABEL_PODGANG, ""),
        }

    labels = dict(pclq.metadata.labels)
    labels[namegen.LABEL_PODCLIQUE] = pclq.metadata.name
    labels[namegen.LABEL_COMPONENT] = namegen.COMPONENT_POD
    labels[namegen.LABEL_APP_NAME] = name
    labels[namegen.LABEL_POD_INDEX] = str(pod_index)

    return Pod(
        metadata=ObjectMeta(
            name=name,
            namespace=pclq.metadata.namespace,
            labels=labels,
            owner_references=[_owner_ref(pclq)],
        ),
        spec=pod_spec,
    )


def _clone_container(c):
    # env dicts are the only container field set_env mutates in place
    c2 = copy.copy(c)
    c2.env = [dict(e) for e in c.env]
    return c2


def _clone_pod_spec(pclq: PodClique):
    """Copy-on-write pod-spec clone. build_pod customizes exactly: the gate
    list, identity fields (assigned), per-container env (set_env), and the
    extra dict — those get private copies; everything else (resources,
    commands, tolerations, unmodeled passthrough) stays shared with the
    PCLQ's immutable committed template. Replaces a pickled deep copy of
    the whole template per pod (the dominant pod-create cost at scale)."""
    src = pclq.spec.pod_spec
    spec = copy.copy(src)
    spec.containers = [_clone_container(c) for c in src.containers]
    spec.init_containers = [_clone_container(c) for c in src.init_containers]
    spec.scheduling_gates = list(src.scheduling_gates)
    spec.extra = dict(src.extra)
    return spec


def _owner_ref(pclq: PodClique):
    from grove_tpu_torch.api.meta import OwnerReference

    return OwnerReference(kind="PodClique", name=pclq.metadata.name, uid=pclq.metadata.uid)


def deletion_order(pod: Pod) -> tuple:
    """Worst-first ordering for scale-in (DeletionSorter equivalent):
    gated < unscheduled < scheduled-not-ready < ready; ties by higher index."""
    if is_schedule_gated(pod):
        rank = 0
    elif not is_scheduled(pod):
        rank = 1
    elif not is_ready(pod):
        rank = 2
    else:
        rank = 3
    idx = pod.metadata.labels.get(namegen.LABEL_POD_INDEX, "0")
    return (rank, -int(idx))


def _delete_excess_pods(
    ctx: OperatorContext,
    pclq: PodClique,
    count: int,
    existing: List[Pod],
    pending_deletes,
) -> None:
    ns = pclq.metadata.namespace
    key = f"{ns}/{pclq.metadata.name}"
    candidates = [p for p in existing if p.metadata.uid not in pending_deletes]
    candidates.sort(key=deletion_order)
    for pod in candidates[:count]:
        ctx.pod_expectations.expect_deletions(key, [pod.metadata.uid])
        ctx.store.delete("Pod", ns, pod.metadata.name)
        ctx.record_event(
            "Pod",
            "PodDeleteSuccessful",
            pod.metadata.name,
            namespace=ns,
            name=pod.metadata.name,
        )


# ---------------------------------------------------------------------------
# Scheduling-gate removal (the gang-admission handshake)
# ---------------------------------------------------------------------------


def _remove_scheduling_gates(
    ctx: OperatorContext, pclq: PodClique, pods, base_sched_memo=None
) -> int:
    ns = pclq.metadata.namespace
    podgang_name = pclq.metadata.labels.get(namegen.LABEL_PODGANG, "")
    gated = [p for p in pods if PODGANG_SCHEDULING_GATE in p.spec.scheduling_gates]
    if not gated:
        return 0

    podgang: Optional[PodGang] = (
        ctx.store.get("PodGang", ns, podgang_name, cached=True, readonly=True)
        if podgang_name
        else None
    )
    names_in_gang = set()
    if podgang is not None:
        for group in podgang.spec.pod_groups:
            for ref in group.pod_references:
                names_in_gang.add(ref.name)

    if base_sched_memo is None:
        base_scheduled = _base_podgang_scheduled(ctx, pclq)
    else:
        mkey = (ns, pclq.metadata.labels.get(namegen.LABEL_BASE_PODGANG))
        base_scheduled = base_sched_memo.get(mkey)
        if base_scheduled is None:
            base_scheduled = base_sched_memo[mkey] = _base_podgang_scheduled(
                ctx, pclq
            )

    skipped = 0
    for pod in gated:
        # (1) pod must be referenced by its PodGang (syncflow.go:261)
        if pod.metadata.name not in names_in_gang:
            skipped += 1
            continue
        # (2) scaled pods additionally wait for the base gang (syncflow.go:303-387)
        if not base_scheduled:
            skipped += 1
            continue
        view = ctx.store.get("Pod", ns, pod.metadata.name, readonly=True)
        if view is None or not view.spec.scheduling_gates:
            continue
        # copy-on-write ungate: clone only the spec spine with a private
        # gate list; containers/env stay shared with the committed object
        new_spec = copy.copy(view.spec)
        new_spec.scheduling_gates = [
            g for g in view.spec.scheduling_gates if g != PODGANG_SCHEDULING_GATE
        ]
        commit_spec(ctx.store, view, new_spec)
    return skipped


def _base_podgang_scheduled(ctx: OperatorContext, pclq: PodClique) -> bool:
    """syncflow.go:305-345: true when the PCLQ has no base-podgang label
    (it IS part of the base gang), else when every PodGroup of the base gang
    has PCLQ.status.scheduledReplicas >= group.minReplicas."""
    base_name = pclq.metadata.labels.get(namegen.LABEL_BASE_PODGANG)
    if not base_name:
        return True
    ns = pclq.metadata.namespace
    base = ctx.store.get("PodGang", ns, base_name, cached=True, readonly=True)
    if base is None:
        return False
    for group in base.spec.pod_groups:
        member = ctx.store.get(
            "PodClique", ns, group.name, cached=True, readonly=True
        )
        if member is None:
            return False
        if member.status.scheduled_replicas < group.min_replicas:
            return False
    return True
