"""PCS podgang component — THE semantic hot path.

Counterpart of ``grove_tpu/controller/podcliqueset/components/podgang.py``.

Re-host of reference operator/internal/controller/podcliqueset/components/
podgang/syncflow.go (the subtlest pure logic in the reference):

- one BASE PodGang per PCS replica holding every standalone clique plus
  scaling-group replicas 0..minAvailable-1 (syncflow.go:134-152, :230-249)
- one SCALED PodGang per scaling-group replica >= minAvailable, 0-based names
  (syncflow.go:154-197)
- replica counts follow live (HPA-mutated) PCLQ/PCSG resources when they
  exist, else template values (determinePodCliqueReplicas, :271-287)
- a PodGang *pending creation* is deferred while any constituent pod is
  uncreated or not yet labeled with the gang (:394-461); existing gangs keep
  updating
- PodGroups: one per constituent PCLQ — {name: pclq FQN, podReferences:
  sorted pod names, minReplicas: pclq minAvailable} (:488-508)
- excess gangs deleted (:368-386)
- topology constraints translated from level names to node-label keys at the
  PCS / PCSG / PCLQ tiers (scheduler podgang.go:50-126)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import NamespacedName, ObjectMeta
from grove_tpu_torch.api.types import (
    PodCliqueSet,
    PodGang,
    PodGangSpec,
    PodGroup,
    TopologyConstraintGroupConfig,
)
from grove_tpu_torch.controller.common import (
    OperatorContext,
    find_scaling_group_config_for_clique,
    translate_topology_constraint,
)


@dataclass
class PclqInfo:
    fqn: str
    replicas: int
    min_available: int
    clique_template_name: str


@dataclass
class PodGangInfo:
    fqn: str
    pclqs: List[PclqInfo] = field(default_factory=list)
    base: bool = True
    pcsg_fqn: Optional[str] = None  # set for scaled gangs
    base_fqn: Optional[str] = None  # the base gang a scaled gang hangs off


def compute_expected_podgangs(
    ctx: OperatorContext,
    pcs: PodCliqueSet,
    live_pclqs: Optional[Dict] = None,
    live_pcsgs: Optional[Dict] = None,
) -> List[PodGangInfo]:
    """syncflow.go:113-132. ``live_pclqs``/``live_pcsgs``: pre-fetched
    name→view dicts from the reconcile's shared ChildSnapshot (None →
    fetch here)."""
    ns = pcs.metadata.namespace
    if live_pclqs is None:
        live_pclqs = {
            p.metadata.name: p
            for p in ctx.store.scan(
                "PodClique", ns, namegen.default_labels(pcs.metadata.name), cached=True
            )
        }
    if live_pcsgs is None:
        live_pcsgs = {
            g.metadata.name: g
            for g in ctx.store.scan(
                "PodCliqueScalingGroup",
                ns,
                namegen.default_labels(pcs.metadata.name),
                cached=True,
            )
        }
    out: List[PodGangInfo] = []
    for replica in range(pcs.spec.replicas):
        out.append(_base_podgang_info(pcs, replica, live_pclqs))
    for replica in range(pcs.spec.replicas):
        out.extend(_scaled_podgang_infos(pcs, replica, live_pcsgs))
    return out


def _clique_replicas(pcs, clique, fqn: str, live_pclqs) -> int:
    """determinePodCliqueReplicas (:271-287): live PCLQ replicas when the
    clique is autoscaled and the resource exists; template replicas otherwise."""
    if clique.spec.auto_scaling_config is None:
        return clique.spec.replicas
    live = live_pclqs.get(fqn)
    return live.spec.replicas if live is not None else clique.spec.replicas


def _base_podgang_info(pcs, replica: int, live_pclqs) -> PodGangInfo:
    """:134-152 + :230-249 — worked example (comment at :227-229): with
    minAvailable=3, PCSG replicas 0,1,2 fold into base gang `<pcs>-<r>`;
    replicas 3,4 get scaled gangs `<pcsg-fqn>-0`, `<pcsg-fqn>-1`."""
    info = PodGangInfo(
        fqn=namegen.base_podgang_name(pcs.metadata.name, replica), base=True
    )
    tmpl = pcs.spec.template
    for clique in tmpl.cliques:
        sg_cfg = find_scaling_group_config_for_clique(
            tmpl.pod_clique_scaling_group_configs, clique.name
        )
        if sg_cfg is not None:
            pcsg_fqn = namegen.pcsg_name(pcs.metadata.name, replica, sg_cfg.name)
            for sg_replica in range(sg_cfg.min_available or 1):
                fqn = namegen.podclique_name(pcsg_fqn, sg_replica, clique.name)
                info.pclqs.append(
                    PclqInfo(
                        fqn=fqn,
                        replicas=clique.spec.replicas,
                        min_available=clique.spec.min_available or 1,
                        clique_template_name=clique.name,
                    )
                )
        else:
            fqn = namegen.podclique_name(pcs.metadata.name, replica, clique.name)
            info.pclqs.append(
                PclqInfo(
                    fqn=fqn,
                    replicas=_clique_replicas(pcs, clique, fqn, live_pclqs),
                    min_available=clique.spec.min_available or 1,
                    clique_template_name=clique.name,
                )
            )
    return info


def _scaled_podgang_infos(pcs, replica: int, live_pcsgs) -> List[PodGangInfo]:
    """:154-197 — scaled gangs for PCSG replicas >= minAvailable; replica
    count follows the live PCSG resource (HPA) when present."""
    out: List[PodGangInfo] = []
    tmpl = pcs.spec.template
    for cfg in tmpl.pod_clique_scaling_group_configs:
        pcsg_fqn = namegen.pcsg_name(pcs.metadata.name, replica, cfg.name)
        min_available = cfg.min_available or 1
        replicas = cfg.replicas or 1
        live = live_pcsgs.get(pcsg_fqn)
        if live is not None:
            replicas = live.spec.replicas
        for gang_index, sg_replica in enumerate(range(min_available, replicas)):
            info = PodGangInfo(
                fqn=namegen.scaled_podgang_name(pcsg_fqn, gang_index),
                base=False,
                pcsg_fqn=pcsg_fqn,
                base_fqn=namegen.base_podgang_name(pcs.metadata.name, replica),
            )
            for clique_name in cfg.clique_names:
                clique = tmpl.clique_template(clique_name)
                if clique is None:
                    continue
                fqn = namegen.podclique_name(pcsg_fqn, sg_replica, clique_name)
                # scaled instances always use template replicas (:289-310)
                info.pclqs.append(
                    PclqInfo(
                        fqn=fqn,
                        replicas=clique.spec.replicas,
                        min_available=clique.spec.min_available or 1,
                        clique_template_name=clique_name,
                    )
                )
            out.append(info)
    return out


def sync(ctx: OperatorContext, pcs: PodCliqueSet, snap=None) -> None:
    ns = pcs.metadata.namespace
    # one informer snapshot serves the expected-gang computation, the
    # pending checks, AND the PodGroup builds (previously this flow ran the
    # same PodClique scan twice plus one pod scan per constituent PCLQ)
    if snap is not None:
        live_pclqs = {p.metadata.name: p for p in snap.pclqs}
        live_pcsgs = {g.metadata.name: g for g in snap.pcsgs}
        set_pods = snap.pods_by_pclq()
    else:
        live_pclqs = live_pcsgs = set_pods = None
    expected = compute_expected_podgangs(ctx, pcs, live_pclqs, live_pcsgs)
    expected_names = {g.fqn for g in expected}
    selector = {
        **namegen.default_labels(pcs.metadata.name),
        namegen.LABEL_COMPONENT: namegen.COMPONENT_PODGANG,
    }
    existing = {g.metadata.name for g in ctx.store.scan("PodGang", ns, selector)}

    # delete excess (:368-386)
    for name in existing - expected_names:
        ctx.store.delete("PodGang", ns, name)
        ctx.record_event(
            "PodGang", "PodGangDeleteSuccessful", name, namespace=ns, name=name
        )

    if live_pclqs is None:
        live_pclqs = {
            p.metadata.name: p
            for p in ctx.store.scan(
                "PodClique", ns, namegen.default_labels(pcs.metadata.name), cached=True
            )
        }

    for gang in expected:
        pods_by_pclq, pending = _pods_pending_creation_or_association(
            ctx, ns, gang, live_pclqs, set_pods
        )
        if gang.fqn not in existing and pending > 0:
            # defer creation until every constituent pod exists & is labeled
            # (:432-461)
            continue
        _create_or_update_podgang(ctx, pcs, gang, pods_by_pclq)


def _pods_pending_creation_or_association(
    ctx: OperatorContext, ns: str, gang: PodGangInfo, live_pclqs, set_pods=None
):
    """:394-461: count pods that are (a) from PCLQs not yet created,
    (b) not yet created in existing PCLQs, or (c) missing/mismatching the
    podgang label. Also returns the pod names per PCLQ for PodGroups.
    ``set_pods``: the snapshot's pods-by-PCLQ grouping (one scan for the
    whole set instead of one per constituent PCLQ)."""
    pending = 0
    pods_by_pclq: Dict[str, List[str]] = {}
    for pclq in gang.pclqs:
        live = live_pclqs.get(pclq.fqn)
        if live is None:
            pending += pclq.replicas
            continue
        if set_pods is not None:
            pods = set_pods.get(pclq.fqn, ())
        else:
            pods = ctx.store.scan(
                "Pod", ns, {namegen.LABEL_PODCLIQUE: pclq.fqn}, cached=True
            )
        pods = [p for p in pods if p.metadata.deletion_timestamp is None]
        pending += max(0, live.spec.replicas - len(pods))
        names: List[str] = []
        for pod in pods:
            label = pod.metadata.labels.get(namegen.LABEL_PODGANG)
            if label != gang.fqn:
                pending += 1
                continue
            names.append(pod.metadata.name)
        pods_by_pclq[pclq.fqn] = sorted(names)
    return pods_by_pclq, pending


def _create_or_update_podgang(
    ctx: OperatorContext,
    pcs: PodCliqueSet,
    gang: PodGangInfo,
    pods_by_pclq: Dict[str, List[str]],
) -> None:
    ns = pcs.metadata.namespace
    tmpl = pcs.spec.template
    pod_groups = []
    for pclq in gang.pclqs:
        clique_tmpl = tmpl.clique_template(pclq.clique_template_name)
        pod_groups.append(
            PodGroup(
                name=pclq.fqn,
                pod_references=[
                    NamespacedName(namespace=ns, name=n)
                    for n in pods_by_pclq.get(pclq.fqn, [])
                ],
                min_replicas=pclq.min_available,
                topology_constraint=translate_topology_constraint(
                    clique_tmpl.topology_constraint if clique_tmpl else None,
                    ctx.topology,
                ),
            )
        )

    # PCSG-level pack groups (scheduler podgang.go:117-126)
    group_configs = []
    if gang.base:
        for cfg in tmpl.pod_clique_scaling_group_configs:
            tc = translate_topology_constraint(cfg.topology_constraint, ctx.topology)
            if tc is None:
                continue
            member_names = [
                p.fqn
                for p in gang.pclqs
                if p.clique_template_name in cfg.clique_names
            ]
            if member_names:
                group_configs.append(
                    TopologyConstraintGroupConfig(
                        pod_group_names=member_names, topology_constraint=tc
                    )
                )
    elif gang.pcsg_fqn is not None and gang.base_fqn is not None:
        # exact sg-name extraction: pcsg_fqn = <base_fqn>-<sg-name>
        sg_name = gang.pcsg_fqn[len(gang.base_fqn) + 1 :]
        for cfg in tmpl.pod_clique_scaling_group_configs:
            if cfg.name == sg_name:
                tc = translate_topology_constraint(
                    cfg.topology_constraint, ctx.topology
                )
                if tc is not None:
                    group_configs.append(
                        TopologyConstraintGroupConfig(
                            pod_group_names=[p.fqn for p in gang.pclqs],
                            topology_constraint=tc,
                        )
                    )
                break

    # During a rolling update, hint the scheduler to reuse this gang's prior
    # reservation for replaced pods (scheduler podgang.go:67-73)
    reuse_ref = None
    progress = pcs.status.rolling_update_progress
    if progress is not None and progress.update_ended_at is None:
        reuse_ref = NamespacedName(namespace=ns, name=gang.fqn)

    spec = PodGangSpec(
        pod_groups=pod_groups,
        topology_constraint=translate_topology_constraint(
            tmpl.topology_constraint, ctx.topology
        ),
        topology_constraint_group_configs=group_configs,
        priority_class_name=tmpl.priority_class_name,
        reuse_reservation_ref=reuse_ref,
    )

    current = ctx.store.get("PodGang", ns, gang.fqn, readonly=True)
    if current is None:
        labels = dict(namegen.default_labels(pcs.metadata.name))
        labels[namegen.LABEL_COMPONENT] = namegen.COMPONENT_PODGANG
        # tenant queue (quota subsystem): the scheduler reads the gang's
        # queue assignment from this label at encode time
        queue = pcs.metadata.labels.get(namegen.LABEL_QUEUE)
        if queue:
            labels[namegen.LABEL_QUEUE] = queue
        if not gang.base and gang.base_fqn:
            labels[namegen.LABEL_BASE_PODGANG] = gang.base_fqn
        ctx.store.create(
            PodGang(
                metadata=ObjectMeta(name=gang.fqn, namespace=ns, labels=labels),
                spec=spec,
            ),
            consume=True,  # freshly built and dropped: no pickled copy
        )
        ctx.record_event(
            "PodGang",
            "PodGangCreateSuccessful",
            gang.fqn,
            namespace=ns,
            name=gang.fqn,
        )
    elif current.spec != spec:
        # copy-on-write spec push: `spec` is freshly built (private); the
        # committed clone shares metadata/status with the previous object
        from grove_tpu_torch.runtime.store import commit_spec

        commit_spec(ctx.store, current, spec)


