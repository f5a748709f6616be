"""PCS infra components: RBAC, SA-token secret, headless Services, HPAs.

Counterpart of ``grove_tpu/controller/podcliqueset/components/infra.py``.

Re-host of the reference component set ordered ahead of the workload
components (podcliqueset/reconcilespec.go:202-215):
serviceaccount/role/rolebinding/satokensecret (components/{serviceaccount,
role,rolebinding,satokensecret}/), service (components/service/service.go),
hpa (components/hpa/hpa.go:130-168).
"""

from __future__ import annotations

from typing import Dict, List

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import GenericObject, PodCliqueSet
from grove_tpu_torch.controller.common import OperatorContext


def _ensure(ctx: OperatorContext, obj: GenericObject) -> None:
    if (
        ctx.store.get(
            obj.kind, obj.metadata.namespace, obj.metadata.name, readonly=True
        )
        is None
    ):
        # freshly built, caller drops it: ownership-transfer create
        ctx.store.create(obj, consume=True)


def _reap(
    ctx: OperatorContext,
    kind: str,
    namespace: str,
    selector: Dict[str, str],
    keep: List[str],
) -> None:
    for obj in ctx.store.scan(kind, namespace, selector):
        if obj.metadata.name not in keep:
            ctx.store.delete(kind, namespace, obj.metadata.name)


def sync_rbac(ctx: OperatorContext, pcs: PodCliqueSet) -> None:
    """Per-PCS ServiceAccount/Role/RoleBinding (pods list/watch for the init
    waiter) + SA token secret mounted into it.

    Existence check FIRST (four readonly dict lookups): these objects are
    immutable once created, and the steady state — every PCS reconcile
    after the first — must not pay four object constructions just to find
    them already present (profiled: sync_rbac was ~2% of the 10k-set
    integrated converge)."""
    ns = pcs.metadata.namespace
    name = pcs.metadata.name
    wanted = (
        ("ServiceAccount", namegen.pod_service_account_name(name)),
        ("Role", namegen.pod_role_name(name)),
        ("RoleBinding", namegen.pod_role_binding_name(name)),
        ("Secret", namegen.initc_sa_token_secret_name(name)),
    )
    if all(
        ctx.store.get(kind, ns, obj_name, readonly=True) is not None
        for kind, obj_name in wanted
    ):
        return
    base = namegen.default_labels(pcs.metadata.name)
    items = [
        GenericObject(
            kind="ServiceAccount",
            metadata=ObjectMeta(
                name=namegen.pod_service_account_name(pcs.metadata.name),
                namespace=ns,
                labels={
                    **base,
                    namegen.LABEL_COMPONENT: namegen.COMPONENT_POD_SERVICE_ACCOUNT,
                },
            ),
        ),
        GenericObject(
            kind="Role",
            metadata=ObjectMeta(
                name=namegen.pod_role_name(pcs.metadata.name),
                namespace=ns,
                labels={**base, namegen.LABEL_COMPONENT: namegen.COMPONENT_POD_ROLE},
            ),
            spec={"rules": [{"resources": ["pods"], "verbs": ["list", "watch", "get"]}]},
        ),
        GenericObject(
            kind="RoleBinding",
            metadata=ObjectMeta(
                name=namegen.pod_role_binding_name(pcs.metadata.name),
                namespace=ns,
                labels={
                    **base,
                    namegen.LABEL_COMPONENT: namegen.COMPONENT_POD_ROLE_BINDING,
                },
            ),
            spec={
                "roleRef": namegen.pod_role_name(pcs.metadata.name),
                "subjects": [namegen.pod_service_account_name(pcs.metadata.name)],
            },
        ),
        GenericObject(
            kind="Secret",
            metadata=ObjectMeta(
                name=namegen.initc_sa_token_secret_name(pcs.metadata.name),
                namespace=ns,
                labels={
                    **base,
                    namegen.LABEL_COMPONENT: namegen.COMPONENT_SA_TOKEN_SECRET,
                },
            ),
        ),
    ]
    for obj in items:
        _ensure(ctx, obj)


def sync_headless_services(ctx: OperatorContext, pcs: PodCliqueSet) -> None:
    """One headless Service per PCS replica for stable pod DNS
    (`<pod>.<svc>.<ns>.svc.cluster.local` — service/service.go)."""
    ns = pcs.metadata.namespace
    base = namegen.default_labels(pcs.metadata.name)
    selector = {**base, namegen.LABEL_COMPONENT: namegen.COMPONENT_HEADLESS_SERVICE}
    hsc = pcs.spec.template.headless_service_config
    keep = []
    for replica in range(pcs.spec.replicas):
        name = namegen.headless_service_name(pcs.metadata.name, replica)
        keep.append(name)
        _ensure(
            ctx,
            GenericObject(
                kind="Service",
                metadata=ObjectMeta(
                    name=name,
                    namespace=ns,
                    labels={
                        **selector,
                        namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
                    },
                ),
                spec={
                    "clusterIP": "None",
                    "publishNotReadyAddresses": (
                        hsc.publish_not_ready_addresses if hsc else True
                    ),
                    "selector": {
                        namegen.LABEL_PART_OF: pcs.metadata.name,
                        namegen.LABEL_PCS_REPLICA_INDEX: str(replica),
                    },
                },
            ),
        )
    _reap(ctx, "Service", ns, selector, keep)


def sync_hpas(ctx: OperatorContext, pcs: PodCliqueSet) -> None:
    """HPA per autoscaled PCLQ and per PCSG with scaleConfig, targeting the
    CR's scale subresource (hpa.go:130-168)."""
    ns = pcs.metadata.namespace
    base = namegen.default_labels(pcs.metadata.name)
    selector = {**base, namegen.LABEL_COMPONENT: namegen.COMPONENT_HPA}
    keep = []
    tmpl = pcs.spec.template
    for replica in range(pcs.spec.replicas):
        for clique in tmpl.standalone_clique_templates():
            sc = clique.spec.auto_scaling_config
            if sc is None:
                continue
            target = namegen.podclique_name(pcs.metadata.name, replica, clique.name)
            keep.append(target)
            _ensure(
                ctx,
                GenericObject(
                    kind="HorizontalPodAutoscaler",
                    metadata=ObjectMeta(name=target, namespace=ns, labels=dict(selector)),
                    spec={
                        "targetKind": "PodClique",
                        "targetName": target,
                        "minReplicas": sc.min_replicas,
                        "maxReplicas": sc.max_replicas,
                        "metrics": sc.metrics,
                    },
                ),
            )
        for sg in tmpl.pod_clique_scaling_group_configs:
            if sg.scale_config is None:
                continue
            target = namegen.pcsg_name(pcs.metadata.name, replica, sg.name)
            keep.append(target)
            _ensure(
                ctx,
                GenericObject(
                    kind="HorizontalPodAutoscaler",
                    metadata=ObjectMeta(name=target, namespace=ns, labels=dict(selector)),
                    spec={
                        "targetKind": "PodCliqueScalingGroup",
                        "targetName": target,
                        "minReplicas": sg.scale_config.min_replicas,
                        "maxReplicas": sg.scale_config.max_replicas,
                        "metrics": sg.scale_config.metrics,
                    },
                ),
            )
    _reap(ctx, "HorizontalPodAutoscaler", ns, selector, keep)
