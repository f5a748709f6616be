"""PCS scalinggroup component: PodCliqueScalingGroup CRs from template configs.

Counterpart of ``grove_tpu/controller/podcliqueset/components/scalinggroup.py``.

Re-host of reference operator/internal/controller/podcliqueset/components/
podcliquescalinggroup/podcliquescalinggroup.go (250 LoC). Replicas on an
existing PCSG are owned by its HPA (scale subresource) — sync must not clobber
them back to the template value.
"""

from __future__ import annotations

from typing import Dict

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import (
    PodCliqueScalingGroup,
    PodCliqueScalingGroupSpec,
    PodCliqueSet,
)
from grove_tpu_torch.controller.common import OperatorContext


def sync(ctx: OperatorContext, pcs: PodCliqueSet) -> None:
    ns = pcs.metadata.namespace
    selector = {
        **namegen.default_labels(pcs.metadata.name),
        namegen.LABEL_COMPONENT: namegen.COMPONENT_PCSG,
    }
    existing_names = {
        g.metadata.name
        for g in ctx.store.scan("PodCliqueScalingGroup", ns, selector)
    }

    def build() -> Dict[str, PodCliqueScalingGroup]:
        out: Dict[str, PodCliqueScalingGroup] = {}
        for replica in range(pcs.spec.replicas):
            for cfg in pcs.spec.template.pod_clique_scaling_group_configs:
                fqn = namegen.pcsg_name(pcs.metadata.name, replica, cfg.name)
                labels = dict(namegen.default_labels(pcs.metadata.name))
                labels[namegen.LABEL_COMPONENT] = namegen.COMPONENT_PCSG
                labels[namegen.LABEL_PCS_REPLICA_INDEX] = str(replica)
                labels[namegen.LABEL_PCSG] = fqn
                out[fqn] = PodCliqueScalingGroup(
                    metadata=ObjectMeta(name=fqn, namespace=ns, labels=labels),
                    spec=PodCliqueScalingGroupSpec(
                        replicas=cfg.replicas or 1,
                        min_available=cfg.min_available or 1,
                        clique_names=list(cfg.clique_names),
                    ),
                )
        return out

    # pure function of (uid, generation) — see podclique.sync
    expected = ctx.desired_cache(
        ("pcsg", pcs.metadata.uid, pcs.metadata.generation), build
    )

    for name, pcsg in expected.items():
        if name not in existing_names:
            # share=True: memoized desired object, reused read-only (see
            # create_or_adopt)
            ctx.store.create(pcsg, share=True)
            ctx.record_event(
                "PodCliqueScalingGroup",
                "PCSGCreateSuccessful",
                name,
                namespace=ns,
                name=name,
            )
        # existing PCSGs keep their (possibly HPA-scaled) replicas

    for name in existing_names - expected.keys():
        ctx.store.delete("PodCliqueScalingGroup", ns, name)
        ctx.record_event(
            "PodCliqueScalingGroup",
            "PCSGDeleteSuccessful",
            name,
            namespace=ns,
            name=name,
        )
