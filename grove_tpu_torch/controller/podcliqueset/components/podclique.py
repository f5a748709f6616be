"""PCS podclique component: standalone PodCliques per PCS replica.

Counterpart of ``grove_tpu/controller/podcliqueset/components/podclique.py``.

Re-host of reference operator/internal/controller/podcliqueset/components/
podclique/podclique.go (395 LoC): one PCLQ per (PCS replica × standalone
clique template), labeled with the base PodGang of its replica; deletes
PCLQs of removed PCS replicas.
"""

from __future__ import annotations

import json
from typing import Dict

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.hashing import pod_template_hash_for
from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.types import PodClique, PodCliqueSet
from grove_tpu_torch.controller.common import (
    OperatorContext,
    create_or_adopt,
    resolve_starts_after,
    shared_template_spec,
)
from grove_tpu_torch.controller.podclique.pods import STARTUP_DEPS_ANNOTATION


def sync(ctx: OperatorContext, pcs: PodCliqueSet) -> None:
    ns = pcs.metadata.namespace
    selector = {
        **namegen.default_labels(pcs.metadata.name),
        namegen.LABEL_COMPONENT: namegen.COMPONENT_PCS_PODCLIQUE,
    }
    existing_names = {
        p.metadata.name for p in ctx.store.scan("PodClique", ns, selector)
    }

    def build() -> Dict[str, PodClique]:
        out: Dict[str, PodClique] = {}
        for replica in range(pcs.spec.replicas):
            for clique in pcs.spec.template.standalone_clique_templates():
                pclq = build_pclq(pcs, replica, clique)
                out[pclq.metadata.name] = pclq
        return out

    # pure function of (uid, generation): spec/replica changes bump the
    # generation, so the memoized desired set is exact across reconciles
    expected = ctx.desired_cache(
        ("pclq", pcs.metadata.uid, pcs.metadata.generation), build
    )

    for name, pclq in expected.items():
        if name not in existing_names:
            ctx.record_event(
                "PodClique",
                "PodCliqueCreateSuccessful",
                name,
                namespace=ns,
                name=name,
            )
        create_or_adopt(ctx, pclq)

    for name in existing_names - expected.keys():
        ctx.store.delete("PodClique", ns, name)
        ctx.record_event(
            "PodClique",
            "PodCliqueDeleteSuccessful",
            name,
            namespace=ns,
            name=name,
        )


def build_pclq(pcs: PodCliqueSet, replica: int, clique) -> PodClique:
    fqn = namegen.podclique_name(pcs.metadata.name, replica, clique.name)
    labels = dict(namegen.default_labels(pcs.metadata.name))
    labels.update(clique.labels)
    labels[namegen.LABEL_COMPONENT] = namegen.COMPONENT_PCS_PODCLIQUE
    labels[namegen.LABEL_PCS_REPLICA_INDEX] = str(replica)
    labels[namegen.LABEL_PODGANG] = namegen.base_podgang_name(
        pcs.metadata.name, replica
    )
    labels[namegen.LABEL_POD_TEMPLATE_HASH] = pod_template_hash_for(
        pcs, clique.name
    )
    # tenant queue (quota subsystem): PCS label flows to the PCLQ, and from
    # there to every pod (pods copy PCLQ labels wholesale), so the usage
    # accountant can attribute bound capacity without store lookups
    queue = pcs.metadata.labels.get(namegen.LABEL_QUEUE)
    if queue:
        labels[namegen.LABEL_QUEUE] = queue
    annotations = dict(clique.annotations)
    deps = resolve_starts_after(pcs, replica, clique.name)
    if deps:
        annotations[STARTUP_DEPS_ANNOTATION] = json.dumps(deps)
    return PodClique(
        metadata=ObjectMeta(
            name=fqn,
            namespace=pcs.metadata.namespace,
            labels=labels,
            annotations=annotations,
        ),
        spec=shared_template_spec(clique.spec),
    )
