"""Label keys and name helpers.

Counterpart of ``grove_tpu/api/names.py``, cut to the labels the scheduler
reads and the names a PodCliqueSet controller gives its PodGangs,
PodCliques and Pods.
"""

from __future__ import annotations

LABEL_PART_OF = "app.kubernetes.io/part-of"
LABEL_PODCLIQUE = "grove.io/podclique"
LABEL_PODGANG = "grove.io/podgang"
LABEL_POD_TEMPLATE_HASH = "grove.io/pod-template-hash"
# tenant queue, propagated from the PodCliqueSet to PodCliques, Pods and
# PodGangs
LABEL_QUEUE = "scheduler.grove.io/queue"


def podclique_name(owner_name: str, owner_replica: int, clique_template_name: str) -> str:
    return f"{owner_name}-{owner_replica}-{clique_template_name}"


def base_podgang_name(pcs_name: str, pcs_replica: int) -> str:
    return f"{pcs_name}-{pcs_replica}"


def pod_name(pclq_name: str, pod_index: int) -> str:
    return f"{pclq_name}-{pod_index}"
