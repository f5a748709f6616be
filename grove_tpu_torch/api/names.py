"""Deterministic naming and the label vocabulary.

Counterpart of ``grove_tpu/api/names.py``: the label keys and the name
helpers the reference's namegen gives every child resource, so both packages
agree on child identity.
"""

from __future__ import annotations

from typing import Dict

from grove_tpu_torch.api.types import API_GROUP

# --- label keys (constants.go) ---------------------------------------------

LABEL_APP_NAME = "app.kubernetes.io/name"
LABEL_MANAGED_BY = "app.kubernetes.io/managed-by"
LABEL_PART_OF = "app.kubernetes.io/part-of"
LABEL_MANAGED_BY_VALUE = "grove-operator"
LABEL_COMPONENT = "app.kubernetes.io/component"
LABEL_PODCLIQUE = "grove.io/podclique"
LABEL_PODGANG = "grove.io/podgang"
LABEL_BASE_PODGANG = "grove.io/base-podgang"
LABEL_PCS_REPLICA_INDEX = "grove.io/podcliqueset-replica-index"
LABEL_PCSG = "grove.io/podcliquescalinggroup"
LABEL_PCSG_REPLICA_INDEX = "grove.io/podcliquescalinggroup-replica-index"
LABEL_POD_TEMPLATE_HASH = "grove.io/pod-template-hash"
LABEL_POD_INDEX = "grove.io/pod-index"
# tenant queue assignment (quota subsystem, docs/quota.md): set by users on
# the PodCliqueSet, propagated by the operator to PodCliques (and through
# them to Pods) and PodGangs so the scheduler and the usage accountant can
# attribute every gang/pod to its queue without extra lookups
LABEL_QUEUE = "scheduler.grove.io/queue"
# home-cluster affinity (federation tier, docs/federation.md): set by
# users on the PodCliqueSet; the FederationRouter places the workload in
# this region unless it is Lost or its explain verdict blocks admission
LABEL_FEDERATION_HOME = "federation.grove.io/home"

# component values set against LABEL_COMPONENT
COMPONENT_HEADLESS_SERVICE = "pcs-headless-service"
COMPONENT_POD_ROLE = "pod-role"
COMPONENT_POD_ROLE_BINDING = "pod-role-binding"
COMPONENT_POD_SERVICE_ACCOUNT = "pod-service-account"
COMPONENT_SA_TOKEN_SECRET = "pod-sa-token-secret"
COMPONENT_PCSG = "pcs-podcliquescalinggroup"
COMPONENT_HPA = "pcs-hpa"
COMPONENT_PODGANG = "podgang"
COMPONENT_PCS_PODCLIQUE = "pcs-podclique"
COMPONENT_PCSG_PODCLIQUE = "pcsg-podclique"
COMPONENT_POD = "pcs-pod"


def default_labels(pcs_name: str) -> Dict[str, str]:
    """constants.go:90-95 GetDefaultLabelsForPodCliqueSetManagedResources."""
    return {LABEL_MANAGED_BY: LABEL_MANAGED_BY_VALUE, LABEL_PART_OF: pcs_name}


# --- namegen (namegen.go) ---------------------------------------------------


def headless_service_name(pcs_name: str, pcs_replica: int) -> str:
    return f"{pcs_name}-{pcs_replica}"


def headless_service_address(pcs_name: str, pcs_replica: int, namespace: str) -> str:
    return f"{headless_service_name(pcs_name, pcs_replica)}.{namespace}.svc.cluster.local"


def pod_role_name(pcs_name: str) -> str:
    return f"{API_GROUP}:pcs:{pcs_name}"


def pod_role_binding_name(pcs_name: str) -> str:
    return f"{API_GROUP}:pcs:{pcs_name}"


def pod_service_account_name(pcs_name: str) -> str:
    return pcs_name


def initc_sa_token_secret_name(pcs_name: str) -> str:
    return f"{pcs_name}-initc-sa-token-secret"


def podclique_name(owner_name: str, owner_replica: int, clique_template_name: str) -> str:
    """namegen.go:97-100 — owner is the PCS (standalone) or the PCSG (member)."""
    return f"{owner_name}-{owner_replica}-{clique_template_name}"


def pcsg_name(pcs_name: str, pcs_replica: int, sg_template_name: str) -> str:
    return f"{pcs_name}-{pcs_replica}-{sg_template_name}"


def base_podgang_name(pcs_name: str, pcs_replica: int) -> str:
    return f"{pcs_name}-{pcs_replica}"


def scaled_podgang_name(pcsg_fqn: str, scaled_index: int) -> str:
    """namegen.go:86-92 CreatePodGangNameFromPCSGFQN — scaled_index is 0-based
    for PCSG replicas >= minAvailable."""
    return f"{pcsg_fqn}-{scaled_index}"


def podgang_name_for_pcsg_replica(
    pcs_name: str,
    pcs_replica: int,
    pcsg_fqn: str,
    pcsg_replica: int,
    pcsg_min_available: int,
) -> str:
    """namegen.go:100-118: PCSG replicas 0..minAvailable-1 belong to the base
    PodGang of the PCS replica; replicas >= minAvailable each get their own
    scaled PodGang with 0-based index."""
    if pcsg_replica < pcsg_min_available:
        return base_podgang_name(pcs_name, pcs_replica)
    return scaled_podgang_name(pcsg_fqn, pcsg_replica - pcsg_min_available)


def pod_name(pclq_name: str, pod_index: int) -> str:
    """Stable pod hostname `<pclq>-<idx>` (index-allocator backed —
    reference internal/index/tracker.go)."""
    return f"{pclq_name}-{pod_index}"


def hpa_name(target_name: str) -> str:
    return target_name


def extract_sg_name_from_pcsg_fqn(pcsg_fqn: str, pcs_name: str, pcs_replica: int) -> str:
    """namegen.go:120-125."""
    prefix = f"{pcs_name}-{pcs_replica}-"
    return pcsg_fqn[len(prefix):]
