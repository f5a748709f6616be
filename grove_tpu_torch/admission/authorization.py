"""Authorization guard for grove-managed child resources.

Counterpart of ``grove_tpu/admission/authorization.py``.

Re-host of reference operator/internal/webhook/admission/pcs/
authorization/handler.go:51-158: when enabled, mutations/deletions of
resources the operator manages (identified by the managed-by label, ownership
traced to the parent PodCliqueSet) are blocked unless the requesting user is
the operator itself or an exempt service account. Protects gang invariants
from out-of-band kubectl edits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from grove_tpu_torch.api import names as namegen

OPERATOR_USERNAME = "system:serviceaccount:grove-system:grove-tpu-operator"

MANAGED_KINDS = (
    "PodClique",
    "PodCliqueScalingGroup",
    "PodGang",
    "Pod",
    "Service",
    "HorizontalPodAutoscaler",
    "ServiceAccount",
    "Role",
    "RoleBinding",
    "Secret",
)


@dataclass
class AuthorizationDecision:
    allowed: bool
    reason: str = ""


class AuthorizationGuard:
    def __init__(
        self,
        enabled: bool = True,
        exempt_users: Optional[Iterable[str]] = None,
        operator_username: str = OPERATOR_USERNAME,
    ) -> None:
        self.enabled = enabled
        self.exempt = set(exempt_users or [])
        self.operator_username = operator_username

    def check(self, username: str, operation: str, obj) -> AuthorizationDecision:
        """operation ∈ {create, update, delete}. Only grove-MANAGED resources
        are guarded; users retain full control of their own objects and of
        the parent PodCliqueSet itself."""
        if not self.enabled:
            return AuthorizationDecision(True)
        if obj.kind not in MANAGED_KINDS:
            return AuthorizationDecision(True)
        labels = obj.metadata.labels or {}
        if labels.get(namegen.LABEL_MANAGED_BY) != namegen.LABEL_MANAGED_BY_VALUE:
            return AuthorizationDecision(True)
        if username == self.operator_username or username in self.exempt:
            return AuthorizationDecision(True)
        owner = labels.get(namegen.LABEL_PART_OF, "<unknown>")
        return AuthorizationDecision(
            False,
            f"{operation} of {obj.kind} {obj.metadata.name!r} is denied: the"
            f" resource is managed by the grove operator on behalf of"
            f" PodCliqueSet {owner!r}; edit the PodCliqueSet instead",
        )
