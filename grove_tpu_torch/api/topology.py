"""ClusterTopology: ordered topology hierarchy (broadest level first).

Counterpart of ``grove_tpu/api/topology.py``: each level maps a topology
domain to the node-label key that names it; the domain order accepts the
reference's vocabulary and the TPU one at their equivalent scopes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from grove_tpu_torch.api.meta import ObjectMeta

# Broadest → narrowest. Reference domains (clustertopology.go:61-78) plus the
# TPU-native domains interleaved at their equivalent scope.
TOPOLOGY_DOMAIN_ORDER: Dict[str, int] = {
    "region": 0,
    "zone": 1,
    "datacenter": 2,
    "cluster": 2,  # TPU alias for datacenter scope
    "block": 3,
    "slice": 3,  # TPU: one ICI domain (NVLink-domain analogue)
    "rack": 4,
    "ici-block": 4,  # TPU: sub-slice / twisted-torus block
    "host": 5,
    "numa": 6,
    "chip": 6,  # TPU alias for numa scope
}

VALID_DOMAINS = tuple(TOPOLOGY_DOMAIN_ORDER)



def compare_domains(a: str, b: str) -> int:
    """clustertopology.go:92-100 — negative if `a` broader than `b`."""
    return TOPOLOGY_DOMAIN_ORDER[a] - TOPOLOGY_DOMAIN_ORDER[b]


def broader_than(a: str, b: str) -> bool:
    return compare_domains(a, b) < 0


def narrower_than(a: str, b: str) -> bool:
    return compare_domains(a, b) > 0


@dataclass
class TopologyLevel:
    """clustertopology.go TopologyLevel: domain name + node-label key."""

    domain: str
    key: str


# Default node-label keys per TPU domain (GKE-style; cf. the reference's
# sample cluster-topology-host-only.yaml using kubernetes.io/hostname).
DEFAULT_TPU_LEVELS: List[TopologyLevel] = [
    TopologyLevel("zone", "topology.kubernetes.io/zone"),
    TopologyLevel("cluster", "cloud.google.com/gke-cluster"),
    TopologyLevel("slice", "cloud.google.com/gke-tpu-slice"),
    TopologyLevel("ici-block", "cloud.google.com/gke-tpu-ici-block"),
    TopologyLevel("host", "kubernetes.io/hostname"),
]


@dataclass
class ClusterTopologySpec:
    levels: List[TopologyLevel] = field(
        default_factory=lambda: [
            TopologyLevel(l.domain, l.key) for l in DEFAULT_TPU_LEVELS
        ]
    )


@dataclass
class ClusterTopology:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ClusterTopologySpec = field(default_factory=ClusterTopologySpec)
    kind: str = "ClusterTopology"

    def level_index(self, domain: str) -> Optional[int]:
        for i, lvl in enumerate(self.spec.levels):
            if lvl.domain == domain:
                return i
        return None

    def key_for_domain(self, domain: str) -> Optional[str]:
        idx = self.level_index(domain)
        return self.spec.levels[idx].key if idx is not None else None

    def narrowest_key(self) -> str:
        """Strictest level's key — used as the auto-generated `preferred`
        constraint on PodGangs (scheduler podgang.go:108-113)."""
        return self.spec.levels[-1].key

    def translate_pack_domain(self, domain: Optional[str]) -> Optional[str]:
        """Level name → topology key (docs/designs/topology.md:541-616)."""
        if domain is None:
            return None
        key = self.key_for_domain(domain)
        if key is None:
            raise KeyError(f"topology level {domain!r} not in ClusterTopology")
        return key


def default_cluster_topology(name: str = "default") -> ClusterTopology:
    return ClusterTopology(metadata=ObjectMeta(name=name, namespace=""))
