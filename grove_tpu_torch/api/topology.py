"""ClusterTopology: ordered topology hierarchy (broadest level first).

Counterpart of ``grove_tpu/api/topology.py``: each level maps a topology
domain to the node-label key that names it. The port keeps only what the
solver path reads — the level list — and replaces ``ObjectMeta`` with a
plain ``name``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class TopologyLevel:
    """One level: domain name + node-label key."""

    domain: str
    key: str


# Default node-label keys per TPU domain, broadest → narrowest.
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
    name: str = "default"
    spec: ClusterTopologySpec = field(default_factory=ClusterTopologySpec)
    kind: str = "ClusterTopology"
