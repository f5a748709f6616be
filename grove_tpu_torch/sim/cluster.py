"""Cluster nodes for the solver path.

Counterpart of ``grove_tpu/sim/cluster.py``'s ``Node`` and ``make_nodes``.
The simulated binder and kubelet are not part of the port; the encoder
reads only a node's name, capacity and topology labels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Node:
    name: str
    capacity: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)  # topology keys


def make_nodes(
    count: int,
    capacity: Optional[Dict[str, float]] = None,
    hosts_per_ici_block: int = 4,
    blocks_per_slice: int = 4,
) -> List[Node]:
    """Synthetic TPU-ish topology: hosts grouped into ici-blocks into slices."""
    capacity = capacity or {"cpu": 8.0, "memory": 32 * 2**30, "tpu": 4.0}
    nodes = []
    for i in range(count):
        block = i // hosts_per_ici_block
        slice_ = block // blocks_per_slice
        nodes.append(
            Node(
                name=f"node-{i}",
                capacity=dict(capacity),
                labels={
                    "kubernetes.io/hostname": f"node-{i}",
                    "cloud.google.com/gke-tpu-ici-block": f"block-{block}",
                    "cloud.google.com/gke-tpu-slice": f"slice-{slice_}",
                    "cloud.google.com/gke-cluster": "cluster-0",
                    "topology.kubernetes.io/zone": "zone-a",
                },
            )
        )
    return nodes
