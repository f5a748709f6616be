"""Automatic topology detection: node labels → ClusterTopology.

Counterpart of ``grove_tpu/cluster/autotopo.py``, with the same names, wire
format and status codes.

Ships the reference roadmap's unshipped "Automatic Topology Detection"
(README.md 2026 priorities): instead of an admin hand-writing the
ClusterTopology CR, the level hierarchy is INFERRED from the node labels
already on the cluster — which label keys partition the nodes into a
containment hierarchy, and in which broad→narrow order.

Method (pure host-side set math, no solver involvement):

1. Candidate keys = labels present on every node (a topology key must
   cover the fleet).
2. Keys with identical partitions are deduplicated (prefer well-known
   topology keys), and constant labels (one value fleet-wide, e.g.
   `kubernetes.io/os`) are dropped unless well-known — they carry no
   placement information.
3. Candidates are ordered by domain count and greedily chained under the
   REFINEMENT relation: key B refines key A iff every B-domain lies inside
   exactly one A-domain. Cross-cutting labels (`app`, team tags…) refine
   nothing and fall out; what survives is the maximal containment chain —
   the topology.
4. Each chain level is assigned a domain name: well-known keys pin their
   canonical domain (`kubernetes.io/hostname` → host, GKE TPU labels →
   slice/ici-block, …); unknown keys take the next free slot in the
   broad→narrow domain vocabulary (api/topology.py TOPOLOGY_DOMAIN_ORDER),
   so the result always passes validate_cluster_topology.

``detect_topology`` returns the CR, which ``cluster/manager.start_operator``
takes as its ``topology``; ``load_nodes_file`` reads a node list.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

from grove_tpu_torch.api.meta import ObjectMeta
from grove_tpu_torch.api.topology import (
    TOPOLOGY_DOMAIN_ORDER,
    ClusterTopology,
    ClusterTopologySpec,
    TopologyLevel,
)

# canonical key → domain anchors (reference vocabulary + TPU aliases + the
# standard k8s topology keys)
KNOWN_KEY_DOMAINS: Dict[str, str] = {
    "topology.kubernetes.io/region": "region",
    "topology.kubernetes.io/zone": "zone",
    "cloud.google.com/gke-cluster": "cluster",
    "cloud.google.com/gke-tpu-slice": "slice",
    "cloud.google.com/gke-tpu-ici-block": "ici-block",
    "kubernetes.io/hostname": "host",
}

# one representative domain per order slot, broad → narrow, for keys with no
# canonical anchor
_SLOT_DOMAINS = ("region", "zone", "cluster", "slice", "ici-block", "host", "chip")


class TopologyDetectionError(ValueError):
    """The node labels do not form a usable containment hierarchy."""


def _partitions(
    nodes: Sequence[Tuple[str, Mapping[str, str]]]
) -> Dict[str, Tuple[str, ...]]:
    """key → per-node value tuple (node order fixed), for keys on ALL nodes."""
    if not nodes:
        raise TopologyDetectionError("no nodes to detect a topology from")
    common = set(nodes[0][1])
    for _, labels in nodes[1:]:
        common &= set(labels)
    return {k: tuple(labels[k] for _, labels in nodes) for k in sorted(common)}


def _refines(fine: Tuple[str, ...], coarse: Tuple[str, ...]) -> bool:
    """Every fine-domain lies inside exactly one coarse-domain."""
    seen: Dict[str, str] = {}
    for f, c in zip(fine, coarse):
        prev = seen.setdefault(f, c)
        if prev != c:
            return False
    return True


def detect_topology_levels(
    nodes: Sequence[Tuple[str, Mapping[str, str]]]
) -> List[str]:
    """The maximal containment chain of label keys, broadest first."""
    parts = _partitions(nodes)

    # dedup identical partitions (known keys win, then lexicographic order);
    # the signature is the partition STRUCTURE (dense first-occurrence ids),
    # not the raw values — `zone-a` everywhere and `cluster-0` everywhere
    # are the same (trivial) partition
    def sig(values: Tuple[str, ...]) -> Tuple[int, ...]:
        ids: Dict[str, int] = {}
        return tuple(ids.setdefault(v, len(ids)) for v in values)

    by_sig: Dict[Tuple[int, ...], str] = {}
    for key in sorted(parts, key=lambda k: (k not in KNOWN_KEY_DOMAINS, k)):
        by_sig.setdefault(sig(parts[key]), key)
    candidates = sorted(
        by_sig.values(),
        key=lambda k: (len(set(parts[k])), k not in KNOWN_KEY_DOMAINS, k),
    )
    # constant labels carry no placement signal unless canonical
    candidates = [
        k
        for k in candidates
        if len(set(parts[k])) > 1 or k in KNOWN_KEY_DOMAINS
    ]

    chain: List[str] = []
    for key in candidates:
        if all(_refines(parts[key], parts[kept]) for kept in chain):
            chain.append(key)
    if not chain:
        raise TopologyDetectionError(
            "no label key forms a containment hierarchy across all nodes"
        )
    return chain


def detect_topology(
    nodes: Sequence, name: str = "default"
) -> ClusterTopology:
    """Infer a ClusterTopology from node objects (anything with `.name` and
    `.labels`, or (name, labels) pairs)."""
    pairs = [
        (n[0], n[1]) if isinstance(n, tuple) else (n.name, n.labels)
        for n in nodes
    ]
    chain = detect_topology_levels(pairs)
    if len(chain) > 7:
        # keep the narrowest levels (placement-relevant); name the dropped
        # broad keys so a packDomain/spreadDomain referencing one of them
        # fails validation with a visible cause rather than silently
        dropped = chain[:-7]
        import warnings

        warnings.warn(
            "topology detection found more than 7 containment levels;"
            f" dropping broadest label keys: {', '.join(dropped)}",
            stacklevel=2,
        )
        chain = chain[-7:]

    # assign domain names: known keys pin their slot; unknown keys take the
    # next free slot that keeps the broad→narrow order strict
    levels: List[TopologyLevel] = []
    next_order = 0
    unpinned: List[str] = []

    def flush_unpinned(limit: int) -> None:
        nonlocal next_order
        for key in unpinned:
            if next_order >= limit:
                raise TopologyDetectionError(
                    f"cannot fit detected level {key!r} into the domain"
                    " vocabulary order"
                )
            levels.append(TopologyLevel(domain=_SLOT_DOMAINS[next_order], key=key))
            next_order += 1
        unpinned.clear()

    for key in chain:
        domain = KNOWN_KEY_DOMAINS.get(key)
        if domain is None:
            unpinned.append(key)
            continue
        order = TOPOLOGY_DOMAIN_ORDER[domain]
        if order < next_order + len(unpinned):
            raise TopologyDetectionError(
                f"detected order of {key!r} conflicts with the canonical"
                f" domain vocabulary (needs slot >= {next_order + len(unpinned)},"
                f" canonical is {order})"
            )
        flush_unpinned(order)
        levels.append(TopologyLevel(domain=domain, key=key))
        next_order = order + 1
    flush_unpinned(len(_SLOT_DOMAINS))

    return ClusterTopology(
        metadata=ObjectMeta(name=name, namespace=""),
        spec=ClusterTopologySpec(levels=levels),
    )


def load_nodes_file(path: str) -> List[Tuple[str, Dict[str, str]]]:
    """Node (name, labels) pairs from YAML: accepts a k8s NodeList, a list
    of Node manifests, or a bare [{name, labels}] list."""
    import yaml

    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    items: List[dict] = []
    for doc in docs:
        if isinstance(doc, dict) and doc.get("kind") == "NodeList":
            items.extend(doc.get("items") or [])
        elif isinstance(doc, list):
            items.extend(doc)
        else:
            items.append(doc)
    out: List[Tuple[str, Dict[str, str]]] = []
    for item in items:
        if not isinstance(item, dict):
            raise TopologyDetectionError(
                f"{path}: node entries must be mappings with name/labels"
                f" (got {type(item).__name__}: {item!r})"
            )
        meta = item.get("metadata") or {}
        name = item.get("name") or meta.get("name") or f"node-{len(out)}"
        labels = item.get("labels") or meta.get("labels") or {}
        out.append((name, dict(labels)))
    return out
