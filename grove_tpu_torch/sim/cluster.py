"""Simulated cluster: nodes and the binder the scheduler places pods with.

Counterpart of ``grove_tpu/sim/cluster.py``'s ``Node``, ``SimCluster`` and
``make_nodes``, without the kubelet, the heartbeats and the fail-slow
injection: the scheduler round binds pods, reads free capacity and the
not-Ready working set, and never starts a container.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from grove_tpu_torch.api.meta import Condition, clone_status, set_condition
from grove_tpu_torch.api.pod import (
    COND_POD_SCHEDULED,
    Pod,
    is_ready,
    is_scheduled,
    is_terminating,
)
from grove_tpu_torch.runtime.store import commit_status

# node lifecycle state that takes placements (the others: NotReady, Lost,
# Degraded)
NODE_READY = "Ready"


@dataclass
class Node:
    name: str
    capacity: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)  # topology keys
    cordoned: bool = False
    state: str = NODE_READY

    @property
    def schedulable(self) -> bool:
        """A placement target: not cordoned and Ready."""
        return not self.cordoned and self.state == NODE_READY


@dataclass
class SimCluster:
    store: object
    nodes: List[Node] = field(default_factory=list)
    # (namespace, pod name) -> node name
    bindings: Dict[tuple, str] = field(default_factory=dict)
    # sticky history that survives a pod's deletion (reservation reuse)
    last_node: Dict[tuple, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        # epoch of rewrites of `bindings` outside the watch stream
        self.bindings_epoch = 0
        # (ns, name) of pods that exist and are not Ready, folded from the
        # store's watch events (a dict as an ordered set); None until the
        # first read builds it with one scan
        self._not_ready: Optional[Dict[tuple, None]] = None
        self._deleted_since_gc = True  # the first gc pass always runs
        # requests are immutable for a pod's lifetime: memo per uid
        self._requests_by_uid: Dict[str, Dict[str, float]] = {}
        self.store.subscribe_system(self._track_pod_event)

    def _track_pod_event(self, ev) -> None:
        if ev.kind != "Pod":
            return
        if ev.type == "Deleted":
            self._deleted_since_gc = True
            self._requests_by_uid.pop(ev.obj.metadata.uid, None)
        if self._not_ready is None:
            return
        key = (ev.obj.metadata.namespace, ev.obj.metadata.name)
        if ev.type == "Deleted" or is_ready(ev.obj):
            self._not_ready.pop(key, None)
        else:
            self._not_ready[key] = None

    def _not_ready_pods(self, namespace: Optional[str]):
        """Readonly views of the not-Ready working set."""
        if self._not_ready is None:
            self._not_ready = {
                (p.metadata.namespace, p.metadata.name): None
                for p in self.store.scan("Pod")
                if not is_ready(p)
            }
        for ns, name in list(self._not_ready):
            if namespace is not None and ns != namespace:
                continue
            pod = self.store.get("Pod", ns, name, readonly=True)
            if pod is not None:
                yield pod

    def rebuild_bindings(self) -> int:
        """The binding map from persisted pod status (``status.node_name``):
        how a fresh scheduler accounts for pods bound before it started."""
        n = 0
        for pod in self.store.scan("Pod"):
            if is_terminating(pod) or not is_scheduled(pod):
                continue
            node = pod.status.node_name
            if node:
                key = (pod.metadata.namespace, pod.metadata.name)
                self.bindings[key] = node
                self.last_node.setdefault(key, node)
                n += 1
        self.bindings_epoch += 1
        return n

    def _gc_bindings(self) -> None:
        """Drop bindings whose pod is gone or no longer scheduled; skipped
        while no pod was deleted since the last pass."""
        if not self._deleted_since_gc:
            return
        self._deleted_since_gc = False
        stale = []
        for (ns, name), _node in self.bindings.items():
            pod = self.store.get("Pod", ns, name, readonly=True)
            if pod is None or not is_scheduled(pod):
                stale.append((ns, name))
        for key in stale:
            del self.bindings[key]

    # -- capacity --------------------------------------------------------

    def _pod_requests(self, pod) -> Dict[str, float]:
        uid = pod.metadata.uid
        reqs = self._requests_by_uid.get(uid)
        if reqs is None:
            reqs = self._requests_by_uid[uid] = pod.spec.total_requests()
        return reqs

    def pod_requests(self, pod) -> Dict[str, float]:
        """Memoized ``total_requests`` per pod uid, shared with the delta
        state's row recounts so both sides sum the same dict objects."""
        return self._pod_requests(pod)

    def _used_by_node(self) -> Dict[str, Dict[str, float]]:
        """Committed usage per node in one pass over the bindings."""
        used: Dict[str, Dict[str, float]] = {}
        for (ns, pod_name), node_name in self.bindings.items():
            pod = self.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None or is_terminating(pod):
                continue
            u = used.setdefault(node_name, {})
            for k, v in self._pod_requests(pod).items():
                u[k] = u.get(k, 0.0) + v
        return used

    def node_free_all(self, nodes: List[Node]) -> Dict[str, Dict[str, float]]:
        """Free capacity of every given node: capacity less the usage
        summed in one pass."""
        used = self._used_by_node()
        out: Dict[str, Dict[str, float]] = {}
        for node in nodes:
            free = dict(node.capacity)
            for k, v in used.get(node.name, {}).items():
                free[k] = free.get(k, 0.0) - v
            out[node.name] = free
        return out

    def node_free(self, node: Node) -> Dict[str, float]:
        """Free capacity of one node: each bound pod's requests taken off
        its capacity in binding order."""
        free = dict(node.capacity)
        for (ns, pod_name), node_name in self.bindings.items():
            if node_name != node.name:
                continue
            pod = self.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None or is_terminating(pod):
                continue
            for k, v in self._pod_requests(pod).items():
                free[k] = free.get(k, 0.0) - v
        return free

    def node_free_each(self, nodes: List[Node]) -> Dict[str, Dict[str, float]]:
        """``{node.name: node_free(node)}`` for every given node in one
        pass over the bindings, with the same subtractions in the same
        order (so the same floats): node_free per node costs
        O(nodes × bindings)."""
        out = {node.name: dict(node.capacity) for node in nodes}
        for (ns, pod_name), node_name in self.bindings.items():
            free = out.get(node_name)
            if free is None:
                continue
            pod = self.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None or is_terminating(pod):
                continue
            for k, v in self._pod_requests(pod).items():
                free[k] = free.get(k, 0.0) - v
        return out

    def fits(self, node: Node, pod: Pod) -> bool:
        free = self.node_free(node)
        return all(free.get(k, 0.0) >= v for k, v in pod.spec.total_requests().items())

    def bind(self, pod: Pod, node_name: str) -> None:
        """Mark the pod scheduled on ``node_name`` (a copy-on-write status
        commit), then record the binding."""
        view = self.store.get("Pod", pod.metadata.namespace, pod.metadata.name, readonly=True)
        if view is None:
            return
        st = clone_status(view.status)
        st.node_name = node_name
        set_condition(
            st.conditions,
            Condition(type=COND_POD_SCHEDULED, status="True", reason="Bound"),
            self.store.clock.now(),
        )
        commit_status(self.store, view, st)
        key = (view.metadata.namespace, view.metadata.name)
        self.bindings[key] = node_name
        self.last_node[key] = node_name

    def unschedulable_names(self) -> set:
        """Names of nodes no solve may target (cordoned or not Ready)."""
        return {n.name for n in self.nodes if not n.schedulable}


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
