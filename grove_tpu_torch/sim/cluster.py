"""Simulated cluster: nodes, a first-fit binder and the kubelets.

Counterpart of ``grove_tpu/sim/cluster.py``'s ``Node``, ``SimCluster`` and
``make_nodes``: the node lifecycle the node-health monitor drives
(heartbeats, kubelet crash and restart, the seeded fail-slow fault, node
and pod failure), the binding the scheduler round commits, the naive
first-fit ``schedule_pending`` and the kubelet's ``kubelet_tick`` (the
grove-initc waiter, then containers started and Ready).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from grove_tpu_torch.api.meta import (
    Condition,
    clone_status,
    deep_copy,
    get_condition,
    set_condition,
)
from grove_tpu_torch.api.pod import (
    COND_POD_READY,
    COND_POD_SCHEDULED,
    POD_PENDING,
    POD_RUNNING,
    ContainerStatus,
    Pod,
    is_ready,
    is_scheduled,
    is_terminating,
)
from grove_tpu_torch.initc.waiter import is_ready_to_start
from grove_tpu_torch.runtime.store import commit_status


# node lifecycle states (docs/robustness.md): Ready nodes heartbeat and
# accept placements; NotReady nodes missed heartbeats but are inside the
# grace window (pods stay bound, nothing new lands); Lost nodes exceeded
# the grace window — the node-health monitor fails their pods and drives
# gang rescue / requeue (controller/nodehealth.py)
NODE_READY = "Ready"
NODE_NOT_READY = "NotReady"
NODE_LOST = "Lost"
# gray failure (docs/robustness.md "Gray failures"): the node heartbeats
# — late but inside the grace window — and its pods keep running, yet the
# monitor's suspicion score says it is fail-slow. Degraded masks the node
# from NEW placements (same `schedulable` predicate every solve path
# consumes) without evicting anything; only the remediation controller
# may drain it, behind a what-if-proven flip and the disruption budget.
NODE_DEGRADED = "Degraded"


@dataclass
class Node:
    name: str
    capacity: Dict[str, float] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)  # topology keys
    cordoned: bool = False
    state: str = NODE_READY
    # virtual timestamp of the last kubelet heartbeat (frozen while crashed)
    last_heartbeat: float = 0.0
    # the node's kubelet is down (crash_node): no heartbeats
    crashed: bool = False

    @property
    def schedulable(self) -> bool:
        """A placement target: not cordoned and Ready."""
        return not self.cordoned and self.state == NODE_READY


class Bindings(dict):
    """``(namespace, pod) -> node`` in insertion order, with each node's keys
    indexed: ``keys_on(node)`` lists the pods bound to one node in the order
    a scan of the whole dict meets them (a key keeps its slot when rebound,
    and moves to the end when deleted and inserted again), so a per-node
    fold takes the same float subtractions in the same order as a filtered
    scan, without the scan."""

    def __init__(self, items=()) -> None:
        super().__init__()
        self._seq = 0
        self._slot: Dict[tuple, int] = {}
        self._by_node: Dict[str, Dict[tuple, int]] = {}
        for key, node in dict(items).items():
            self[key] = node

    def __setitem__(self, key, node) -> None:
        old = dict.get(self, key)
        if key in self._slot:
            if old != node:
                slot = self._by_node[old].pop(key)
                self._by_node.setdefault(node, {})[key] = slot
        else:
            self._seq += 1
            self._slot[key] = self._seq
            self._by_node.setdefault(node, {})[key] = self._seq
        dict.__setitem__(self, key, node)

    def __delitem__(self, key) -> None:
        node = dict.__getitem__(self, key)
        del self._by_node[node][key]
        del self._slot[key]
        dict.__delitem__(self, key)

    def pop(self, key, *default):
        if key in self:
            node = self[key]
            del self[key]
            return node
        if default:
            return default[0]
        raise KeyError(key)

    def setdefault(self, key, node=None):
        if key not in self:
            self[key] = node
        return self[key]

    def update(self, *args, **kwargs) -> None:
        for key, node in dict(*args, **kwargs).items():
            self[key] = node

    def popitem(self):
        key = next(reversed(self))
        return key, self.pop(key)

    def clear(self) -> None:
        dict.clear(self)
        self._slot.clear()
        self._by_node.clear()

    def keys_on(self, node: str) -> List[tuple]:
        slots = self._by_node.get(node)
        if not slots:
            return []
        return sorted(slots, key=slots.__getitem__)


@dataclass
class SimCluster:
    store: object
    nodes: List[Node] = field(default_factory=list)
    # (namespace, pod name) -> node name (a Bindings, whatever map is assigned)
    bindings: Dict[tuple, str] = field(default_factory=dict)
    # sticky history that survives a pod's deletion (reservation reuse)
    last_node: Dict[tuple, str] = field(default_factory=dict)
    start_delay: float = 0.0  # container start latency (virtual seconds)

    def __setattr__(self, name, value) -> None:
        # every map assigned to `bindings` (here, by the constructor or by a
        # caller) becomes a Bindings, whose per-node index node_free reads
        if name == "bindings" and not isinstance(value, Bindings):
            value = Bindings(value)
        object.__setattr__(self, name, value)

    def __post_init__(self) -> None:
        # epoch of rewrites of `bindings` outside the watch stream
        self.bindings_epoch = 0
        # (ns, name) of pods that exist and are not Ready, folded from the
        # store's watch events (a set, as the JAX package keeps it: its
        # iteration order is the kubelet's and the pending scan's); None until the
        # first read builds it with one scan
        self._not_ready: Optional[set] = None
        self._deleted_since_gc = True  # the first gc pass always runs
        # requests are immutable for a pod's lifetime: memo per uid
        self._requests_by_uid: Dict[str, Dict[str, float]] = {}
        # fail-slow fault registry: node name -> (seed, lag_min, lag_max,
        # start_penalty); only inject_failslow / heal_failslow write it
        self._failslow: Dict[str, tuple] = {}
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
            self._not_ready.discard(key)
        else:
            self._not_ready.add(key)

    def _not_ready_pods(self, namespace: Optional[str]):
        """Readonly views of the not-Ready working set."""
        if self._not_ready is None:
            self._not_ready = {
                (p.metadata.namespace, p.metadata.name)
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
        its capacity in binding order (``Bindings.keys_on``: the order of
        the JAX package's scan of every binding, without the scan)."""
        free = dict(node.capacity)
        for ns, pod_name in self.bindings.keys_on(node.name):
            pod = self.store.get("Pod", ns, pod_name, readonly=True)
            if pod is None or is_terminating(pod):
                continue
            for k, v in self._pod_requests(pod).items():
                free[k] = free.get(k, 0.0) - v
        return free

    def node_free_each(self, nodes: List[Node]) -> Dict[str, Dict[str, float]]:
        """``{node.name: node_free(node)}`` for every given node."""
        return {node.name: self.node_free(node) for node in nodes}

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

    def schedule_pending(self, namespace: Optional[str] = None) -> int:
        """Bind every ungated, unscheduled pod (all namespaces by default)
        to the first node that fits (the naive binder; the gang scheduler
        replaces it for topology-aware placement)."""
        bound = 0
        self._gc_bindings()
        for pod in self.store.list("Pod", namespace):
            if pod.spec.scheduling_gates or is_scheduled(pod) or is_terminating(pod):
                continue
            for node in self.nodes:
                if not node.schedulable or not self.fits(node, pod):
                    continue
                self.bind(pod, node.name)
                bound += 1
                break
        return bound

    def kubelet_tick(self, namespace: Optional[str] = None) -> int:
        """Advance scheduled pods (all namespaces by default) toward Ready:
        run the init waiter, then start containers and flip Ready. Returns
        the pods that transitioned."""
        self.heartbeat_tick()
        # a dead kubelet starts nothing: pods bound to crashed or Lost
        # nodes freeze until the monitor fails them or the node restarts
        dead_nodes = {n.name for n in self.nodes if n.crashed or n.state == NODE_LOST}
        progressed = 0
        # two phases: decide against the tick-start state, then apply, so a
        # dependent pod never starts in the tick its parent became Ready
        to_start = []
        for view in self._not_ready_pods(namespace):
            if not is_scheduled(view) or is_ready(view) or is_terminating(view):
                continue
            if dead_nodes and view.status.node_name in dead_nodes:
                continue
            if self._failslow:
                fs = self._failslow.get(view.status.node_name)
                if fs is not None:
                    # a fail-slow kubelet starts a pod only after
                    # `start_penalty` virtual seconds of scheduling age
                    cond = get_condition(view.status.conditions, COND_POD_SCHEDULED)
                    now = self.store.clock.now()
                    if cond is not None and now - cond.last_transition_time < fs[3]:
                        continue
            waiter_cfg = view.spec.extra.get("groveInitWaiter")
            waiter_clears = bool(waiter_cfg) and not view.status.init_waiter_done
            if waiter_clears and not is_ready_to_start(
                self.store, view.metadata.namespace, waiter_cfg
            ):
                continue
            to_start.append((view, waiter_clears))
        for view, waiter_clears in to_start:
            st = clone_status(view.status)
            if waiter_clears:
                st.init_waiter_done = True
            st.phase = POD_RUNNING
            st.container_statuses = [
                ContainerStatus(name=c.name, ready=True, started=True)
                for c in view.spec.containers
            ]
            set_condition(
                st.conditions,
                Condition(type=COND_POD_READY, status="True", reason="Started"),
                self.store.clock.now(),
            )
            if commit_status(self.store, view, st) is not None:
                progressed += 1
        return progressed

    # -- kubelet heartbeats and the node lifecycle -------------------------

    def heartbeat_tick(self) -> None:
        """One kubelet heartbeat round: every node whose kubelet is alive
        reports in. Crashed nodes stay silent — their last_heartbeat
        freezes and the node-health monitor's grace-period math takes over
        (virtual-time jumps between ticks therefore never fake a cluster-
        wide heartbeat loss: a node only ages while actually crashed)."""
        now = self.store.clock.now()
        for node in self.nodes:
            if not node.crashed:
                node.last_heartbeat = now
        if self._failslow:
            # fail-slow nodes heartbeat LATE: the report that lands this
            # tick was produced `lag` seconds ago. The lag stays inside the
            # monitor's NotReady grace window by default, so the binary
            # lifecycle never fires — only the suspicion EWMA sees it.
            for name in self._failslow:
                node = self.node(name)
                if node is not None and not node.crashed:
                    node.last_heartbeat = now - self.failslow_lag(name, now)

    def node(self, node_name: str) -> Optional[Node]:
        return next((n for n in self.nodes if n.name == node_name), None)

    def crash_node(self, node_name: str) -> bool:
        """Kill the node's kubelet: heartbeats stop, containers freeze. The
        node stays Ready (and keeps its pods bound) until the node-health
        monitor's grace period expires — the realistic failure path, unlike
        `fail_node`'s immediate cordon-and-evict."""
        node = self.node(node_name)
        if node is None:
            return False
        node.crashed = True
        return True

    def restart_node(self, node_name: str) -> bool:
        """Bring the node's kubelet back: heartbeats resume (fresh from this
        instant) and the monitor flips the node back to Ready on its next
        tick. A restart inside the grace window is a harmless flap."""
        node = self.node(node_name)
        if node is None:
            return False
        node.crashed = False
        node.last_heartbeat = self.store.clock.now()
        return True

    def inject_failslow(
        self,
        node_name: str,
        seed: int,
        lag_min: float = 3.0,
        lag_max: float = 8.0,
        start_penalty: float = 120.0,
    ) -> bool:
        """Arm the fail-slow (gray) fault on a node: heartbeats arrive
        `lag_min..lag_max` seconds late (seeded per-tick draw, below the
        monitor's 10s NotReady grace by default — the BINARY detector never
        fires) and bound pods start only after `start_penalty` seconds of
        scheduling age. Nothing crashes; the node looks alive everywhere
        except to the suspicion EWMA."""
        if self.node(node_name) is None:
            return False
        self._failslow[node_name] = (seed, lag_min, lag_max, start_penalty)
        return True

    def heal_failslow(self, node_name: str) -> bool:
        """Clear the fail-slow fault: heartbeats arrive on time again from
        the next tick; the monitor's hysteresis flips Degraded → Ready once
        the suspicion score decays below the recovery threshold."""
        return self._failslow.pop(node_name, None) is not None

    def failslow_lag(self, node_name: str, now: float) -> float:
        """The seeded heartbeat lag for a fail-slow node at virtual time
        `now` — a PURE function of (seed, node, tick): crc32, not random
        or hash(), so replays and the suspicion-oracle test (NumPy EWMA
        over this exact trace) see identical values. 0.0 when the node is
        not registered."""
        fs = self._failslow.get(node_name)
        if fs is None:
            return 0.0
        seed, lag_min, lag_max, _penalty = fs
        u = (
            zlib.crc32(f"{seed}:{node_name}:{int(now)}".encode()) & 0xFFFF
        ) / float(1 << 16)
        return lag_min + (lag_max - lag_min) * u

    def failslow_spec(self, node_name: str):
        """(seed, lag_min, lag_max, start_penalty) of an armed fail-slow
        fault, or None — the re-injection handle for harness swaps
        (leader failover / control-plane crash rebuild a SimCluster; the
        kubelet-side fault must survive, it is node state, not leader
        memory)."""
        return self._failslow.get(node_name)

    def failslow_names(self) -> set:
        """Nodes currently under the fail-slow fault (chaos invariants +
        the grayfail smoke read this; nothing outside this module writes
        the registry — GL022)."""
        return set(self._failslow)

    def unschedulable_names(self) -> set:
        """Names of nodes no solve may target (cordoned or unhealthy) —
        the set recovery-pin resolution avoids pinning to."""
        return {n.name for n in self.nodes if not n.schedulable}

    def fail_node(self, node_name: str) -> int:
        """Node loss: cordon the node and evict (delete) every pod bound to
        it — the node-controller behavior after a node goes NotReady. The
        PCLQ controllers recreate the pods gated; the scheduler's recovery
        delta-solve places them on surviving nodes (honoring gang/group
        recovery pins). Returns the number of pods evicted."""
        node = next((n for n in self.nodes if n.name == node_name), None)
        if node is None:
            return 0
        node.cordoned = True
        self._gc_bindings()  # stale entries must not count as evictions
        victims = [
            (ns, pod_name)
            for (ns, pod_name), bound in self.bindings.items()
            if bound == node_name
        ]
        evicted = 0
        for ns, pod_name in victims:
            if self.store.get("Pod", ns, pod_name) is not None:
                self.store.delete("Pod", ns, pod_name)
                evicted += 1
        return evicted

    def fail_pod(self, namespace: str, name: str, exit_code: int = 1) -> None:
        """Crash a pod's containers (fault injection for breach tests)."""
        view = self.store.get("Pod", namespace, name, readonly=True)
        if view is None:
            return
        st = deep_copy(view.status)
        st.phase = POD_PENDING
        for cs in st.container_statuses:
            cs.ready = False
            cs.exit_code = exit_code
            cs.restart_count += 1
        if not st.container_statuses:
            st.container_statuses = [
                ContainerStatus(name=c.name, started=True, exit_code=exit_code)
                for c in view.spec.containers
            ]
        set_condition(
            st.conditions,
            Condition(type=COND_POD_READY, status="False", reason="CrashLoop"),
            self.store.clock.now(),
        )
        commit_status(self.store, view, st)




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
