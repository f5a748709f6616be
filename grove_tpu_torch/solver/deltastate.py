"""Incremental delta-solve state: cluster arrays folded from watch deltas
instead of re-derived every tick.

Counterpart of ``grove_tpu/solver/deltastate.py``. A from-scratch round
re-derives its whole solver input: one pass over every binding
(``node_free_all``), a topology re-sort of every node (``encode_nodes``) and
a re-read of every pending gang (``_encode_pending``). At steady state a
tick changes little (a few gangs arrive, a few pods bind, a node flaps), and
this state keeps what did not change.

State kept, all dirty-masked:

- **Binding mirror**: per-node insertion-ordered pod sets mirroring
  ``SimCluster.bindings``. A node's order is the restriction of the global
  binding order, so a dirty node's recount sums requests in the order
  ``node_free_all`` does, and the float32 rows are equal bit for bit.
- **Free-capacity matrix** ``[N, R]``: rows recomputed for dirty nodes only.
- **Node encoding** (``encode.NodeEncoding``): invalidated by a change of
  the node signature (set, labels, capacity, schedulability); such a
  topology change falls back to a full re-encode (``full_fallbacks``), and
  the last four encodings are kept for a flap back.
- **Gang-spec cache**: encoded specs reused for gangs with no relevant pod
  or PodGang delta since they were built (``warm_start_hits``).

A topology change, a new resource name or drift found by the periodic
recount audit falls back to a full re-encode through the same assembly code,
so the delta and full paths cannot diverge; ``GangScheduler.delta_selfcheck``
holds every delta problem and solve to a from-scratch one.

An unsharded store delivers every event in commit order through
``subscribe_system``; a keyspace-sharded one through each shard's own
fan-out (``subscribe_system_per_shard``): an object's events never
straddle shards, so every order the fold depends on holds.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.pod import is_schedule_gated, is_scheduled, is_terminating
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.solver.encode import NodeEncoding, build_problem_cached
from grove_tpu_torch.analysis.sanitize import enabled as sanitize_enabled

_PROBLEM_TENSORS = (
    "capacity", "topo", "seg_starts", "seg_ends", "demand", "count",
    "min_count", "req_level", "pref_level", "priority", "group_req",
    "group_pin", "gang_pin", "spread_level", "spread_min",
    "spread_required", "spread_seed",
)
_PROBLEM_NAMES = (
    "node_names", "gang_names", "group_names", "resource_names",
    "level_keys",
)


def problems_identical(a, b) -> Optional[str]:
    """Bit-equality of two PackingProblems (every array, every name list).
    Returns None when identical, else the first field that differs."""
    for field in _PROBLEM_TENSORS:
        x, y = getattr(a, field), getattr(b, field)
        if (x is None) != (y is None):
            return field
        if x is not None and (
            x.shape != y.shape
            or x.dtype != y.dtype
            or not np.array_equal(x, y)
        ):
            return field
    for field in _PROBLEM_NAMES:
        if getattr(a, field) != getattr(b, field):
            return field
    return None


def _binding_feature(pod) -> Optional[str]:
    """The node this pod charges capacity to, or None while it charges
    nothing (bound and not terminating, as ``bindings`` and
    ``_used_by_node`` count it)."""
    if pod is None or pod.metadata.deletion_timestamp is not None:
        return None
    if not is_scheduled(pod):
        return None
    return pod.status.node_name or None


def _gang_feature(pod) -> Optional[tuple]:
    """The pod's part in its gang's encoded spec: existence, the inputs of
    pending-set membership (gates, scheduled, terminating) and its binding.
    Readiness is left out: a Ready flip changes neither the pending set nor
    scheduled counts, so it must not dirty the gang."""
    if pod is None or pod.metadata.deletion_timestamp is not None:
        return None
    return (
        is_scheduled(pod),
        is_schedule_gated(pod),
        pod.status.node_name,
    )


class DeltaSolveState:
    """Dirty-masked incremental encode state for one GangScheduler.

    Attach with ``GangScheduler.enable_delta()`` (the port's in-memory
    ``Store`` only: its watch events fire synchronously at commit, so the
    fold is always exact).
    """

    def __init__(
        self,
        store,
        cluster,
        topology,
        drift_check_every: int = 64,
    ) -> None:
        self.store = store
        self.cluster = cluster
        self.topology = topology
        self.drift_check_every = drift_check_every
        # node side
        self._enc: Optional[NodeEncoding] = None
        # encodings retired by a signature change, keyed by (node
        # signature, resource names): a flap back to a signature seen
        # before (cordon/uncordon, a node rejoining) reuses the retired
        # encoding. NodeEncoding is deterministic in (nodes, topology,
        # resource names), so an equal key is the identical encoding.
        self._enc_cache: Dict[tuple, NodeEncoding] = {}
        self._node_sig: Optional[tuple] = None
        self._node_resources: frozenset = frozenset()
        self._free: Optional[np.ndarray] = None
        self._free_version = 0
        self._enc_epoch = 0
        # binding mirror: node -> {(ns, name): None} insertion-ordered
        self._node_pods: Dict[str, Dict[Tuple[str, str], None]] = {}
        self._pod_node: Dict[Tuple[str, str], str] = {}
        self._dirty_nodes: set = set()
        self._mirror_built = False
        # gang-spec cache: (ns, gang) -> {"spec", "pods", "names", "rev"}
        self._specs: Dict[Tuple[str, str], dict] = {}
        self._dirty_gangs: set = set()
        self._spec_rev = 0
        # bookkeeping
        self._ticks = 0
        self._bindings_epoch = getattr(cluster, "bindings_epoch", 0)
        self.warm_start_hits = 0  # specs served from the cache (lifetime)
        self.solve_reuses = 0  # whole solves skipped (identical tick)
        self.full_fallbacks = 0
        self.drift_detected = 0
        self.last_reencoded = 0  # specs rebuilt this tick
        self.last_reused = 0  # specs served from the cache this tick
        # a sharded store delivers per shard; an object's events never
        # straddle shards, so the fold's orders hold there too
        if getattr(store, "num_shards", 1) > 1:
            store.subscribe_system_per_shard(self._on_event)
        else:
            store.subscribe_system(self._on_event)

    # -- watch-delta fold ------------------------------------------------

    def _on_event(self, ev) -> None:
        if ev.kind == "PodGang":
            # Both stores emit "Modified", never "Updated", so this early
            # return for status-only writes never runs and every PodGang
            # write dirties its gang, as in the JAX package, whose counters
            # (warm_start_hits, last_reencoded) the port is held to.
            if (
                ev.type == "Updated"
                and ev.old is not None
                and ev.old.spec is ev.obj.spec
                and ev.old.metadata.labels == ev.obj.metadata.labels
            ):
                return
            key = (ev.obj.metadata.namespace, ev.obj.metadata.name)
            self._dirty_gangs.add(key)
            if ev.type == "Deleted":
                self._specs.pop(key, None)
            return
        if ev.kind != "Pod":
            return
        old = ev.old if ev.old is not None else (
            ev.obj if ev.type == "Deleted" else None
        )
        new = None if ev.type == "Deleted" else ev.obj
        key = (ev.obj.metadata.namespace, ev.obj.metadata.name)
        # usage fold: the mirror is the authority for where the pod was
        # charged (a pod that turns terminating, then is deleted, sends two
        # events for one release). A pod charges capacity while bound and
        # not terminating; any transition in or out of that state, or a
        # node move, dirties the rows it touches.
        if self._mirror_built:
            new_node = _binding_feature(new)
            mirrored = self._pod_node.get(key)
            if new_node != mirrored:
                if mirrored is not None:
                    pods = self._node_pods.get(mirrored)
                    if pods is not None:
                        pods.pop(key, None)
                    self._pod_node.pop(key, None)
                    self._dirty_nodes.add(mirrored)
                if new_node is not None:
                    self._node_pods.setdefault(new_node, {})[key] = None
                    self._pod_node[key] = new_node
                    self._dirty_nodes.add(new_node)
        # spec fold: dirty the gang when a pending-set input changed
        if _gang_feature(old) != _gang_feature(new):
            for side in (old, new):
                if side is None:
                    continue
                gang = side.metadata.labels.get(namegen.LABEL_PODGANG)
                if gang:
                    self._dirty_gangs.add((side.metadata.namespace, gang))

    # -- node signature / topology-change detection ----------------------

    def _signature(self, nodes) -> Tuple[tuple, frozenset]:
        """Signature of the solve's node set: name, topology path and
        capacity of every schedulable node, in the caller's order. Any
        change is a topology change: dense ids, domain slabs and pin
        resolutions may all shift, so the state falls back to a full
        re-encode."""
        level_keys = [lvl.key for lvl in self.topology.spec.levels]
        sig = []
        rset = set()
        for n in nodes:
            caps = tuple(sorted(n.capacity.items()))
            rset.update(n.capacity)
            sig.append(
                (n.name, tuple(n.labels.get(k, "") for k in level_keys), caps)
            )
        return tuple(sig), frozenset(rset)

    # -- full resync ------------------------------------------------------

    def _resync_mirror(self) -> None:
        """Rebuild the binding mirror from ``cluster.bindings`` in its own
        (global insertion) order, so each node's order matches the recount
        order of ``node_free_all``."""
        self._node_pods = {}
        self._pod_node = {}
        for key, node_name in self.cluster.bindings.items():
            self._node_pods.setdefault(node_name, {})[key] = None
            self._pod_node[key] = node_name
        self._mirror_built = True

    def invalidate(self, reason: str = "manual") -> None:
        """For changes outside the watched channels (store commits, node
        attributes the signature sees): the next tick re-derives
        everything."""
        self._enc = None
        self._enc_cache.clear()
        self._node_sig = None
        self._free = None
        self._mirror_built = False
        self._specs.clear()
        self._dirty_gangs.clear()
        self._dirty_nodes.clear()
        if reason != "init":
            self.full_fallbacks += 1
            METRICS.inc("delta_full_fallbacks_total")

    def mark_node_dirty(self, node_name: str) -> None:
        """A node's free capacity changed outside the watched channels:
        recount its row next tick."""
        self._dirty_nodes.add(node_name)

    def mark_gang_dirty(self, namespace: str, gang_name: str) -> None:
        """A gang's encode inputs changed outside the watched channels:
        re-encode its spec next tick."""
        self._dirty_gangs.add((namespace, gang_name))

    # -- drift audit -------------------------------------------------------

    def check_drift(self, nodes) -> bool:
        """Exact audit: recount every node's free capacity from the live
        binding map and compare it to the kept rows. O(bound pods), so run
        periodically (every tick under the sanitizer). Returns True when it
        found drift; the state then invalidates itself and counts a
        fallback."""
        if self._enc is None or self._free is None:
            return False
        oracle = self.cluster.node_free_all(nodes)
        expect = np.zeros_like(self._free)
        for name, i in self._enc.node_index.items():
            caps = oracle.get(name, {})
            for r, rname in enumerate(self._enc.resource_names):
                expect[i, r] = caps.get(rname, 0.0)
        if np.array_equal(expect, self._free):
            return False
        self.drift_detected += 1
        METRICS.inc("delta_drift_detected_total")
        self.invalidate(reason="drift")
        return True

    # -- spec cache --------------------------------------------------------

    def cached_spec(
        self, namespace: str, gang_name: str, pods: List
    ) -> Optional[tuple]:
        """The cached (spec, gang_pods) of a clean gang whose pending pod
        set is unchanged; None forces a re-encode. ``pods`` is this tick's
        pending pod list of the gang."""
        key = (namespace, gang_name)
        if key in self._dirty_gangs:
            return None
        entry = self._specs.get(key)
        if entry is None:
            return None
        # the encoded spec is canonical in the pod-name set (group members
        # are name-sorted): compare sorted names, so order changes hit and
        # content changes miss
        names = tuple(sorted(p.metadata.name for p in pods))
        if entry["names"] != names:
            return None
        self.warm_start_hits += 1
        self.last_reused += 1
        METRICS.inc("delta_warm_start_hits_total")
        return entry["spec"], entry["pods"]

    def has_clean_spec(self, namespace: str, gang_name: str) -> bool:
        """Whether ``cached_spec`` could hit for this gang (clean and
        present), without counting a hit."""
        key = (namespace, gang_name)
        return key not in self._dirty_gangs and key in self._specs

    def store_spec(
        self,
        namespace: str,
        gang_name: str,
        pods: List,
        spec: dict,
        gang_pods: dict,
    ) -> None:
        key = (namespace, gang_name)
        self._spec_rev += 1
        self.last_reencoded += 1
        self._specs[key] = {
            "spec": spec,
            "pods": gang_pods,
            "names": tuple(sorted(p.metadata.name for p in pods)),
            "rev": self._spec_rev,
        }
        self._dirty_gangs.discard(key)

    def spec_rev(self, spec: dict) -> int:
        """Cache revision of an encoded spec (0 when uncached): one part of
        the solve fingerprint."""
        entry = self._specs.get((spec["namespace"], spec["gang_name"]))
        if entry is not None and entry["spec"] is spec:
            return entry["rev"]
        return 0

    # -- per-tick refresh + encode ----------------------------------------

    def _recount_row(self, node, resource_names: List[str]) -> None:
        """Recompute one node's free row as ``node_free_all`` does: a usage
        dict summed in binding order, one subtraction per resource, then
        the float32 row."""
        used: Dict[str, float] = {}
        for key in self._node_pods.get(node.name, ()):  # insertion order
            pod = self.store.get("Pod", key[0], key[1], readonly=True)
            if pod is None or is_terminating(pod):
                continue
            for k, v in self.cluster.pod_requests(pod).items():
                used[k] = used.get(k, 0.0) + v
        free = dict(node.capacity)
        for k, v in used.items():
            free[k] = free.get(k, 0.0) - v
        i = self._enc.node_index[node.name]
        for r, rname in enumerate(resource_names):
            self._free[i, r] = free.get(rname, 0.0)

    def _fold_dirty(self, nodes) -> int:
        """Recount every dirty node's free row against the current encoding
        (O(dirty)). Idle ticks fold through refresh so dirt never builds up;
        encode folds again for rows dirtied during the tick."""
        if self._enc is None or self._free is None:
            return 0
        dirty = self._dirty_nodes & set(self._enc.node_index)
        if dirty:
            if len(dirty) * 4 >= len(self._enc.node_index):
                # most rows dirty (a fallback tick): one global usage pass
                # beats per-node store walks, with the same bits
                free_all = self.cluster.node_free_all(nodes)
                rn = self._enc.resource_names
                for node in nodes:
                    if node.name not in dirty:
                        continue
                    caps = free_all[node.name]
                    i = self._enc.node_index[node.name]
                    for r, rname in enumerate(rn):
                        self._free[i, r] = caps.get(rname, 0.0)
            else:
                by_name = {n.name: n for n in nodes}
                for name in dirty:
                    node = by_name.get(name)
                    if node is not None:
                        self._recount_row(node, self._enc.resource_names)
            self._free_version += 1
        self._dirty_nodes.clear()
        return len(dirty)

    def refresh(self, nodes) -> None:
        """Per-tick upkeep before an encode: detect a topology change, run
        the periodic drift audit, (re)build the mirror when needed, and
        fold the dirty free-capacity rows."""
        self._ticks += 1
        self.last_reencoded = 0
        self.last_reused = 0
        epoch = getattr(self.cluster, "bindings_epoch", 0)
        if epoch != self._bindings_epoch:
            # rebuild_bindings rewrote the binding map outside the watch:
            # resync rather than trust the mirror
            self._bindings_epoch = epoch
            self.invalidate(reason="bindings-rebuilt")
        sig, rset = self._signature(nodes)
        if sig != self._node_sig:
            had = self._enc is not None
            self._enc = None
            self._free = None
            # pins and survivor seeds resolve against the node set: rebuild
            # every spec
            self._specs.clear()
            self._dirty_gangs.clear()
            self._node_sig = sig
            self._node_resources = rset
            if had:
                self.full_fallbacks += 1
                METRICS.inc("delta_full_fallbacks_total")
        if not self._mirror_built:
            self._resync_mirror()
            return
        # fold before the audit: rows dirtied by the last tick's binds are
        # folded here, and an audit first would read them as drift
        self._fold_dirty(nodes)
        every = 1 if sanitize_enabled() else self.drift_check_every
        if every and self._ticks % every == 0:
            if self.check_drift(nodes):
                self._resync_mirror()
                # drift is a usage-row fault, the topology is unchanged:
                # restore the signature the invalidate cleared, so the next
                # tick sees no second fallback and the rebuilt encoding
                # caches under its true signature
                self._node_sig = sig
                self._node_resources = rset

    def encode(
        self,
        nodes,
        gang_specs: List[dict],
        pad_gangs: Optional[int] = None,
        pad_groups: Optional[int] = None,
    ):
        """This tick's PackingProblem, built incrementally. Returns
        (problem, fingerprint); two ticks with equal fingerprints have
        identical solver input (the solve-reuse key)."""
        resource_names = sorted(
            self._node_resources.union(
                *(
                    grp["demand"].keys()
                    for spec in gang_specs
                    for grp in spec["groups"]
                )
            )
            if gang_specs
            else self._node_resources
        )
        if self._enc is None or self._enc.resource_names != resource_names:
            # first build, topology fallback or a new resource axis: every
            # row re-derives. A signature seen before (a flap back) reuses
            # the retired encoding. A None signature (an encode before the
            # next refresh re-signs) must not key the cache.
            key = (self._node_sig, tuple(resource_names))
            enc = (
                self._enc_cache.get(key)
                if self._node_sig is not None
                else None
            )
            if enc is None:
                enc = NodeEncoding(nodes, self.topology, resource_names)
                if self._node_sig is not None:
                    self._enc_cache[key] = enc
                    while len(self._enc_cache) > 4:  # oldest first
                        self._enc_cache.pop(next(iter(self._enc_cache)))
            self._enc = enc
            self._free = self._enc.base_capacity.copy()
            self._dirty_nodes = {n.name for n in nodes}
            self._enc_epoch += 1
        dirty = self._fold_dirty(nodes)
        METRICS.set("delta_dirty_nodes", dirty)
        METRICS.set("delta_dirty_gangs", len(self._dirty_gangs))
        problem = build_problem_cached(
            self._enc, self._free, gang_specs, pad_gangs, pad_groups
        )
        fingerprint = (
            self._enc_epoch,
            self._free_version,
            tuple(
                (spec["name"], self.spec_rev(spec)) for spec in gang_specs
            ),
            pad_gangs,
            pad_groups,
        )
        return problem, fingerprint

    def state_fingerprint(self) -> tuple:
        """Digest of every piece of mutable delta state (a pure read: no
        fold, no audit); ``free_crc`` is the crc32 of the free matrix's
        bytes."""
        free_crc = (
            None
            if self._free is None
            else zlib.crc32(self._free.tobytes())
        )
        return (
            self._enc_epoch,
            self._free_version,
            free_crc,
            self._spec_rev,
            tuple(sorted(self._specs)),
            tuple(sorted(self._dirty_nodes)),
            tuple(sorted(self._dirty_gangs)),
            self._mirror_built,
            len(self._pod_node),
            self._bindings_epoch,
        )

    def encoding_view(self) -> tuple:
        """The (NodeEncoding, free matrix) pair, read-only: the matrix is
        the live kept state, so callers copy before changing it; both are
        None until the first encode."""
        return self._enc, self._free

    def free_dicts(self, nodes) -> Dict[str, Dict[str, float]]:
        """Per-node free-capacity dicts from the kept matrix, for callers
        that take dicts (the gRPC sidecar's requests)."""
        out: Dict[str, Dict[str, float]] = {}
        if self._enc is None or self._free is None:
            return self.cluster.node_free_all(nodes)
        rn = self._enc.resource_names
        for node in nodes:
            i = self._enc.node_index.get(node.name)
            if i is None:
                out[node.name] = dict(node.capacity)
                continue
            out[node.name] = {
                r: float(self._free[i, j]) for j, r in enumerate(rn)
            }
        return out
