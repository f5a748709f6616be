"""In-memory object store: the port's stand-in for the apiserver.

Counterpart of ``grove_tpu/runtime/store.py``. The semantics the
controllers rely on:

- resourceVersion bump per write, generation bump on spec writes only,
  conflicts on a stale resourceVersion (``GroveError`` with
  ``ERR_CONFLICT``) and no-op suppression;
- watch events (Added/Modified/Deleted) fanned out to the system watchers
  (``subscribe_system``: the sim cluster, the scheduler's folds) and then to
  the operator's watchers (``subscribe``: the engine);
- finalizer-aware deletion (a deletion timestamp first, removal once the
  finalizers drain), ``delete_collection``;
- label-selector reads over an inverted index of the hot labels, and a
  per-kind namespace index;
- the lagged informer cache (``cache_lag``): ``cached=True`` reads are served
  from a view that advances only as the engine delivers each kind's events
  (``apply_event_to_cache``) or on ``sync_cache``, reproducing the staleness
  the reference's expectations store exists to absorb;
- zero-copy reads (``scan``, ``get(readonly=True)``, watch payloads share the
  committed objects, which are never mutated) and ``commit_cow``, the
  copy-on-write commit that shares every untouched field; every other commit
  keeps a canonical pickled blob that mutable reads load from, and
  ``verify_readonly_integrity`` checks each object against it;
- per-PodClique pod counters and the cluster's (total, ready) live pods
  folded at commit (``runtime/aggregate.py``), one per read view;
- an optional authorization guard (``as_user``) and fault injectors;
- the glass-box hooks, one boolean check each while off: the flight
  recorder's commit digests, the journeys' PodGang marks, and the wall
  profiler's ``snapshot``, ``store-commit`` and ``status-write`` phases;
- keyspace shards (``num_shards``, else ``GROVE_TPU_STORE_SHARDS``, default
  1): namespaces hash onto S shards (``runtime/shards.shard_of``; the
  cluster-scoped namespace "" is shard 0), each with its own object maps,
  indices, lock, resourceVersion sequence, per-shard watch fan-out and pod
  aggregate. A namespace-scoped read touches its owning shard only; a
  cross-shard ``list`` merges by one (namespace, name) sort and ``scan``
  chains the shards in index order. The scalar ``resource_version`` is the
  sum of the shards' sequences (every commit bumps one shard by one), and
  ``pod_summary`` folds the shards' (total, ready) partials up the
  fan-in-8 ``ShardSummaryTree``. S=1 is the unsharded store;
- the parallel drain's hooks (``runtime/workers.py``,
  ``runtime/procworkers.py``): the deferred fan-out
  (``arm_deferred_fanout``: while a thread holds an open capture buffer,
  the order-sensitive watchers' deliveries are buffered for the
  coordinator to replay in the serial order) and ``apply_remote_event``
  (a worker process's commit mirror-applied, its resourceVersion
  restamped);
- the durability layer's recovery load (``restore_objects``); the WAL
  itself is a per-shard system watcher (``durability/``).
"""

from __future__ import annotations

import copy as _copy
import os
import pickle
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from grove_tpu_torch.api.meta import deep_copy, next_uid
from grove_tpu_torch.observability.flightrec import FLIGHTREC
from grove_tpu_torch.observability.journey import JOURNEYS
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.profile import (
    PHASE_SNAPSHOT,
    PHASE_STATUS_WRITE,
    PHASE_STORE_COMMIT,
    PROFILER,
)
from grove_tpu_torch.runtime.clock import Clock
from grove_tpu_torch.runtime.errors import (
    ERR_CONFLICT,
    ERR_FORBIDDEN,
    ERR_NOT_FOUND,
    GroveError,
)
from grove_tpu_torch.runtime.shards import ShardSummaryTree, StoreShard, shard_of
from grove_tpu_torch.utils.sanitize import store_guard_enabled

ADDED = "Added"
MODIFIED = "Modified"
DELETED = "Deleted"

_UNSET = object()  # commit_cow sentinel: "field not replaced"

# label keys with an inverted index (the controllers' hot selectors)
INDEXED_LABELS = (
    "grove.io/podclique",
    "grove.io/podgang",
    "grove.io/podcliquescalinggroup",
    "app.kubernetes.io/part-of",
)


def _dumps(obj) -> Optional[bytes]:
    """Canonical pickled form of a committed object, computed once per
    write; mutable reads load it. None when the object does not pickle."""
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception:
        return None


def _materialize(obj, blob: Optional[bytes]):
    return pickle.loads(blob) if blob is not None else deep_copy(obj)


@dataclass
class WatchEvent:
    type: str
    kind: str
    obj: object  # the committed object: read-only for every subscriber
    blob: Optional[bytes] = field(default=None, repr=False, compare=False)
    # previous committed object on MODIFIED events (same read-only contract)
    old: Optional[object] = field(default=None, repr=False, compare=False)
    # owning keyspace shard: the engine's per-shard backlogs route on it
    shard: int = field(default=0, repr=False, compare=False)

    def materialize(self):
        """Private deep copy of the event payload."""
        return _materialize(self.obj, self.blob)


def obj_key(obj) -> str:
    return f"{obj.metadata.namespace}/{obj.metadata.name}"


def commit_status(store, view, status):
    """Status write against a readonly ``view`` through the store's
    copy-on-write commit, or, on a store without one (``HttpStore``), a
    mutable re-get and ``update_status``. Returns the committed object, or
    None when it disappeared."""
    cow = getattr(store, "commit_cow", None)
    if cow is not None:
        return cow(view, status=status)
    fresh = store.get(view.kind, view.metadata.namespace, view.metadata.name)
    if fresh is None:
        return None
    fresh.status = status
    return store.update_status(fresh)


def commit_finalizer_add(store, view, finalizer: str):
    """Finalizer add (a metadata write, no generation bump) against a
    readonly ``view``, copy-on-write where the store has it. Returns the
    committed object, or None when it disappeared (``HttpStore``)."""
    cow = getattr(store, "commit_cow", None)
    if cow is not None:
        meta = _copy.copy(view.metadata)
        meta.finalizers = list(view.metadata.finalizers)
        meta.finalizers.append(finalizer)
        return cow(view, metadata=meta)
    fresh = store.get(view.kind, view.metadata.namespace, view.metadata.name)
    if fresh is None:
        return None
    if finalizer not in fresh.metadata.finalizers:
        fresh.metadata.finalizers.append(finalizer)
        return store.update(fresh, bump_generation=False)
    return fresh


def commit_spec(store, view, spec):
    """Spec write (no generation bump) against a readonly ``view``,
    copy-on-write where the store has it, else a mutable re-get and
    update."""
    cow = getattr(store, "commit_cow", None)
    if cow is not None:
        return cow(view, spec=spec)
    fresh = store.get(view.kind, view.metadata.namespace, view.metadata.name)
    if fresh is None:
        return None
    fresh.spec = spec
    return store.update(fresh, bump_generation=False)


def _index_insert(index: Dict[tuple, set], obj) -> None:
    key = obj_key(obj)
    for lk in INDEXED_LABELS:
        lv = obj.metadata.labels.get(lk)
        if lv is not None:
            index.setdefault((lk, lv), set()).add(key)


def _index_delete(index: Dict[tuple, set], obj) -> None:
    key = obj_key(obj)
    for lk in INDEXED_LABELS:
        lv = obj.metadata.labels.get(lk)
        if lv is not None:
            entries = index.get((lk, lv))
            if entries is not None:
                entries.discard(key)


def matches_labels(obj, selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    labels = obj.metadata.labels or {}
    for k, v in selector.items():
        if labels.get(k) != v:
            return False
    return True


class Store:
    def __init__(
        self,
        clock: Optional[Clock] = None,
        cache_lag: bool = False,
        num_shards: Optional[int] = None,
    ) -> None:
        self.clock = clock or Clock()
        self.cache_lag = cache_lag
        if num_shards is None:
            num_shards = int(os.environ.get("GROVE_TPU_STORE_SHARDS", "1") or 1)
        self.num_shards = max(1, int(num_shards))
        self._shards: List[StoreShard] = [
            StoreShard(i, cache_lag) for i in range(self.num_shards)
        ]
        self._single = self.num_shards == 1
        # namespace -> owning shard (crc32 once per namespace)
        self._shard_memo: Dict[str, StoreShard] = {}
        # the level-2 fold of the shards' (total, ready) pod partials, one
        # tree per read view; the dirty sets name the shards whose partial
        # moved since the last read, so a read refolds only their paths
        self._summary_tree = ShardSummaryTree(self.num_shards)
        self._summary_tree_cached = (
            ShardSummaryTree(self.num_shards) if cache_lag else self._summary_tree
        )
        self._summary_dirty = set(range(self.num_shards))
        self._summary_dirty_cached = set(range(self.num_shards))
        self._watchers: List[Callable[[WatchEvent], None]] = []
        self._system_watchers: List[Callable[[WatchEvent], None]] = []
        # the per-shard-fanned consumers (``subscribe_system_per_shard``) and
        # the deferred-capture plumbing the parallel drain arms: inert until
        # ``arm_deferred_fanout`` runs
        self._per_shard_fns: List[Callable[[WatchEvent], None]] = []
        self._deferred_armed = False
        self._capture_tls = threading.local()
        # copy-on-write commits skip the canonical blob unless the store
        # guard is on (then verify_readonly_integrity covers them too)
        self._guard_blobs = store_guard_enabled()
        # optional admission guard (admission/authorization.py): writes are
        # checked against the current actor; in-process controllers act as
        # the operator identity
        self.guard = None
        self.actor: Optional[str] = None
        # fault injection: "create" | "update" | "delete" -> callable(obj)
        # -> Optional[Exception]; a returned exception is raised before the
        # write commits
        self.error_injectors: Dict[str, Callable] = {}
        # events carry their object's shard ("newest store wins", as the
        # tracer's and the recorder's clocks)
        from grove_tpu_torch.observability.events import EVENTS

        EVENTS.shard_fn = self.shard_index if self.num_shards > 1 else None

    def _inject(self, operation: str, obj) -> None:
        injector = self.error_injectors.get(operation)
        if injector is not None:
            err = injector(obj)
            if err is not None:
                raise err

    @contextmanager
    def as_user(self, username: str):
        """Attribute the writes inside the block to ``username``."""
        previous = self.actor
        self.actor = username
        try:
            yield self
        finally:
            self.actor = previous

    def _authorize(self, operation: str, obj) -> None:
        if self.guard is None:
            return
        from grove_tpu_torch.admission.authorization import OPERATOR_USERNAME

        actor = self.actor or OPERATOR_USERNAME
        decision = self.guard.check(actor, operation, obj)
        if not decision.allowed:
            raise GroveError(ERR_FORBIDDEN, decision.reason, operation)

    # -- shard routing ---------------------------------------------------

    def _shard_for(self, namespace: str) -> StoreShard:
        """Owning shard of a namespace (memoized: the router runs on every
        read and write)."""
        if self._single:
            return self._shards[0]
        shard = self._shard_memo.get(namespace)
        if shard is None:
            shard = self._shards[shard_of(namespace, self.num_shards)]
            self._shard_memo[namespace] = shard
        return shard

    def _shard_of_obj(self, obj) -> StoreShard:
        if self._single:
            return self._shards[0]
        return self._shard_for(obj.metadata.namespace)

    def shard_index(self, namespace: str) -> int:
        """The keyspace map: which shard owns ``namespace``."""
        return 0 if self._single else shard_of(namespace, self.num_shards)

    def shard_resource_version(self, index: int) -> int:
        """One shard's resourceVersion sequence."""
        return self._shards[index].rv

    def shard_emitted(self, index: int) -> int:
        """Events one shard emitted so far (moves on every commit and on
        hard deletes, which the rv sequence skips)."""
        return self._shards[index].emitted

    def resource_version_vector(self) -> Tuple[int, ...]:
        """Per-shard resourceVersions (the exact form of the scalar)."""
        return tuple(s.rv for s in self._shards)

    def shard_census(self) -> List[dict]:
        """Objects and rv per shard; also sets the ``store_shard_objects``
        and ``store_shard_rv`` gauges per shard."""
        out = []
        for s in self._shards:
            n = s.object_count()
            METRICS.set(f"store_shard_objects@{s.index}", n)
            METRICS.set(f"store_shard_rv@{s.index}", s.rv)
            out.append({"shard": s.index, "objects": n, "rv": s.rv})
        return out

    @property
    def resource_version(self) -> int:
        """The store's resourceVersion watermark: the sum of the shards'
        sequences, which is the count of commits."""
        if self._single:
            return self._shards[0].rv
        return sum(s.rv for s in self._shards)

    @property
    def rv(self) -> int:
        """The unsharded store's resourceVersion sequence (settable: a store
        built from another store's documents carries its watermark over)."""
        if not self._single:
            raise AttributeError("a sharded store has one rv per shard")
        return self._shards[0].rv

    @rv.setter
    def rv(self, value: int) -> None:
        if not self._single:
            raise AttributeError("a sharded store has one rv per shard")
        self._shards[0].rv = value

    def kinds(self) -> List[str]:
        """Kinds with at least one committed object."""
        kinds = set()
        for shard in self._shards:
            kinds.update(k for k, v in shard.committed.items() if v)
        return sorted(kinds)

    def shard_kinds(self, index: int) -> List[str]:
        """One shard's kinds with at least one committed object."""
        return sorted(k for k, v in self._shards[index].committed.items() if v)

    def shard_scan(self, index: int, kind: str) -> Iterator[object]:
        """Read-only iteration over one shard's committed objects of a
        kind (the contract of ``scan``)."""
        yield from self._shards[index].committed.get(kind, {}).values()

    # -- watch -----------------------------------------------------------

    def subscribe(self, fn: Callable[[WatchEvent], None]) -> None:
        """Operator-side watch (the engine)."""
        self._watchers.append(fn)

    def subscribe_system(
        self, fn: Callable[[WatchEvent], None], shard: Optional[int] = None
    ) -> None:
        """Cluster-side watch (sim kubelet, scheduler folds): delivered
        before the operator's watchers. With ``shard=k`` only shard k's
        events reach ``fn``, delivered before the store-wide watchers (a
        shard's WAL stream). Store-wide watchers are deferrable once the
        parallel drain armed the capture; per-shard ones stay live."""
        if shard is None:
            self._system_watchers.append(
                self._make_deferrable(fn) if self._deferred_armed else fn
            )
        else:
            self._shards[shard].system_watchers.append(fn)

    def subscribe_system_per_shard(self, fn: Callable[[WatchEvent], None]) -> None:
        """Register ``fn`` on every shard's own fan-out (folds whose
        per-object streams never straddle shards: the quota accountant, the
        delta state). At S=1 it is delivered as ``subscribe_system``'s
        watchers are, ahead of them. These fold shared, order-sensitive
        state, so the parallel drain defers them (``arm_deferred_fanout``);
        a registration after arming is wrapped at once."""
        self._per_shard_fns.append(fn)
        target = self._make_deferrable(fn) if self._deferred_armed else fn
        for s in self._shards:
            s.system_watchers.append(target)

    # -- deferred fan-out (the parallel drain) -----------------------------

    def arm_deferred_fanout(self) -> None:
        """Make every order-sensitive watcher capturable: the
        ``subscribe_system_per_shard`` folds (shared float accumulations)
        and the store-wide ``subscribe_system`` watchers (the sim cluster's
        not-ready set, whose iteration order is its insertion history).
        While a thread holds an open capture buffer (a reconcile on a
        worker), their deliveries are buffered; the coordinator replays
        them in the serial batch order. Threads with no open buffer keep
        live delivery. Armed once, only by the engine's ``enable_workers``."""
        if self._deferred_armed:
            return
        self._deferred_armed = True
        wrapped = {fn: self._make_deferrable(fn) for fn in self._per_shard_fns}
        for s in self._shards:
            s.system_watchers = [wrapped.get(w, w) for w in s.system_watchers]
        self._system_watchers = [self._make_deferrable(w) for w in self._system_watchers]

    def _make_deferrable(self, fn: Callable[[WatchEvent], None]):
        tls = self._capture_tls

        def deliver(ev: WatchEvent, _fn=fn, _tls=tls) -> None:
            buf = getattr(_tls, "buf", None)
            if buf is None:
                _fn(ev)
            else:
                buf.append((_fn, ev))

        return deliver

    def begin_deferred_capture(self) -> list:
        """Open a capture buffer on this thread (one reconcile's deferred
        deliveries); pass it to ``end_deferred_capture``."""
        buf: list = []
        self._capture_tls.buf = buf
        return buf

    def end_deferred_capture(self, buf: list) -> list:
        """Close this thread's capture buffer; returns its (fn, event)
        deliveries for the coordinator's in-order replay."""
        self._capture_tls.buf = None
        return buf

    def _emit(
        self, type_: str, obj, blob: Optional[bytes], old=None,
        shard: Optional[StoreShard] = None,
    ) -> None:
        if shard is None:
            shard = self._shard_of_obj(obj)
        ev = WatchEvent(
            type=type_, kind=obj.kind, obj=obj, blob=blob, old=old, shard=shard.index
        )
        shard.emitted += 1
        # fold the delta into the owning shard's pod aggregate (kind-gated
        # inside; `old` is the previous committed object); the summary tree
        # refolds that shard's path at the next read
        shard.agg_committed.apply(type_, obj, old)
        if obj.kind == "Pod":
            self._summary_dirty.add(shard.index)
        if FLIGHTREC.enabled:
            FLIGHTREC.note_commit(ev)
        if JOURNEYS.enabled and obj.kind == "PodGang":
            if type_ == ADDED:
                JOURNEYS.note_created(obj.metadata.namespace, obj.metadata.name)
            elif type_ == DELETED:
                JOURNEYS.note_deleted(obj.metadata.namespace, obj.metadata.name)
        # the owning shard's subscribers, then the store-wide system
        # watchers, then the operator's
        for w in shard.system_watchers:
            w(ev)
        for w in self._system_watchers:
            w(ev)
        for w in self._watchers:
            w(ev)

    # -- cache -----------------------------------------------------------

    def sync_cache(self) -> None:
        """Advance the whole read cache to the committed state."""
        kinds = set()
        for shard in self._shards:
            kinds.update(shard.committed)
        for kind in sorted(kinds):
            self.sync_cache_kind(kind)

    def sync_cache_kind(self, kind: str) -> None:
        """Advance one kind's cache (that kind's informer resyncing).
        Committed objects are immutable, so the cache shares them."""
        for shard in self._shards:
            shard.cache[kind] = dict(shard.committed.get(kind, {}))
            shard.cache_blob[kind] = dict(shard.blob.get(kind, {}))
            index: Dict[tuple, set] = {}
            ns_index: Dict[str, Dict[str, None]] = {}
            for key, obj in shard.cache[kind].items():
                _index_insert(index, obj)
                ns_index.setdefault(obj.metadata.namespace, {})[key] = None
            shard.cache_label_index[kind] = index
            shard.cache_ns_index[kind] = ns_index
            if kind == "Pod" and self.cache_lag:
                shard.agg_cached.rebuild(shard.cache[kind].values())
                self._summary_dirty_cached.add(shard.index)

    def apply_event_to_cache(self, ev: WatchEvent) -> None:
        """Apply one delivered watch event to the read cache (the informer's
        incremental update), in the shard the event carries."""
        shard = self._shards[ev.shard]
        kind_cache = shard.cache.setdefault(ev.kind, {})
        kind_blob = shard.cache_blob.setdefault(ev.kind, {})
        kind_index = shard.cache_label_index.setdefault(ev.kind, {})
        kind_ns = shard.cache_ns_index.setdefault(ev.kind, {})
        key = obj_key(ev.obj)
        old = kind_cache.get(key)
        if ev.kind == "Pod" and self.cache_lag:
            # the cached view advances exactly here: fold the same delta
            # into its aggregate (without lag the two views are one)
            shard.agg_cached.apply(ev.type, ev.obj, old)
            self._summary_dirty_cached.add(shard.index)
        if old is not None:
            _index_delete(kind_index, old)
        if ev.type == DELETED:
            kind_cache.pop(key, None)
            kind_blob.pop(key, None)
            ns_map = kind_ns.get(ev.obj.metadata.namespace)
            if ns_map is not None:
                ns_map.pop(key, None)
            return
        kind_cache[key] = ev.obj
        if ev.blob is not None:
            kind_blob[key] = ev.blob
        else:
            kind_blob.pop(key, None)
        _index_insert(kind_index, ev.obj)
        # a replaced key keeps its slot, so the namespace-scoped scan order
        # equals the flat filtered-scan order
        kind_ns.setdefault(ev.obj.metadata.namespace, {})[key] = None

    # -- pod aggregates --------------------------------------------------

    def pod_counters(self, namespace: str, name: str, cached: bool = False):
        """Aggregated pod-status counters of one PodClique, equal to a full
        rescan of the view the caller would have scanned (committed, or the
        lagged cache with ``cached=True``), read from the namespace's owning
        shard. The row is read-only."""
        shard = self._shard_for(namespace)
        agg = shard.agg_cached if (cached and self.cache_lag) else shard.agg_committed
        return agg.counters(namespace, name)

    def pod_summary(self, cached: bool = False) -> Tuple[int, int]:
        """Cluster-wide (total, ready) over live (non-terminating) pods: the
        shards' partials folded up the level-2 summary tree. Shards whose
        partial moved since the last read are refolded: the whole tree when
        more than half moved, else each one's ancestor path."""
        use_cache = cached and self.cache_lag
        tree = self._summary_tree_cached if use_cache else self._summary_tree
        dirty = self._summary_dirty_cached if use_cache else self._summary_dirty
        drained = sorted(dirty)
        dirty.clear()
        if drained:

            def partial(s: StoreShard) -> Tuple[int, int]:
                agg = s.agg_cached if use_cache else s.agg_committed
                return (agg.grand_total, agg.grand_ready)

            if 2 * len(drained) > self.num_shards:
                tree.refold([partial(s) for s in self._shards])
            else:
                for i in drained:
                    tree.update_leaf(i, partial(self._shards[i]))
        METRICS.set("aggregate_fold_depth", tree.depth)
        return tree.root()

    def fold_depth_histogram(self) -> List[int]:
        """Nodes per level of the level-2 fold tree, leaves first."""
        return self._summary_tree.fold_depth_histogram()

    # -- indices ---------------------------------------------------------

    def _shard_candidates(self, shard, kind, namespace, selector, use_cache, view) -> List[object]:
        """Smallest indexed candidate set within one shard: an indexed label
        of the selector, else the namespace's keys, else every object of
        the kind."""
        if selector:
            index = (shard.cache_label_index if use_cache else shard.label_index).get(kind)
            if index is not None:
                best = None
                for lk in INDEXED_LABELS:
                    if lk in selector:
                        entries = index.get((lk, selector[lk]), set())
                        if best is None or len(entries) < len(best):
                            best = entries
                if best is not None:
                    return [view[k] for k in list(best) if k in view]
        if namespace is not None:
            ns_map = (shard.cache_ns_index if use_cache else shard.ns_index).get(kind, {}).get(
                namespace
            )
            if ns_map is None:
                return []
            # a snapshot of the keys: callers may write while iterating
            return [view[k] for k in list(ns_map) if k in view]
        return list(view.values())

    # -- recovery and the remote apply ------------------------------------

    def restore_objects(
        self, objects, rv: int = 0, rv_vector: Optional[Sequence[int]] = None
    ) -> int:
        """The recovery path's bulk load: commit ``objects`` verbatim (uid,
        resourceVersion, generation, timestamps kept), emit no watch event
        (recovery precedes every subscriber; the boot resync covers
        delivery), rebuild the aggregates and caches, and resume the
        sequences: the scalar ``rv`` when unsharded, ``rv_vector`` (one
        watermark a shard) when sharded. Only on a store with no commit."""
        if any(s.rv for s in self._shards):
            raise GroveError(
                ERR_CONFLICT,
                "restore_objects requires a fresh store (writes already"
                f" committed up to rv {self.resource_version})",
                "restore",
            )
        if rv_vector is not None and len(rv_vector) != self.num_shards:
            raise GroveError(
                ERR_CONFLICT,
                f"rv_vector has {len(rv_vector)} entries for a"
                f" {self.num_shards}-shard store",
                "restore",
            )
        if rv_vector is None and not self._single:
            raise GroveError(
                ERR_CONFLICT,
                "sharded restore requires the per-shard rv_vector (the"
                " scalar watermark cannot be split back into sequences)",
                "restore",
            )
        n = 0
        for obj in objects:
            shard = self._shard_of_obj(obj)
            self._commit(shard, obj)
            # a shard's sequence never trails its restored objects
            shard.rv = max(shard.rv, obj.metadata.resource_version)
            n += 1
        if rv_vector is not None:
            for shard, shard_rv in zip(self._shards, rv_vector):
                shard.rv = max(shard.rv, int(shard_rv))
        else:
            self._shards[0].rv = max(self._shards[0].rv, int(rv))
        for shard in self._shards:
            shard.agg_committed.rebuild(shard.committed.get("Pod", {}).values())
        self._summary_dirty = set(range(self.num_shards))
        if self.cache_lag:
            # the initial LIST a restarted process serves its informers
            self.sync_cache()
        return n

    def apply_remote_event(self, etype: str, envelope: dict) -> WatchEvent:
        """Mirror-apply one wire-encoded commit of a peer control-plane
        process (the process drain): decode the WAL's envelope, restamp
        the object with this mirror's next rv of its shard, commit and
        emit through the normal fan-out. Per-object rv values are
        mirror-local (best-effort Events interleave on their shard); the
        counts agree: an ADDED or MODIFIED apply bumps its shard by one, a
        hard delete by zero. The informer cache is not advanced here (that
        is a round boundary); the caller holds the returned event."""
        from grove_tpu_torch.durability.wal import decode_envelope

        obj = decode_envelope(envelope)
        shard = self._shard_of_obj(obj)
        with shard.lock:
            key = obj_key(obj)
            old = shard.committed.get(obj.kind, {}).get(key)
            if etype == DELETED:
                if old is None:
                    raise GroveError(
                        ERR_CONFLICT,
                        f"remote delete of unknown {obj.kind} {key}:"
                        " mirror diverged from the committing process",
                        "apply-remote",
                    )
                blob = self._uncommit(shard, old)
                self._emit(DELETED, old, blob, shard=shard)
                return WatchEvent(type=DELETED, kind=old.kind, obj=old, blob=blob,
                                  old=None, shard=shard.index)
            shard.rv += 1
            obj.metadata.resource_version = shard.rv
            if old is not None:
                _index_delete(shard.label_index.get(old.kind, {}), old)
            blob = self._commit(shard, obj)
            self._emit(etype, obj, blob, old=old, shard=shard)
            return WatchEvent(type=etype, kind=obj.kind, obj=obj, blob=blob,
                              old=None, shard=shard.index)

    # -- commits ---------------------------------------------------------

    def _commit(
        self, shard: StoreShard, stored, blob: Optional[bytes] = None, serialize: bool = True
    ):
        """Commit ``stored`` as the owning shard's new immutable committed
        state (never mutated afterwards). With ``serialize=False``
        (copy-on-write commits) no blob is computed: mutable reads
        deep-copy instead."""
        if blob is None and serialize:
            blob = _dumps(stored)
        key = obj_key(stored)
        shard.committed.setdefault(stored.kind, {})[key] = stored
        if blob is not None:
            shard.blob.setdefault(stored.kind, {})[key] = blob
        else:
            shard.blob.get(stored.kind, {}).pop(key, None)
        _index_insert(shard.label_index.setdefault(stored.kind, {}), stored)
        shard.ns_index.setdefault(stored.kind, {}).setdefault(stored.metadata.namespace, {})[
            key
        ] = None
        return blob

    def _uncommit(self, shard: StoreShard, obj) -> Optional[bytes]:
        key = obj_key(obj)
        shard.committed.get(obj.kind, {}).pop(key, None)
        blob = shard.blob.get(obj.kind, {}).pop(key, None)
        _index_delete(shard.label_index.get(obj.kind, {}), obj)
        ns_map = shard.ns_index.get(obj.kind, {}).get(obj.metadata.namespace)
        if ns_map is not None:
            ns_map.pop(key, None)
            if not ns_map:
                shard.ns_index[obj.kind].pop(obj.metadata.namespace, None)
        return blob

    def verify_readonly_integrity(self) -> int:
        """Test-mode write barrier for the zero-copy read contract: every
        committed object must still match its canonical blob. A caller that
        mutated a read-only view fails here with the object named. Objects
        without a blob are counted in ``unverified_readonly``. Returns the
        number of objects verified."""
        checked = 0
        self.unverified_readonly = 0
        for shard in self._shards:
            checked += self._verify_shard_readonly(shard)
        return checked

    def _verify_shard_readonly(self, shard: StoreShard) -> int:
        checked = 0
        for kind, view in shard.committed.items():
            blobs = shard.blob.get(kind, {})
            for key, obj in view.items():
                blob = blobs.get(key)
                if blob is None:
                    self.unverified_readonly += 1
                    continue
                # pickle is not byte-idempotent for every graph: a byte
                # mismatch falls back to structural equality
                if _dumps(obj) != blob and pickle.loads(blob) != obj:
                    raise AssertionError(
                        f"readonly contract violated: committed {kind} {key} "
                        "no longer matches its canonical blob: some caller "
                        "mutated a scan()/get(readonly=True)/watch view in "
                        "place (deep_copy before building updates)"
                    )
                checked += 1
        return checked

    # -- reads -----------------------------------------------------------

    def _shard_blobs(self, shard: StoreShard, use_cache: bool, kind: str) -> Dict[str, bytes]:
        return (shard.cache_blob if use_cache else shard.blob).get(kind, {})

    def get(
        self,
        kind: str,
        namespace: str,
        name: str,
        cached: bool = False,
        readonly: bool = False,
    ):
        """One object, or None. ``readonly=True`` returns the committed
        object itself: the caller must not mutate it."""
        prof = PROFILER.phase(PHASE_SNAPSHOT) if PROFILER.enabled else None
        try:
            use_cache = cached and self.cache_lag
            shard = self._shard_for(namespace)
            key = f"{namespace}/{name}"
            obj = (shard.cache if use_cache else shard.committed).get(kind, {}).get(key)
            if obj is None:
                return None
            if readonly:
                return obj
            return _materialize(obj, self._shard_blobs(shard, use_cache, kind).get(key))
        finally:
            if prof is not None:
                prof.end()

    def _shards_for_read(self, namespace: Optional[str]):
        """The owner for a namespace-scoped read, every shard (in index
        order) otherwise."""
        if namespace is None:
            return self._shards
        return (self._shard_for(namespace),)

    def _scan_shard(
        self,
        shard: StoreShard,
        kind: str,
        namespace: Optional[str],
        label_selector: Optional[Dict[str, str]],
        use_cache: bool,
    ) -> Iterator[object]:
        """One shard's slice of a scan (shared by scan and list)."""
        view = (shard.cache if use_cache else shard.committed).get(kind, {})
        if not view:
            return
        for obj in self._shard_candidates(
            shard, kind, namespace, label_selector, use_cache, view
        ):
            if namespace is not None and obj.metadata.namespace != namespace:
                continue
            if matches_labels(obj, label_selector):
                yield obj

    def scan(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        cached: bool = False,
    ) -> Iterator[object]:
        """Read-only iteration over the matching objects (unsorted; callers
        must not mutate them). A namespace-scoped scan touches only the
        owning shard; otherwise the shards chain in index order."""
        use_cache = cached and self.cache_lag
        for shard in self._shards_for_read(namespace):
            yield from self._scan_shard(shard, kind, namespace, label_selector, use_cache)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        cached: bool = False,
    ) -> List[object]:
        """Private copies of the matching objects, sorted by (namespace,
        name) across shards."""
        prof = PROFILER.phase(PHASE_SNAPSHOT) if PROFILER.enabled else None
        try:
            use_cache = cached and self.cache_lag
            out = []
            for shard in self._shards_for_read(namespace):
                blobs = self._shard_blobs(shard, use_cache, kind)
                for obj in self._scan_shard(shard, kind, namespace, label_selector, use_cache):
                    out.append(_materialize(obj, blobs.get(obj_key(obj))))
            out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
            return out
        finally:
            if prof is not None:
                prof.end()

    # -- writes ----------------------------------------------------------

    def create(self, obj, consume: bool = False, share: bool = False) -> object:
        """Commit a new object. ``consume=True`` hands ``obj`` over: it
        becomes the committed object and the caller must not touch it again.
        ``share=True`` commits a spine copy sharing spec and status with
        ``obj`` (a memoized desired object reused read-only) and returns the
        committed object. Otherwise a private copy is committed and ``obj``
        gets the committed identity."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            self._authorize("create", obj)
            self._inject("create", obj)
            shard = self._shard_of_obj(obj)
            with shard.lock:
                return self._create_locked(shard, obj, consume, share)
        finally:
            if prof is not None:
                prof.end()

    def _create_locked(self, shard: StoreShard, obj, consume: bool, share: bool) -> object:
        key = obj_key(obj)
        if key in shard.committed.setdefault(obj.kind, {}):
            raise GroveError(ERR_CONFLICT, f"{obj.kind} {key} already exists", "create")
        if consume:
            meta = obj.metadata
            shard.rv += 1
            meta.uid = meta.uid or next_uid()
            meta.resource_version = shard.rv
            meta.generation = 1
            meta.creation_timestamp = self.clock.now()
            blob = _dumps(obj) if self._guard_blobs else None
            self._commit(shard, obj, blob, serialize=False)
            self._emit(ADDED, obj, blob, shard=shard)
            return obj
        if share:
            stored = _copy.copy(obj)
            meta = stored.metadata = _copy.copy(obj.metadata)
            shard.rv += 1
            meta.uid = next_uid()
            meta.resource_version = shard.rv
            meta.generation = 1
            meta.creation_timestamp = self.clock.now()
            blob = _dumps(stored) if self._guard_blobs else None
            self._commit(shard, stored, blob, serialize=False)
            self._emit(ADDED, stored, blob, shard=shard)
            return stored
        # serialize once with the final identity stamped: the same bytes are
        # the private committed copy and the canonical blob
        meta = obj.metadata
        saved = (meta.uid, meta.resource_version, meta.generation, meta.creation_timestamp)
        shard.rv += 1
        try:
            meta.uid = meta.uid or next_uid()
            meta.resource_version = shard.rv
            meta.generation = 1
            meta.creation_timestamp = self.clock.now()
            blob = _dumps(obj)
            stored = pickle.loads(blob) if blob is not None else deep_copy(obj)
        finally:
            meta.uid, meta.resource_version, meta.generation, meta.creation_timestamp = saved
        self._commit(shard, stored, blob)
        self._emit(ADDED, stored, blob, shard=shard)
        sm = stored.metadata
        meta.uid = sm.uid
        meta.resource_version = sm.resource_version
        meta.generation = sm.generation
        meta.creation_timestamp = sm.creation_timestamp
        return obj

    def update(self, obj, bump_generation: bool = True) -> object:
        """Write a caller-owned object. A resourceVersion behind the
        committed one raises ERR_CONFLICT; a write structurally equal to the
        committed object commits nothing."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            shard = self._shard_of_obj(obj)
            with shard.lock:
                return self._update_locked(shard, obj, bump_generation)
        finally:
            if prof is not None:
                prof.end()

    def _update_locked(self, shard: StoreShard, obj, bump_generation: bool) -> object:
        key = obj_key(obj)
        current = shard.committed.get(obj.kind, {}).get(key)
        if current is None:
            raise GroveError(ERR_NOT_FOUND, f"{obj.kind} {key} not found", "update")
        self._authorize("update", current)
        self._inject("update", obj)
        meta = obj.metadata
        cm = current.metadata
        if meta.resource_version and meta.resource_version != cm.resource_version:
            raise GroveError(
                ERR_CONFLICT,
                f"{obj.kind} {key}: resourceVersion {meta.resource_version} != {cm.resource_version}",
                "update",
            )
        saved = (meta.resource_version, meta.generation, meta.uid, meta.creation_timestamp)
        try:
            meta.resource_version = cm.resource_version
            meta.generation = cm.generation
            meta.uid = cm.uid
            meta.creation_timestamp = cm.creation_timestamp
            if obj == current:
                committed = current
                stored = None
            else:
                meta.resource_version = shard.rv + 1
                meta.generation = cm.generation + (1 if bump_generation else 0)
                blob = _dumps(obj)
                stored = pickle.loads(blob) if blob is not None else deep_copy(obj)
                committed = stored
        finally:
            meta.resource_version, meta.generation, meta.uid, meta.creation_timestamp = saved
        if stored is not None:
            shard.rv += 1
            _index_delete(shard.label_index.get(current.kind, {}), current)
            self._commit(shard, stored, blob)
            self._emit(MODIFIED, stored, blob, old=current, shard=shard)
        # the caller's object carries the committed identity
        meta.resource_version = committed.metadata.resource_version
        meta.generation = committed.metadata.generation
        meta.uid = committed.metadata.uid
        meta.creation_timestamp = committed.metadata.creation_timestamp
        return obj

    def update_status(self, obj) -> object:
        """Status write: no generation bump."""
        return self.update(obj, bump_generation=False)

    def commit_cow(
        self,
        view,
        *,
        status=_UNSET,
        spec=_UNSET,
        metadata=_UNSET,
        bump_generation: bool = False,
    ) -> object:
        """Copy-on-write commit against a readonly ``view``: the new
        committed object shares every untouched field with the previous one
        and takes the caller's private replacement(s). Conflicts, no-op
        suppression, authorization and fault injection as ``update``.
        Returns the new committed (read-only) object."""
        prof = None
        if PROFILER.enabled:
            only_status = status is not _UNSET and spec is _UNSET and metadata is _UNSET
            prof = PROFILER.phase(PHASE_STATUS_WRITE if only_status else PHASE_STORE_COMMIT)
        try:
            shard = self._shard_of_obj(view)
            with shard.lock:
                return self._commit_cow_locked(
                    shard, view, status, spec, metadata, bump_generation
                )
        finally:
            if prof is not None:
                prof.end()

    def _commit_cow_locked(
        self, shard: StoreShard, view, status, spec, metadata, bump_generation: bool
    ) -> object:
        key = obj_key(view)
        current = shard.committed.get(view.kind, {}).get(key)
        if current is None:
            raise GroveError(ERR_NOT_FOUND, f"{view.kind} {key} not found", "update")
        if (
            current is not view
            and view.metadata.resource_version
            and view.metadata.resource_version != current.metadata.resource_version
        ):
            raise GroveError(
                ERR_CONFLICT,
                f"{view.kind} {key}: resourceVersion"
                f" {view.metadata.resource_version} != {current.metadata.resource_version}",
                "update",
            )
        self._authorize("update", current)
        stored = _copy.copy(current)
        changed = False
        if status is not _UNSET:
            stored.status = status
            changed = changed or status != current.status
        if spec is not _UNSET:
            stored.spec = spec
            changed = changed or spec != current.spec
        if metadata is not _UNSET:
            stored.metadata = metadata
            changed = changed or metadata != current.metadata
        self._inject("update", stored)
        if not changed:
            return current
        meta = stored.metadata = _copy.copy(stored.metadata)
        shard.rv += 1
        meta.resource_version = shard.rv
        if bump_generation:
            meta.generation = current.metadata.generation + 1
        blob = _dumps(stored) if self._guard_blobs else None
        _index_delete(shard.label_index.get(current.kind, {}), current)
        self._commit(shard, stored, blob, serialize=False)
        self._emit(MODIFIED, stored, blob, old=current, shard=shard)
        return stored

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Delete an object; one with finalizers gets its deletion
        timestamp instead and stays until they drain."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            shard = self._shard_for(namespace)
            with shard.lock:
                self._delete_locked(shard, kind, namespace, name)
        finally:
            if prof is not None:
                prof.end()

    def _delete_locked(self, shard: StoreShard, kind: str, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        obj = shard.committed.get(kind, {}).get(key)
        if obj is None:
            raise GroveError(ERR_NOT_FOUND, f"{kind} {key} not found", "delete")
        self._authorize("delete", obj)
        self._inject("delete", obj)
        if obj.metadata.finalizers:
            if obj.metadata.deletion_timestamp is None:
                stored = _materialize(obj, shard.blob.get(kind, {}).get(key))
                stored.metadata.deletion_timestamp = self.clock.now()
                shard.rv += 1
                stored.metadata.resource_version = shard.rv
                _index_delete(shard.label_index.get(kind, {}), obj)
                blob = self._commit(shard, stored)
                self._emit(MODIFIED, stored, blob, old=obj, shard=shard)
            return
        blob = self._uncommit(shard, obj)
        self._emit(DELETED, obj, blob, shard=shard)

    def remove_finalizer(self, kind: str, namespace: str, name: str, finalizer: str) -> None:
        shard = self._shard_for(namespace)
        with shard.lock:
            key = f"{namespace}/{name}"
            obj = shard.committed.get(kind, {}).get(key)
            if obj is None:
                return
            self._authorize("update", obj)
            self._inject("update", obj)
            if finalizer in obj.metadata.finalizers:
                stored = _materialize(obj, shard.blob.get(kind, {}).get(key))
                stored.metadata.finalizers.remove(finalizer)
                shard.rv += 1
                stored.metadata.resource_version = shard.rv
                _index_delete(shard.label_index.get(kind, {}), obj)
                blob = self._commit(shard, stored)
                self._emit(MODIFIED, stored, blob, old=obj, shard=shard)
            self.complete_deletion_if_drained(kind, namespace, name)

    def complete_deletion_if_drained(self, kind: str, namespace: str, name: str) -> bool:
        """Finish a finalizer-gated deletion once the finalizers have
        drained (the apiserver deletes an object whose deletionTimestamp is
        set and whose finalizer list became empty)."""
        shard = self._shard_for(namespace)
        with shard.lock:  # reentrant from remove_finalizer
            obj = shard.committed.get(kind, {}).get(f"{namespace}/{name}")
            if (
                obj is not None
                and obj.metadata.deletion_timestamp is not None
                and not obj.metadata.finalizers
            ):
                blob = self._uncommit(shard, obj)
                self._emit(DELETED, obj, blob, shard=shard)
                return True
            return False

    def delete_collection(
        self,
        kind: str,
        namespace: str,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> int:
        """DeleteAllOf (gang termination)."""
        victims = self.list(kind, namespace, label_selector)
        for v in victims:
            self.delete(kind, namespace, v.metadata.name)
        return len(victims)
