"""In-memory object store: the port's stand-in for the apiserver.

Counterpart of ``grove_tpu/runtime/store.py`` over one keyspace shard (the
store's sharding is not ported; ``num_shards`` is 1). The semantics the
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
  profiler's ``snapshot``, ``store-commit`` and ``status-write`` phases.
"""

from __future__ import annotations

import copy as _copy
import pickle
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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
from grove_tpu_torch.runtime.shards import ShardSummaryTree, StoreShard
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
    shard: int = field(default=0, repr=False, compare=False)  # one shard here

    def materialize(self):
        """Private deep copy of the event payload."""
        return _materialize(self.obj, self.blob)


def obj_key(obj) -> str:
    return f"{obj.metadata.namespace}/{obj.metadata.name}"


def commit_status(store, view, status):
    """Status write against a readonly ``view`` through the store's
    copy-on-write commit. Returns the committed object."""
    return store.commit_cow(view, status=status)


def commit_finalizer_add(store, view, finalizer: str):
    """Finalizer add (a metadata write, no generation bump) against a
    readonly ``view``. Returns the committed object."""
    meta = _copy.copy(view.metadata)
    meta.finalizers = list(view.metadata.finalizers)
    meta.finalizers.append(finalizer)
    return store.commit_cow(view, metadata=meta)


def commit_spec(store, view, spec):
    """Spec write (no generation bump) against a readonly ``view``."""
    return store.commit_cow(view, spec=spec)


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
    num_shards = 1

    def __init__(self, clock: Optional[Clock] = None, cache_lag: bool = False) -> None:
        self.clock = clock or Clock()
        self.cache_lag = cache_lag
        self._shard = StoreShard(0, cache_lag)
        # the cluster's (total, ready) fold: a tree of one leaf per view
        self._summary_tree = ShardSummaryTree(1)
        self._summary_tree_cached = ShardSummaryTree(1) if cache_lag else self._summary_tree
        self._watchers: List[Callable[[WatchEvent], None]] = []
        self._system_watchers: List[Callable[[WatchEvent], None]] = []
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

    # -- one shard -------------------------------------------------------

    def shard_index(self, namespace: str) -> int:
        return 0

    def shard_emitted(self, index: int) -> int:
        """Events emitted so far (moves on every commit and delete)."""
        return self._shard.emitted

    @property
    def resource_version(self) -> int:
        """The store's resourceVersion watermark: the count of commits."""
        return self._shard.rv

    @property
    def rv(self) -> int:
        """The shard's resourceVersion sequence (settable: a store built
        from another store's documents carries its watermark over)."""
        return self._shard.rv

    @rv.setter
    def rv(self, value: int) -> None:
        self._shard.rv = value

    def resource_version_vector(self) -> Tuple[int, ...]:
        """Per-shard resourceVersions (one shard here)."""
        return (self._shard.rv,)

    def kinds(self) -> List[str]:
        """Kinds with at least one committed object."""
        return sorted(k for k, v in self._shard.committed.items() if v)

    # -- watch -----------------------------------------------------------

    def subscribe(self, fn: Callable[[WatchEvent], None]) -> None:
        """Operator-side watch (the engine)."""
        self._watchers.append(fn)

    def subscribe_system(self, fn: Callable[[WatchEvent], None]) -> None:
        """Cluster-side watch (sim kubelet, scheduler folds): delivered
        before the operator's watchers."""
        self._system_watchers.append(fn)

    def _emit(self, type_: str, obj, blob: Optional[bytes], old=None) -> None:
        shard = self._shard
        ev = WatchEvent(type=type_, kind=obj.kind, obj=obj, blob=blob, old=old)
        shard.emitted += 1
        # fold the delta into the committed view's pod aggregate (kind-gated
        # inside; `old` is the previous committed object)
        shard.agg_committed.apply(type_, obj, old)
        if FLIGHTREC.enabled:
            FLIGHTREC.note_commit(ev)
        if JOURNEYS.enabled and obj.kind == "PodGang":
            if type_ == ADDED:
                JOURNEYS.note_created(obj.metadata.namespace, obj.metadata.name)
            elif type_ == DELETED:
                JOURNEYS.note_deleted(obj.metadata.namespace, obj.metadata.name)
        for w in self._system_watchers:
            w(ev)
        for w in self._watchers:
            w(ev)

    # -- cache -----------------------------------------------------------

    def sync_cache(self) -> None:
        """Advance the whole read cache to the committed state."""
        for kind in list(self._shard.committed):
            self.sync_cache_kind(kind)

    def sync_cache_kind(self, kind: str) -> None:
        """Advance one kind's cache (that kind's informer resyncing).
        Committed objects are immutable, so the cache shares them."""
        shard = self._shard
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

    def apply_event_to_cache(self, ev: WatchEvent) -> None:
        """Apply one delivered watch event to the read cache (the informer's
        incremental update)."""
        shard = self._shard
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
        lagged cache with ``cached=True``). The row is read-only."""
        shard = self._shard
        agg = shard.agg_cached if (cached and self.cache_lag) else shard.agg_committed
        return agg.counters(namespace, name)

    def pod_summary(self, cached: bool = False) -> Tuple[int, int]:
        """Cluster-wide (total, ready) over live (non-terminating) pods.
        The JAX store folds its shards' partials up a fan-in-8 tree; one
        shard is a tree of depth 1 whose root is that shard's partial."""
        use_cache = cached and self.cache_lag
        tree = self._summary_tree_cached if use_cache else self._summary_tree
        agg = self._shard.agg_cached if use_cache else self._shard.agg_committed
        tree.update_leaf(0, (agg.grand_total, agg.grand_ready))
        METRICS.set("aggregate_fold_depth", tree.depth)
        return tree.root()

    # -- indices ---------------------------------------------------------

    def _candidates(self, kind, namespace, selector, use_cache, view) -> List[object]:
        """Smallest indexed candidate set: an indexed label of the selector,
        else the namespace's keys, else every object of the kind."""
        shard = self._shard
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

    # -- commits ---------------------------------------------------------

    def _commit(self, stored, blob: Optional[bytes] = None, serialize: bool = True):
        """Commit ``stored`` as the new immutable committed state (never
        mutated afterwards). With ``serialize=False`` (copy-on-write
        commits) no blob is computed: mutable reads deep-copy instead."""
        shard = self._shard
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

    def _uncommit(self, obj) -> Optional[bytes]:
        shard = self._shard
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
        shard = self._shard
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
            shard = self._shard
            key = f"{namespace}/{name}"
            obj = (shard.cache if use_cache else shard.committed).get(kind, {}).get(key)
            if obj is None:
                return None
            if readonly:
                return obj
            return _materialize(obj, (shard.cache_blob if use_cache else shard.blob).get(kind, {}).get(key))
        finally:
            if prof is not None:
                prof.end()

    def scan(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        cached: bool = False,
    ) -> Iterator[object]:
        """Read-only iteration over the matching objects (unsorted; callers
        must not mutate them)."""
        use_cache = cached and self.cache_lag
        view = (self._shard.cache if use_cache else self._shard.committed).get(kind, {})
        if not view:
            return
        for obj in self._candidates(kind, namespace, label_selector, use_cache, view):
            if namespace is not None and obj.metadata.namespace != namespace:
                continue
            if matches_labels(obj, label_selector):
                yield obj

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
        cached: bool = False,
    ) -> List[object]:
        """Private copies of the matching objects, sorted by (namespace,
        name)."""
        prof = PROFILER.phase(PHASE_SNAPSHOT) if PROFILER.enabled else None
        try:
            use_cache = cached and self.cache_lag
            blobs = (self._shard.cache_blob if use_cache else self._shard.blob).get(kind, {})
            out = [
                _materialize(obj, blobs.get(obj_key(obj)))
                for obj in self.scan(kind, namespace, label_selector, cached)
            ]
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
            return self._create(obj, consume, share)
        finally:
            if prof is not None:
                prof.end()

    def _create(self, obj, consume: bool, share: bool) -> object:
        shard = self._shard
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
            self._commit(obj, blob, serialize=False)
            self._emit(ADDED, obj, blob)
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
            self._commit(stored, blob, serialize=False)
            self._emit(ADDED, stored, blob)
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
        self._commit(stored, blob)
        self._emit(ADDED, stored, blob)
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
            return self._update(obj, bump_generation)
        finally:
            if prof is not None:
                prof.end()

    def _update(self, obj, bump_generation: bool) -> object:
        shard = self._shard
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
            self._commit(stored, blob)
            self._emit(MODIFIED, stored, blob, old=current)
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
            return self._commit_cow(view, status, spec, metadata, bump_generation)
        finally:
            if prof is not None:
                prof.end()

    def _commit_cow(self, view, status, spec, metadata, bump_generation: bool) -> object:
        shard = self._shard
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
        self._commit(stored, blob, serialize=False)
        self._emit(MODIFIED, stored, blob, old=current)
        return stored

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Delete an object; one with finalizers gets its deletion
        timestamp instead and stays until they drain."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            shard = self._shard
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
                    blob = self._commit(stored)
                    self._emit(MODIFIED, stored, blob, old=obj)
                return
            blob = self._uncommit(obj)
            self._emit(DELETED, obj, blob)
        finally:
            if prof is not None:
                prof.end()

    def remove_finalizer(self, kind: str, namespace: str, name: str, finalizer: str) -> None:
        shard = self._shard
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
            blob = self._commit(stored)
            self._emit(MODIFIED, stored, blob, old=obj)
        self.complete_deletion_if_drained(kind, namespace, name)

    def complete_deletion_if_drained(self, kind: str, namespace: str, name: str) -> bool:
        """Finish a finalizer-gated deletion once the finalizers have
        drained (the apiserver deletes an object whose deletionTimestamp is
        set and whose finalizer list became empty)."""
        obj = self._shard.committed.get(kind, {}).get(f"{namespace}/{name}")
        if (
            obj is not None
            and obj.metadata.deletion_timestamp is not None
            and not obj.metadata.finalizers
        ):
            blob = self._uncommit(obj)
            self._emit(DELETED, obj, blob)
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
