"""In-memory object store: the port's stand-in for the apiserver.

Counterpart of ``grove_tpu/runtime/store.py`` with one shard and no read
cache, cut to what the scheduler round and the loading of a world use:

- ``create``, ``get`` (``readonly`` returns the committed object itself),
  ``scan`` and ``list`` with a label selector, ``update`` /
  ``update_status`` with resourceVersion conflicts (``GroveError`` with
  ``ERR_CONFLICT``) and no-op suppression, ``commit_cow`` (the
  copy-on-write status commit behind ``commit_status``), ``delete`` (a
  finalizer defers it);
- watch events fanned out to ``subscribe_system`` subscribers at commit;
- the label index: a selector on an indexed label resolves to its
  candidate set instead of a scan of the kind (the scheduler looks up each
  clique's pods by ``grove.io/podclique``);
- ``shard_index`` / ``shard_emitted`` / ``resource_version_vector``: the
  one-shard answers;
- ``pod_counters`` / ``pod_summary``: per-PodClique pod counters and the
  cluster's (total, ready) live pods, folded at commit from each pod delta
  (``runtime/aggregate.py``); over one shard the JAX store's level-2
  summary tree is its one leaf;
- the glass-box hooks, one boolean check each while off: every commit goes
  to the flight recorder's digest ring (``FLIGHTREC.note_commit``), PodGang
  creations and deletions stamp their journeys (``JOURNEYS.note_created`` /
  ``note_deleted``), and reads and writes open the wall profiler's
  ``snapshot``, ``store-commit`` and ``status-write`` phases.

Committed objects are immutable: every write commits a new object.
"""

from __future__ import annotations

import copy as _copy
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
from grove_tpu_torch.runtime.aggregate import PodAggregate, PodCounters
from grove_tpu_torch.runtime.clock import Clock
from grove_tpu_torch.runtime.errors import ERR_CONFLICT, ERR_NOT_FOUND, GroveError

ADDED = "Added"
MODIFIED = "Modified"
DELETED = "Deleted"

# label keys with an inverted index (the hot selectors)
INDEXED_LABELS = (
    "grove.io/podclique",
    "grove.io/podgang",
    "grove.io/podcliquescalinggroup",
    "app.kubernetes.io/part-of",
)


@dataclass
class WatchEvent:
    type: str
    kind: str
    obj: object  # the committed object: read-only
    old: Optional[object] = field(default=None, repr=False, compare=False)
    shard: int = 0  # the owning keyspace shard: one shard here


def obj_key(obj) -> str:
    return f"{obj.metadata.namespace}/{obj.metadata.name}"


def commit_status(store, view, status):
    """Status write against a readonly ``view`` through the store's
    copy-on-write commit. Returns the committed object."""
    return store.commit_cow(view, status=status)


def matches_labels(obj, selector: Optional[Dict[str, str]]) -> bool:
    if not selector:
        return True
    labels = obj.metadata.labels or {}
    for k, v in selector.items():
        if labels.get(k) != v:
            return False
    return True


class Store:
    def __init__(self, clock: Optional[Clock] = None) -> None:
        self.clock = clock or Clock()
        self.rv = 0
        self.emitted = 0
        # kind -> key -> committed object (insertion-ordered)
        self._committed: Dict[str, Dict[str, object]] = {}
        # kind -> namespace -> keys (a dict as an ordered set)
        self._ns_index: Dict[str, Dict[str, Dict[str, None]]] = {}
        # kind -> (label key, value) -> keys
        self._label_index: Dict[str, Dict[tuple, Dict[str, None]]] = {}
        self._system_watchers: List[Callable[[WatchEvent], None]] = []
        # pod-status counters folded from every committed pod delta
        self._agg = PodAggregate()

    # -- one shard -------------------------------------------------------

    def shard_index(self, namespace: str) -> int:
        return 0

    def shard_emitted(self, index: int) -> int:
        """Events emitted so far (moves on every commit and delete)."""
        return self.emitted

    @property
    def resource_version(self) -> int:
        """The store's resourceVersion watermark: the count of commits."""
        return self.rv

    def resource_version_vector(self) -> Tuple[int, ...]:
        """Per-shard resourceVersions (one shard here)."""
        return (self.rv,)

    # -- watch -----------------------------------------------------------

    def subscribe_system(self, fn: Callable[[WatchEvent], None]) -> None:
        self._system_watchers.append(fn)

    def _emit(self, type_: str, obj, old=None) -> None:
        ev = WatchEvent(type=type_, kind=obj.kind, obj=obj, old=old)
        self.emitted += 1
        # fold the delta into the pod aggregate (kind-gated inside; `old`
        # is the previous committed object)
        self._agg.apply(type_, obj, old)
        if FLIGHTREC.enabled:
            FLIGHTREC.note_commit(ev)
        if JOURNEYS.enabled and obj.kind == "PodGang":
            if type_ == ADDED:
                JOURNEYS.note_created(obj.metadata.namespace, obj.metadata.name)
            elif type_ == DELETED:
                JOURNEYS.note_deleted(obj.metadata.namespace, obj.metadata.name)
        for w in self._system_watchers:
            w(ev)

    # -- pod aggregates --------------------------------------------------

    def pod_counters(self, namespace: str, name: str) -> PodCounters:
        """Aggregated pod-status counters of one PodClique, equal to a full
        rescan of its pods. The row is read-only."""
        return self._agg.counters(namespace, name)

    def pod_summary(self) -> Tuple[int, int]:
        """Cluster-wide (total, ready) over live (non-terminating) pods.
        The JAX store folds its shards' partials up a fan-in-8 tree; one
        shard is a tree of depth 1 whose root is that shard's partial."""
        METRICS.set("aggregate_fold_depth", 1)
        return self._agg.grand_total, self._agg.grand_ready

    # -- indices ---------------------------------------------------------

    def _commit(self, stored) -> None:
        key = obj_key(stored)
        self._committed.setdefault(stored.kind, {})[key] = stored
        index = self._label_index.setdefault(stored.kind, {})
        for lk in INDEXED_LABELS:
            lv = stored.metadata.labels.get(lk)
            if lv is not None:
                index.setdefault((lk, lv), {})[key] = None
        self._ns_index.setdefault(stored.kind, {}).setdefault(
            stored.metadata.namespace, {}
        )[key] = None

    def _unindex_labels(self, obj) -> None:
        index = self._label_index.get(obj.kind, {})
        key = obj_key(obj)
        for lk in INDEXED_LABELS:
            lv = obj.metadata.labels.get(lk)
            if lv is not None:
                entries = index.get((lk, lv))
                if entries is not None:
                    entries.pop(key, None)

    def _uncommit(self, obj) -> None:
        key = obj_key(obj)
        self._committed.get(obj.kind, {}).pop(key, None)
        self._unindex_labels(obj)
        ns_map = self._ns_index.get(obj.kind, {}).get(obj.metadata.namespace)
        if ns_map is not None:
            ns_map.pop(key, None)
            if not ns_map:
                self._ns_index[obj.kind].pop(obj.metadata.namespace, None)

    def _candidates(self, kind, namespace, selector, view) -> List[object]:
        """Smallest indexed candidate set: an indexed label of the selector,
        else the namespace's keys, else every object of the kind."""
        if selector:
            index = self._label_index.get(kind)
            if index is not None:
                best = None
                for lk in INDEXED_LABELS:
                    if lk in selector:
                        entries = index.get((lk, selector[lk]), {})
                        if best is None or len(entries) < len(best):
                            best = entries
                if best is not None:
                    return [view[k] for k in list(best) if k in view]
        if namespace is not None:
            ns_map = self._ns_index.get(kind, {}).get(namespace)
            if ns_map is None:
                return []
            return [view[k] for k in list(ns_map) if k in view]
        return list(view.values())

    # -- reads -----------------------------------------------------------

    def get(self, kind: str, namespace: str, name: str, readonly: bool = False):
        """One object, or None. ``readonly=True`` returns the committed
        object itself: the caller must not mutate it."""
        prof = PROFILER.phase(PHASE_SNAPSHOT) if PROFILER.enabled else None
        try:
            obj = self._committed.get(kind, {}).get(f"{namespace}/{name}")
            if obj is None or readonly:
                return obj
            return deep_copy(obj)
        finally:
            if prof is not None:
                prof.end()

    def scan(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Iterator[object]:
        """Read-only iteration over the matching committed objects
        (unsorted; callers must not mutate them)."""
        view = self._committed.get(kind, {})
        if not view:
            return
        for obj in self._candidates(kind, namespace, label_selector, view):
            if namespace is not None and obj.metadata.namespace != namespace:
                continue
            if matches_labels(obj, label_selector):
                yield obj

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[object]:
        """Private copies of the matching objects, sorted by (namespace,
        name)."""
        prof = PROFILER.phase(PHASE_SNAPSHOT) if PROFILER.enabled else None
        try:
            out = [deep_copy(o) for o in self.scan(kind, namespace, label_selector)]
            out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
            return out
        finally:
            if prof is not None:
                prof.end()

    # -- writes ----------------------------------------------------------

    def create(self, obj, consume: bool = False) -> object:
        """Commit a new object. ``consume=True`` hands ``obj`` over: it
        becomes the committed object and the caller must not touch it
        again; otherwise a private copy is committed."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            kind_objs = self._committed.setdefault(obj.kind, {})
            key = obj_key(obj)
            if key in kind_objs:
                raise GroveError(ERR_CONFLICT, f"{obj.kind} {key} already exists", "create")
            stored = obj if consume else deep_copy(obj)
            meta = stored.metadata
            self.rv += 1
            meta.uid = meta.uid or next_uid()
            meta.resource_version = self.rv
            meta.generation = 1
            meta.creation_timestamp = self.clock.now()
            self._commit(stored)
            self._emit(ADDED, stored)
            if not consume:
                obj.metadata.uid = meta.uid
                obj.metadata.resource_version = meta.resource_version
                obj.metadata.generation = meta.generation
                obj.metadata.creation_timestamp = meta.creation_timestamp
            return obj
        finally:
            if prof is not None:
                prof.end()

    def _current(self, obj):
        current = self._committed.get(obj.kind, {}).get(obj_key(obj))
        if current is None:
            raise GroveError(ERR_NOT_FOUND, f"{obj.kind} {obj_key(obj)} not found", "update")
        return current

    def update(self, obj, bump_generation: bool = True) -> object:
        """Write a caller-owned object. A resourceVersion behind the
        committed one raises ERR_CONFLICT; a write equal to the committed
        object commits nothing."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            current = self._current(obj)
            meta = obj.metadata
            if meta.resource_version and meta.resource_version != current.metadata.resource_version:
                raise GroveError(
                    ERR_CONFLICT,
                    f"{obj.kind} {obj_key(obj)}: resourceVersion {meta.resource_version}"
                    f" != {current.metadata.resource_version}",
                    "update",
                )
            cm = current.metadata
            meta.resource_version = cm.resource_version
            meta.generation = cm.generation
            meta.uid = cm.uid
            meta.creation_timestamp = cm.creation_timestamp
            if obj == current:
                return obj
            stored = deep_copy(obj)
            self.rv += 1
            stored.metadata.resource_version = self.rv
            stored.metadata.generation = cm.generation + (1 if bump_generation else 0)
            self._unindex_labels(current)
            self._commit(stored)
            self._emit(MODIFIED, stored, old=current)
            meta.resource_version = stored.metadata.resource_version
            meta.generation = stored.metadata.generation
            return obj
        finally:
            if prof is not None:
                prof.end()

    def update_status(self, obj) -> object:
        """Status write: no generation bump."""
        return self.update(obj, bump_generation=False)

    def commit_cow(self, view, *, status):
        """Copy-on-write status commit against a readonly ``view``: the new
        committed object shares everything but its status. Conflicts and
        no-op suppression as ``update``. Returns the committed object."""
        prof = PROFILER.phase(PHASE_STATUS_WRITE) if PROFILER.enabled else None
        try:
            current = self._current(view)
            if (
                current is not view
                and view.metadata.resource_version
                and view.metadata.resource_version != current.metadata.resource_version
            ):
                raise GroveError(
                    ERR_CONFLICT,
                    f"{view.kind} {obj_key(view)}: resourceVersion"
                    f" {view.metadata.resource_version} != {current.metadata.resource_version}",
                    "update",
                )
            if status == current.status:
                return current
            stored = _copy.copy(current)
            stored.status = status
            meta = stored.metadata = _copy.copy(stored.metadata)
            self.rv += 1
            meta.resource_version = self.rv
            self._unindex_labels(current)
            self._commit(stored)
            self._emit(MODIFIED, stored, old=current)
            return stored
        finally:
            if prof is not None:
                prof.end()

    def delete(self, kind: str, namespace: str, name: str) -> None:
        """Delete an object; one with finalizers gets its deletion
        timestamp instead and stays until they drain."""
        prof = PROFILER.phase(PHASE_STORE_COMMIT) if PROFILER.enabled else None
        try:
            obj = self._committed.get(kind, {}).get(f"{namespace}/{name}")
            if obj is None:
                raise GroveError(ERR_NOT_FOUND, f"{kind} {namespace}/{name} not found", "delete")
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    stored = deep_copy(obj)
                    stored.metadata.deletion_timestamp = self.clock.now()
                    self.rv += 1
                    stored.metadata.resource_version = self.rv
                    self._unindex_labels(obj)
                    self._commit(stored)
                    self._emit(MODIFIED, stored, old=obj)
                return
            self._uncommit(obj)
            self._emit(DELETED, obj)
        finally:
            if prof is not None:
                prof.end()
