"""Keyspace sharding: the shard map and the per-shard state types.

Counterpart of ``grove_tpu/runtime/shards.py``. ``shard_of(namespace, S)``
hashes a namespace onto one of ``S`` shards (crc32, identical across
processes and replays; cluster-scoped keys, namespace "", pin to shard 0;
S=1 is the unsharded store). The work queue buckets its ready keys by it.
``StoreShard`` is one shard's private state (objects, indices, its own
resourceVersion sequence and lock, its pod aggregate) and
``ShardSummaryTree`` the fixed-fan-in fold of per-shard (total, ready) pod
partials; ``runtime/store.Store(num_shards=S)`` routes over them.
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Tuple

from grove_tpu_torch.runtime.aggregate import PodAggregate

# default fan-in of the level-2 summary fold tree: 8 keeps the tree two
# levels deep up to 64 shards (depth = ceil(log8 S) + 1 leaf level)
FOLD_FAN_IN = 8


def shard_of(namespace: str, num_shards: int) -> int:
    """Owning shard of a namespace. Deterministic across processes and
    replays (crc32, never hash()); cluster-scoped keys ("" namespace)
    pin to shard 0; S=1 degenerates to the unsharded store."""
    if num_shards <= 1 or not namespace:
        return 0
    return zlib.crc32(namespace.encode("utf-8")) % num_shards


class StoreShard:
    """One keyspace shard's private state. The Store routes every
    namespaced operation to exactly one shard; cross-shard reads merge
    (documented in docs/control-plane.md). Nothing outside the owning
    modules may touch these fields."""

    __slots__ = (
        "index",
        "lock",
        "rv",
        "emitted",
        "committed",
        "cache",
        "blob",
        "cache_blob",
        "label_index",
        "cache_label_index",
        "ns_index",
        "cache_ns_index",
        "system_watchers",
        "agg_committed",
        "agg_cached",
    )

    def __init__(self, index: int, cache_lag: bool) -> None:
        self.index = index
        # per-shard write lock: threaded real-cluster consumers (the
        # background WAL committer's snapshot scan, concurrent apiserver
        # writers) serialize per shard instead of stopping the world.
        # Single-threaded sims never contend — an uncontended RLock
        # acquire is the only cost on the write path.
        self.lock = threading.RLock()
        # this shard's OWN resourceVersion sequence (the merge rule is
        # documented in the module docstring / docs/control-plane.md)
        self.rv = 0
        # count of EVERY event emitted on this shard — unlike rv it moves
        # on hard deletes too, so it is the staleness signal speculative
        # consumers (the scheduler's overlap pump) key their reuse on
        self.emitted = 0
        # kind -> "ns/name" -> obj (plus the canonical pickled blobs and
        # the lagged informer-cache twins), exactly the unsharded store's
        # layout scoped to this shard's namespaces
        self.committed: Dict[str, Dict[str, object]] = {}
        self.cache: Dict[str, Dict[str, object]] = {}
        self.blob: Dict[str, Dict[str, bytes]] = {}
        self.cache_blob: Dict[str, Dict[str, bytes]] = {}
        # kind -> (label_key, label_value) -> set of object keys
        self.label_index: Dict[str, Dict[tuple, set]] = {}
        self.cache_label_index: Dict[str, Dict[tuple, set]] = {}
        # kind -> namespace -> {key: None} (dict-as-ordered-set so a
        # namespace-scoped scan yields the EXACT order the flat full-map
        # filter used to: updates replace in place, never re-append)
        self.ns_index: Dict[str, Dict[str, Dict[str, None]]] = {}
        self.cache_ns_index: Dict[str, Dict[str, Dict[str, None]]] = {}
        # per-shard system watch fan-out: consumers that subscribe to ONE
        # shard (per-shard WAL streams) never see — and never head-of-
        # line-block on — another shard's traffic. (The engine keeps its
        # OWN per-shard backlogs, fed from the operator watch channel and
        # routed on WatchEvent.shard — push stays the only delivery mode.)
        self.system_watchers: List[Callable] = []
        # level-1 incremental pod aggregates, one per read view — the
        # same exactness contract as the unsharded PodAggregate, scoped
        # to this shard's namespaces
        self.agg_committed = PodAggregate()
        self.agg_cached = PodAggregate() if cache_lag else self.agg_committed

    # -- census (observability / bench) ---------------------------------

    def object_count(self) -> int:
        return sum(len(v) for v in self.committed.values())


class ShardSummaryTree:
    """Level-2 hierarchical fold over per-shard pod partials.

    Level 1 (the per-shard ``PodAggregate``) folds each watch delta into
    per-(namespace, clique) rows AND into the shard's (total, ready)
    partial — O(1) per event: commits never touch this tree. A
    ``pod_summary()`` read calls ``refold`` with the S fresh leaf
    partials and folds them upward with fan-in ``FOLD_FAN_IN`` — O(S)
    work over the partials, never a scan of the pod population, and no
    fold at any level sees more than ``fan_in`` rows.
    ``fold_depth_histogram`` reports nodes per level — the bench's proof
    the fold is a tree, not a flat O(pods) rescan."""

    __slots__ = ("num_shards", "fan_in", "levels")

    def __init__(self, num_shards: int, fan_in: int = FOLD_FAN_IN) -> None:
        self.num_shards = max(1, num_shards)
        self.fan_in = max(2, fan_in)
        # levels[0] = per-shard leaves, levels[-1] = single root
        self.levels: List[List[Tuple[int, int]]] = []
        width = self.num_shards
        while True:
            self.levels.append([(0, 0)] * width)
            if width == 1:
                break
            width = (width + self.fan_in - 1) // self.fan_in

    @property
    def depth(self) -> int:
        return len(self.levels)

    def refold(self, partials: List[Tuple[int, int]]) -> None:
        """Fold fresh leaf partials up the tree (called per summary read)."""
        self.levels[0] = list(partials)
        for li in range(1, len(self.levels)):
            below = self.levels[li - 1]
            level = []
            # each parent folds at most fan_in children — no fold at any
            # level ever sees more than fan_in rows
            for i in range(0, len(below), self.fan_in):
                total = ready = 0
                for t, r in below[i : i + self.fan_in]:
                    total += t
                    ready += r
                level.append((total, ready))
            self.levels[li] = level

    def update_leaf(self, index: int, partial: Tuple[int, int]) -> None:
        """Path refold: replace ONE leaf partial and refold only its
        ancestor chain — O(depth × fan_in) instead of O(S). The read-side
        skip for quiet stores: `pod_summary()` tracks which shards' level-1
        partials moved since the last read and path-refolds when few did
        (docs/control-plane.md §4 routing-overhead shave)."""
        self.levels[0][index] = partial
        child = index
        for li in range(1, len(self.levels)):
            parent = child // self.fan_in
            base = parent * self.fan_in
            below = self.levels[li - 1]
            total = ready = 0
            for t, r in below[base : base + self.fan_in]:
                total += t
                ready += r
            self.levels[li][parent] = (total, ready)
            child = parent

    def root(self) -> Tuple[int, int]:
        return self.levels[-1][0]

    def fold_depth_histogram(self) -> List[int]:
        """Nodes per fold level, leaves first — e.g. 16 shards, fan-in 8
        → [16, 2, 1]: the widest fold any read performs is fan_in."""
        return [len(level) for level in self.levels]
