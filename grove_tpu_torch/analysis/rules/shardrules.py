"""GL013 shard-internals encapsulation (docs/control-plane.md).

The keyspace-sharded store (runtime/shards.py) holds EVERY per-shard
structure — object maps, canonical blobs, label/namespace indices, the
shard's rv sequence and write lock, the per-shard system-watch fan-out
list, the level-1 pod aggregates — inside ``StoreShard``.
The invariants the router maintains (per-object optimistic concurrency
within exactly one shard, per-shard rv monotonicity, fan-out delivery
order, the S=1 byte-identity guarantee, GL011's logged-commit contract
carried per shard) all assume nobody ELSE touches those fields: a
consumer appending to a shard's ``system_watchers`` directly bypasses
the subscribe API's ordering contract, and reading ``shard.committed``
from a controller skips the readonly/materialize discipline the same way
reaching into ``store._committed`` did before GL004.

Flagged outside ``runtime/shards.py``, ``runtime/store.py`` and the
durability module (the three owners named in shards.py's contract):

- the store's shard-router privates (``store._shards``,
  ``store._shard_for(...)``, ``store._shard_of_obj(...)``,
  ``store._summary_tree``, ``store._single``)
- ``StoreShard`` fields accessed through a shard-named binding
  (``shard.committed``, ``shard.lock``, ``shard.rv``,
  ``shard.system_watchers``, ...)

Public surface stays public: ``store.num_shards``, ``shard_index()``,
``shard_resource_version()``, ``resource_version_vector()``,
``shard_census()``, ``shard_kinds()``/``shard_scan()``,
``subscribe_system(shard=k)`` and the ``shard_of`` keyspace map.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# the Store router's private sharding state (runtime/store.py)
_ROUTER_PRIVATE = {
    "_shards",
    "_shard_for",
    "_shard_of_obj",
    "_summary_tree",
    "_summary_tree_cached",
    "_summary_dirty",
    "_summary_dirty_cached",
    "_single",
}

# StoreShard's per-shard fields (runtime/shards.py __slots__, minus the
# public census handle `index`)
_SHARD_FIELDS = {
    "lock",
    "rv",
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
}


class ShardInternalsRule(Rule):
    id = "GL013"
    name = "shard-internals"
    description = (
        "a keyspace shard's internals (store._shards / StoreShard fields:"
        " per-shard locks, rv sequences, object maps,"
        " fan-out lists) are private to runtime/shards.py,"
        " runtime/store.py and the durability module — everything else"
        " goes through the Store router API"
    )
    # repo-wide like GL011: shard state corrupted from ANYWHERE breaks the
    # router's invariants
    paths = ("grove_tpu_torch/",)
    exclude = (
        "grove_tpu_torch/runtime/shards.py",
        "grove_tpu_torch/runtime/store.py",
        "grove_tpu_torch/durability/",
    )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Attribute):
                continue
            if node.attr in _ROUTER_PRIVATE:
                base = dotted(node.value)
                leaf = base.split(".")[-1] if base else ""
                if "store" in leaf.lower():
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"shard-router private `{base}.{node.attr}`"
                            " accessed outside runtime/shards.py /"
                            " runtime/store.py / durability — use the"
                            " Store router API (shard_index,"
                            " shard_resource_version,"
                            " resource_version_vector, shard_scan,"
                            " subscribe_system(shard=k))"
                        ),
                    )
            elif node.attr in _SHARD_FIELDS:
                base = dotted(node.value)
                leaf = base.split(".")[-1] if base else ""
                # a shard-named binding carrying StoreShard state; plain
                # `self.lock` / `obj.cache` style fields elsewhere don't
                # match (their base isn't a shard)
                if "shard" in leaf.lower() and leaf.lower() != "num_shards":
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"StoreShard field `{base}.{node.attr}`"
                            " accessed outside the owning modules —"
                            " per-shard locks/buffers/maps are private"
                            " (GL013); route through the Store API"
                        ),
                    )
