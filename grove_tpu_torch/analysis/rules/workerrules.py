"""GL018 worker-affinity (docs/control-plane.md §5).

The parallel control plane (runtime/workers.py) makes each keyspace
shard the ownership boundary of one reconcile worker: the shard's event
backlog, its workqueue buckets, its reconcile bodies and its WAL stream
are touched only from the owning worker context or at the documented
coordination points (the coordinator's routing/pop/completion loop, the
tick-boundary WAL pump). The serial-twin bit-identity argument leans on
exactly that affinity — a foreign module poking a backlog deque, a
queue's shard buckets, the store's deferred-capture plumbing or a WAL
buffer from an arbitrary thread silently breaks the deterministic
round-robin (or tears a group-commit batch) in ways no test reliably
catches.

Flagged outside the owning modules:

- the Engine's per-shard backlog state (``engine._backlogs``,
  ``engine._backlog_rotation``, ``engine._event_backlog``,
  ``engine._router_lock``) — owned by runtime/engine.py and
  runtime/workers.py;
- the WorkQueue's shard-bucket state (``queue._buckets``,
  ``queue._rotation``, ``queue._bucket_memo``) — owned by
  runtime/workqueue.py (the engine and the parallel drain go through
  ``pop``/``add``);
- the Store's deferred-fanout capture plumbing (``store._capture_tls``,
  ``store._per_shard_fns``, ``store._deferred_armed``, and the
  ``begin_deferred_capture``/``end_deferred_capture`` pair) — owned by
  runtime/store.py and runtime/workers.py;
- a WAL stream's group-commit buffer (``wal._buffer``, ``wal._dead``,
  ``wal._io_lock``) — owned by grove_tpu_torch/durability/.

Public surface stays public: ``Engine.enable_workers``,
``engine.workers.stats()``/``utilization()``, ``WorkQueue.add/pop/...``,
``Store.subscribe_system_per_shard``/``arm_deferred_fanout``, and
``wal.note_event``/``flush``/``pending``.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# attr set -> (binding-leaf substring, owning-module prefixes); the
# process executor (runtime/procworkers.py) is a peer owner of the
# thread executor — its worker lanes and repatriation path ARE the
# owning worker context on the far side of the fork
_ENGINE_OWNERS = (
    "grove_tpu_torch/runtime/engine.py",
    "grove_tpu_torch/runtime/workers.py",
    "grove_tpu_torch/runtime/procworkers.py",
)
_QUEUE_OWNERS = (
    "grove_tpu_torch/runtime/workqueue.py",
    "grove_tpu_torch/runtime/engine.py",
    "grove_tpu_torch/runtime/workers.py",
    "grove_tpu_torch/runtime/procworkers.py",
)
_STORE_OWNERS = (
    "grove_tpu_torch/runtime/store.py",
    "grove_tpu_torch/runtime/workers.py",
    "grove_tpu_torch/runtime/procworkers.py",
)
_WAL_OWNERS = ("grove_tpu_torch/durability/",)

_ENGINE_PRIVATE = {
    "_backlogs",
    "_backlog_rotation",
    "_event_backlog",
    "_router_lock",
}
_QUEUE_PRIVATE = {"_buckets", "_rotation", "_bucket_memo"}
_STORE_PRIVATE = {
    "_capture_tls",
    "_per_shard_fns",
    "_deferred_armed",
    "begin_deferred_capture",
    "end_deferred_capture",
}
_WAL_PRIVATE = {"_buffer", "_dead", "_io_lock"}


class WorkerAffinityRule(Rule):
    id = "GL018"
    name = "worker-affinity"
    description = (
        "mutable per-shard runtime state (engine backlogs/rotation,"
        " workqueue shard buckets, store deferred-capture plumbing,"
        " WAL group-commit buffers) may only be touched from its owning"
        " worker context or the documented coordination points — the"
        " owning runtime/durability modules; everything else goes"
        " through the public Engine/WorkQueue/Store/WAL APIs"
    )
    # repo-wide like GL013: affinity broken from ANYWHERE breaks the
    # serial-twin determinism argument
    paths = ("grove_tpu_torch/",)
    exclude = ()

    def _owned(self, rel: str, owners) -> bool:
        return any(rel.startswith(o) for o in owners)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Attribute):
                continue
            attr = node.attr
            base = dotted(node.value)
            leaf = (base.split(".")[-1] if base else "").lower()
            hit = None
            if attr in _ENGINE_PRIVATE and "engine" in leaf:
                if not self._owned(ctx.rel, _ENGINE_OWNERS):
                    hit = ("Engine per-shard backlog state", "Engine")
            elif attr in _QUEUE_PRIVATE and "queue" in leaf:
                if not self._owned(ctx.rel, _QUEUE_OWNERS):
                    hit = ("WorkQueue shard-bucket state", "WorkQueue")
            elif attr in _STORE_PRIVATE and "store" in leaf:
                if not self._owned(ctx.rel, _STORE_OWNERS):
                    hit = ("Store deferred-capture plumbing", "Store")
            elif attr in _WAL_PRIVATE and "wal" in leaf:
                if not self._owned(ctx.rel, _WAL_OWNERS):
                    hit = ("WAL group-commit buffer state", "WAL")
            if hit is not None:
                what, api = hit
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=node.lineno,
                    col=node.col_offset,
                    message=(
                        f"{what} `{base}.{attr}` touched outside its"
                        " owning worker context (GL018 worker-affinity,"
                        " docs/control-plane.md §5) — go through the"
                        f" public {api} API"
                    ),
                )
