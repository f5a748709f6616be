"""GL016 explain-readonly (docs/observability.md "Admission explain").

The explain engine's whole value is that asking "why is my gang Pending"
is FREE of side effects: an operator (or a dashboard polling it every
second) must never perturb the admission state it is observing. That
contract has two halves, both enforced here:

1. **Inside** ``grove_tpu_torch/observability/explain.py`` and
   ``grove_tpu_torch/solver/introspect.py``: no call to any store
   commit/bind/evict primitive, no arming of the disruption broker, no
   delta/frontier invalidation or cache write — the read-only pin
   (``resource_version_vector()`` + ``state_fingerprint()`` byte-equal
   across a burst, tests/test_explain.py) is the runtime twin of this
   static gate.
2. **Outside** those modules: the engine's verdict cache (``_verdicts``)
   is private — a foreign writer could fabricate the "last verdict" the
   /debug/journeys pending annotation shows for a stuck gang (the GL015
   treatment applied to the explain layer).
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk
from grove_tpu_torch.analysis.rules.glassbox import GlassBoxStateRule

EXPLAIN_MODULES = (
    "grove_tpu_torch/observability/explain.py",
    "grove_tpu_torch/solver/introspect.py",
)

# mutation-primitive call names -> substrings the receiver chain must
# contain for the call to count (None = any receiver). Receiver scoping
# keeps dict.update()/list.append() out of scope while still catching
# store.update(...) / sched.delta.invalidate() / cluster.bind(...).
_FORBIDDEN_CALLS = {
    # store commits
    "create": ("store",),
    "update": ("store",),
    "update_status": ("store",),
    "delete": ("store",),
    "delete_collection": ("store",),
    "restore_objects": ("store",),
    "read_modify_write": ("store",),
    "commit_status": None,
    "commit_cow": None,
    # cluster mutators
    "bind": ("cluster",),
    "crash_node": ("cluster",),
    "restart_node": ("cluster",),
    "fail_node": ("cluster",),
    "fail_pod": ("cluster",),
    "rebuild_bindings": ("cluster",),
    # eviction primitives (GL002's set)
    "_evict_victim": None,
    "_evict_gang_whole": None,
    "_push_template_to_replica": None,
    # monitor / broker state
    "hold_gang": None,
    "grant": ("broker", "disruption"),
    "arm": ("broker", "disruption"),
    "note_failure": ("broker", "disruption"),
    # delta / frontier registration hooks & caches
    "invalidate": ("delta", "frontier"),
    "mark_node_dirty": ("delta",),
    "mark_gang_dirty": ("delta",),
    "store_spec": ("delta",),
    "enable_delta": None,
    "enable_frontier": None,
    # sticky-pad commit (read-only callers use .peek())
    "grow": ("pad", "pad_groups"),
}

# explain-engine private state, locked to its module when reached through
# an explain-named chain (harness.explain._verdicts, engine._verdicts, …)
_EXPLAIN_PRIVATE = {"_verdicts"}


def _explain_chain(base: str) -> bool:
    if not base:
        return False
    return any("explain" in seg.lower() for seg in base.split("."))


class ExplainReadonlyRule(Rule):
    id = "GL016"
    name = "explain-readonly"
    description = (
        "explain/introspect modules may not call store commit/bind/evict"
        " primitives (asking 'why is it Pending' must be free of side"
        " effects); the engine's verdict cache is private to"
        " observability/explain.py"
    )
    paths = ("grove_tpu_torch/",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        if ctx.rel in EXPLAIN_MODULES:
            yield from self._check_readonly(ctx)
        else:
            yield from self._check_cache_privacy(ctx)

    def _check_readonly(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (
                fn.attr
                if isinstance(fn, ast.Attribute)
                else fn.id
                if isinstance(fn, ast.Name)
                else ""
            )
            scopes = _FORBIDDEN_CALLS.get(name, "missing")
            if scopes == "missing":
                continue
            base = (
                dotted(fn.value).lower()
                if isinstance(fn, ast.Attribute)
                else ""
            )
            if scopes is not None and not any(s in base for s in scopes):
                continue
            yield Violation(
                rule=self.id,
                path=ctx.rel,
                line=node.lineno,
                col=node.col_offset,
                message=(
                    f"mutation primitive `{(base + '.') if base else ''}"
                    f"{name}(...)` called from an explain/introspect"
                    " module — the admission explain engine is"
                    " READ-ONLY by contract (rv vector + delta"
                    " fingerprint pinned byte-identical across a burst);"
                    " compute on private snapshots instead (GL016)"
                ),
            )

    def _check_cache_privacy(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            for name, base, lineno, col in GlassBoxStateRule._written_attrs(
                node
            ):
                if name in _EXPLAIN_PRIVATE and _explain_chain(base):
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=lineno,
                        col=col,
                        message=(
                            f"explain-engine private state `{base}.{name}`"
                            " mutated outside observability/explain.py —"
                            " a foreign writer could fabricate the 'last"
                            " verdict' journeys show for a stuck gang;"
                            " verdicts enter the cache only via"
                            " explain()/whatif() (GL016)"
                        ),
                    )
