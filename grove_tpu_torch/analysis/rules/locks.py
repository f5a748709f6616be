"""GL009 lock-acquisition-order consistency.

~8 modules hold `threading.Lock`s (apiserver, tracer, events, metrics,
encode cache, hashing evictor, grpcsolver watchers). None of them may
nest acquisitions in conflicting orders, or two threads interleaving
(reconcile workers vs. watch fan-out vs. scrape handlers) deadlock.

Static extraction: within every function, syntactically nested `with
<lock>` acquisitions produce ordered edges `outer → inner`; a call made
while holding a lock to a same-class method that acquires its own lock
contributes the edge too (one level of expansion — the pattern real
deadlocks here would take). Lock identity is `Class.attr` for
`self._lock`-style attributes and `module:NAME` for module-level locks.
The transitive order must stay acyclic; `finalize()` reports every cycle,
and `summary()` exposes the extracted partial order for the JSON artifact
(the runtime sanitizer asserts the same property dynamically).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk


def _is_lock_name(name: str) -> bool:
    return "lock" in name.lower()


class LockOrderRule(Rule):
    id = "GL009"
    name = "lock-order"
    description = (
        "lock acquisitions must follow one global partial order — nested"
        " `with lock:` blocks may never form a cycle across the codebase"
    )
    paths = ("grove_tpu_torch/",)

    def __init__(self) -> None:
        # edge (outer, inner) -> first (path, line) witnessing it
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        # per (class, method) info for one-level call expansion
        self._acquires: Dict[Tuple[str, str], Set[str]] = {}
        self._calls_under_lock: List[Tuple[str, str, str, str, int]] = []
        # (class, holding_lock, called_method, path, line)

    def _lock_id(
        self, expr: ast.AST, cls: Optional[str], module: str
    ) -> Optional[str]:
        """Identity of a lock-ish with-context expression, else None."""
        if isinstance(expr, ast.Attribute) and _is_lock_name(expr.attr):
            base = dotted(expr.value)
            if base == "self" and cls:
                return f"{cls}.{expr.attr}"
            return f"{base}.{expr.attr}" if base else expr.attr
        if isinstance(expr, ast.Name) and _is_lock_name(expr.id):
            return f"{module}:{expr.id}"
        return None

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        ctx.annotate_classes()
        module = ctx.rel
        for fn in ctx.functions():
            cls = ctx.enclosing_class(fn)
            self._walk(fn.body, [], cls, module, ctx, fn.name)
        return ()

    def _walk(
        self,
        body: List[ast.stmt],
        held: List[str],
        cls: Optional[str],
        module: str,
        ctx: FileContext,
        fn_name: str,
    ) -> None:
        for stmt in body:
            if isinstance(stmt, ast.With):
                acquired = []
                for item in stmt.items:
                    lock = self._lock_id(item.context_expr, cls, module)
                    if lock is not None:
                        for outer in held + acquired:
                            self.edges.setdefault(
                                (outer, lock), (ctx.rel, stmt.lineno)
                            )
                        acquired.append(lock)
                if acquired and cls is not None:
                    key = (cls, fn_name)
                    self._acquires.setdefault(key, set()).update(acquired)
                self._walk(
                    stmt.body, held + acquired, cls, module, ctx, fn_name
                )
                # record method calls made while holding (for expansion)
                if held or acquired:
                    for node in walk(stmt):
                        if (
                            isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and dotted(node.func.value) == "self"
                        ):
                            for h in held + acquired:
                                self._calls_under_lock.append(
                                    (
                                        cls or "",
                                        h,
                                        node.func.attr,
                                        ctx.rel,
                                        node.lineno,
                                    )
                                )
            else:
                for attr in ("body", "orelse", "finalbody", "handlers"):
                    sub = getattr(stmt, attr, None)
                    if not sub:
                        continue
                    if attr == "handlers":
                        for h in sub:
                            self._walk(
                                h.body, held, cls, module, ctx, fn_name
                            )
                    else:
                        self._walk(sub, held, cls, module, ctx, fn_name)
                # top-level acquisition recording for expansion (methods
                # that take their own lock at any depth are captured by the
                # With branch above via _acquires)

    def finalize(self) -> Iterable[Violation]:
        # one-level call expansion: holding L1, calling self.m() where m
        # acquires L2 -> edge L1 -> L2
        for cls, lock, method, path, line in self._calls_under_lock:
            inner = self._acquires.get((cls, method))
            if inner:
                for l2 in inner:
                    self.edges.setdefault((lock, l2), (path, line))
        # cycle detection over the edge graph
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            if a != b:
                graph.setdefault(a, set()).add(b)
        for cycle in self._cycles(graph):
            first_edge = (cycle[0], cycle[1 % len(cycle)])
            where = self.edges.get(first_edge, ("", 0))
            yield Violation(
                rule=self.id,
                path=where[0],
                line=where[1],
                col=0,
                message=(
                    "lock-order cycle: "
                    + " -> ".join(cycle + [cycle[0]])
                    + " — pick one global acquisition order"
                ),
            )

    @staticmethod
    def _cycles(graph: Dict[str, Set[str]]) -> List[List[str]]:
        """Elementary cycles via DFS (small graphs; dedup by node set)."""
        cycles: List[List[str]] = []
        seen_sets: Set[frozenset] = set()

        def dfs(start: str, node: str, path: List[str], visited: Set[str]):
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycles.append(list(path))
                elif nxt not in visited and nxt > start:
                    # only roots that are the lexicographically smallest
                    # member explore, so each cycle is found once
                    visited.add(nxt)
                    dfs(start, nxt, path + [nxt], visited)
                    visited.discard(nxt)

        for root in sorted(graph):
            dfs(root, root, [root], {root})
        return cycles

    def summary(self) -> Optional[dict]:
        return {
            "edges": sorted(f"{a} -> {b}" for (a, b) in self.edges),
            "locks": sorted(
                {a for a, _ in self.edges} | {b for _, b in self.edges}
            ),
        }
