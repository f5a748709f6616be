"""GL004 store write-path discipline + GL011 logged-commit mutations.

The copy-on-write store keeps pickling/deep-copying off the
control-plane write path; the contract is: reads are zero-copy readonly
views, writes go through `commit_cow` / the sanctioned `Store` methods
(create/update/update_status/delete/commit_status/commit_spec/
commit_finalizer_add). Two regressions this rule catches statically:

- **Serialization creep**: `copy.deepcopy` / `pickle.dumps|loads` back in
  control-plane packages (the sanctioned structural helper is
  `api.meta.deep_copy`, and only OFF the per-write path).
- **Private-state bypass**: reaching into the store's internals
  (`_committed`, `_blob`, ...) from outside runtime/store.py skips
  resourceVersion bumps, watch events, aggregates, and the byte-compare
  guard — the silent-corruption class `verify_readonly_integrity` exists
  to catch at runtime.

GL011 (durability layer, docs/robustness.md) tightens the same contract
repo-wide for MUTATIONS: every store mutation must flow through the
logged commit APIs (create/update/update_status/delete/commit_cow/
restore_objects and the commit_* helpers). The write-ahead log observes
commits through the watch fanout — a direct mutation of store internals
(`store._committed[...] = obj`, `store._rv += 1`,
`store._blob.pop(...)`) would be invisible to the WAL, so a crash-restart
recovery would silently diverge from the live state it replaced. Only
`runtime/store.py` itself and the durability module (which replays
through `restore_objects`) are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

_STORE_PRIVATE = {
    "_committed",
    "_cache",
    "_blob",
    "_cache_blob",
    "_index",
    "_cache_index",
    "_rv",
    "_agg_committed",
    "_agg_cached",
    "_guard_blobs",
}

_SERIALIZERS = {
    "deepcopy": "copy.deepcopy",
    "dumps": "pickle.dumps",
    "loads": "pickle.loads",
}

# methods that mutate a container in place — called on store-private
# state they bypass the logged commit path (GL011)
_MUTATORS = {
    "append",
    "extend",
    "insert",
    "remove",
    "pop",
    "popitem",
    "clear",
    "update",
    "setdefault",
    "add",
    "discard",
}


def _store_private_attr(node: ast.AST):
    """(base dotted path, private attr) when `node`'s attribute chain
    passes through `<...store>.<_private>`, else None."""
    probe = node
    while isinstance(probe, (ast.Attribute, ast.Subscript)):
        if isinstance(probe, ast.Attribute) and probe.attr in _STORE_PRIVATE:
            base = dotted(probe.value)
            leaf = base.split(".")[-1] if base else ""
            if "store" in leaf.lower():
                return base, probe.attr
        probe = probe.value
    return None


class StoreWritePathRule(Rule):
    id = "GL004"
    name = "store-write-path"
    description = (
        "store mutation only via commit_cow/sanctioned Store methods — no"
        " pickling/deepcopy on the control-plane write path, no private"
        " store-state access outside runtime/store.py"
    )
    paths = (
        "grove_tpu_torch/runtime/",
        "grove_tpu_torch/controller/",
        "grove_tpu_torch/solver/",
        "grove_tpu_torch/sim/",
        "grove_tpu_torch/disruption/",
        "grove_tpu_torch/quota/",
        "grove_tpu_torch/autoscale/",
        # the WAL serializes every commit: pickle creeping in here would
        # tie the on-disk log to one code version
        "grove_tpu_torch/durability/",
    )
    exclude = ("grove_tpu_torch/runtime/store.py",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        pickle_aliases = set()
        copy_aliases = set()
        from_names = {}
        for node in walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    if alias.name == "pickle":
                        pickle_aliases.add(local)
                    elif alias.name == "copy":
                        copy_aliases.add(local)
            elif isinstance(node, ast.ImportFrom):
                if node.module in ("pickle", "copy"):
                    for alias in node.names:
                        if alias.name in _SERIALIZERS:
                            from_names[alias.asname or alias.name] = (
                                f"{node.module}.{alias.name}"
                            )
        for node in walk(ctx.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                full = None
                if isinstance(fn, ast.Attribute) and isinstance(
                    fn.value, ast.Name
                ):
                    if (
                        fn.value.id in pickle_aliases
                        and fn.attr in ("dumps", "loads")
                    ) or (fn.value.id in copy_aliases and fn.attr == "deepcopy"):
                        full = f"{fn.value.id}.{fn.attr}"
                elif isinstance(fn, ast.Name) and fn.id in from_names:
                    full = from_names[fn.id]
                if full is not None:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"`{full}()` on the control-plane path — use"
                            " the copy-on-write store commits"
                            " (commit_cow/commit_status) or"
                            " api.meta.deep_copy off the write path"
                        ),
                    )
        # private store-state access: `<...>store.<_private>`
        for node in walk(ctx.tree):
            if (
                isinstance(node, ast.Attribute)
                and node.attr in _STORE_PRIVATE
            ):
                base = dotted(node.value)
                leaf = base.split(".")[-1] if base else ""
                if "store" in leaf.lower():
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"private store state `{base}.{node.attr}`"
                            " accessed outside runtime/store.py — writes"
                            " must go through the sanctioned Store API"
                            " (commit_cow, create, update, delete)"
                        ),
                    )


class StoreLoggedCommitRule(Rule):
    id = "GL011"
    name = "store-logged-commits"
    description = (
        "store mutations must flow through the logged commit APIs"
        " (create/update/commit_cow/delete/restore_objects) — direct"
        " mutation of store internals outside runtime/store.py and the"
        " durability module is invisible to the write-ahead log, so"
        " crash-restart recovery would silently diverge"
    )
    # repo-wide: GL004 only covers the control-plane packages, but an
    # un-logged mutation ANYWHERE corrupts recovery
    paths = ("grove_tpu_torch/",)
    exclude = (
        "grove_tpu_torch/runtime/store.py",
        "grove_tpu_torch/durability/",
    )

    def _violation(self, ctx: FileContext, node, base, attr, what) -> Violation:
        return Violation(
            rule=self.id,
            path=ctx.rel,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"{what} of store state `{base}.{attr}` bypasses the"
                " logged commit APIs — the WAL never sees it, so a"
                " crash-restart recovery diverges from the state it"
                " replaces (use create/update/commit_cow/delete, or"
                " restore_objects on the recovery path)"
            ),
        )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for target in targets:
                    hit = _store_private_attr(target)
                    if hit is not None:
                        yield self._violation(
                            ctx, node, hit[0], hit[1], "direct assignment"
                        )
            elif isinstance(node, ast.Delete):
                for target in node.targets:
                    hit = _store_private_attr(target)
                    if hit is not None:
                        yield self._violation(
                            ctx, node, hit[0], hit[1], "`del`"
                        )
            elif isinstance(node, ast.Call):
                fn = node.func
                if (
                    isinstance(fn, ast.Attribute)
                    and fn.attr in _MUTATORS
                ):
                    hit = _store_private_attr(fn.value)
                    if hit is not None:
                        yield self._violation(
                            ctx,
                            node,
                            hit[0],
                            hit[1],
                            f"in-place `.{fn.attr}()` mutation",
                        )
