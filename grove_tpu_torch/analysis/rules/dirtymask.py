"""GL012 dirty-mask registration for cluster-tensor inputs.

The incremental delta-solve state (solver/deltastate.py, docs/solver.md)
keeps the solver's cluster tensors — the free-capacity matrix, the node
encoding, the per-gang encoded specs — device-resident across ticks and
folds them from the store's watch stream plus a per-tick node signature.
That exactness argument has one blind spot: the **binding map**
(``SimCluster.bindings``). Store commits fire watch events and node
attribute changes are re-signed every tick, but ``bindings`` is a plain
dict — a direct write from outside its owner is invisible to BOTH
channels, so the maintained free rows silently drift until the periodic
audit catches them (and under the sanitizer, fails the run).

GL012 therefore flags, outside the owning modules:

- direct mutation of ``<cluster>.bindings`` (assignment, ``del``,
  in-place mutators) and writes to ``<cluster>.bindings_epoch`` — the
  epoch is ``rebuild_bindings``'s receipt, forging it fakes a resync;
- mutation of the delta state's private masks/tensors
  (``<delta>._free``, ``._dirty_nodes``, ``._specs``, ...) — the
  sanctioned registration API is ``invalidate()`` / ``mark_node_dirty()``
  / ``mark_gang_dirty()``.

A direct ``bindings`` write CAN be sound — when a store commit for the
same pod already fired (the event, not the dict, is the registration:
controller/nodehealth.py's eviction paths). Such sites carry the
mandatory-justification pragma; new ones must argue the same invariant.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# private delta-solve state: mutations outside solver/deltastate.py bypass
# the dirty-mask bookkeeping entirely (reads are fine)
_DELTA_PRIVATE = {
    "_free",
    "_enc_cache",
    "_node_pods",
    "_pod_node",
    "_dirty_nodes",
    "_dirty_gangs",
    "_specs",
    "_enc",
    "_node_sig",
    "_mirror_built",
    "_bindings_epoch",
}

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

_REGISTRATION_HINT = (
    " — register the mutation instead: commit through the store (the"
    " watch event IS the registration), bump via"
    " SimCluster.rebuild_bindings, or call the DeltaSolveState"
    " registration API (invalidate / mark_node_dirty / mark_gang_dirty)"
)


def _cluster_bindings(node: ast.AST):
    """(base, attr) when the attribute chain passes through
    ``<...cluster-ish>.bindings`` / ``.bindings_epoch``, else None."""
    probe = node
    while isinstance(probe, (ast.Attribute, ast.Subscript)):
        if isinstance(probe, ast.Attribute) and probe.attr in (
            "bindings",
            "bindings_epoch",
        ):
            base = dotted(probe.value)
            leaf = base.split(".")[-1] if base else ""
            if "cluster" in leaf.lower() or leaf == "self":
                return base, probe.attr
        probe = probe.value
    return None


def _delta_private(node: ast.AST):
    """(base, attr) when the chain passes through ``<...delta>.<_priv>``."""
    probe = node
    while isinstance(probe, (ast.Attribute, ast.Subscript)):
        if isinstance(probe, ast.Attribute) and probe.attr in _DELTA_PRIVATE:
            base = dotted(probe.value)
            leaf = base.split(".")[-1] if base else ""
            if "delta" in leaf.lower():
                return base, probe.attr
        probe = probe.value
    return None


class DirtyMaskRegistrationRule(Rule):
    id = "GL012"
    name = "dirty-mask-registration"
    description = (
        "writes to cluster-tensor inputs (the binding map, the delta"
        " state's masks/tensors) must go through a watched channel or the"
        " dirty-mask registration API — a bypassing write silently drifts"
        " the incremental solver state"
    )
    paths = ("grove_tpu_torch/",)
    exclude = (
        # the owners: cluster.py maintains bindings under its own methods,
        # deltastate.py IS the mask bookkeeping
        "grove_tpu_torch/sim/cluster.py",
        "grove_tpu_torch/solver/deltastate.py",
    )

    def _hits(self, target: ast.AST):
        hit = _cluster_bindings(target)
        if hit is not None:
            return hit + ("binding map",)
        hit = _delta_private(target)
        if hit is not None:
            return hit + ("delta-solve state",)
        return None

    def _violation(
        self, ctx: FileContext, node, base, attr, kind, what
    ) -> Violation:
        return Violation(
            rule=self.id,
            path=ctx.rel,
            line=node.lineno,
            col=node.col_offset,
            message=(
                f"{what} of {kind} `{base}.{attr}` bypasses the dirty-mask"
                f" fold{_REGISTRATION_HINT}"
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
                    hit = self._hits(target)
                    if hit is not None:
                        yield self._violation(
                            ctx, node, *hit, "direct assignment"
                        )
            elif isinstance(node, ast.Delete):
                for target in node.targets:
                    hit = self._hits(target)
                    if hit is not None:
                        yield self._violation(ctx, node, *hit, "`del`")
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
                    hit = self._hits(fn.value)
                    if hit is not None:
                        yield self._violation(
                            ctx,
                            node,
                            *hit,
                            f"in-place `.{fn.attr}()` mutation",
                        )
