"""GL022 gray-failure state encapsulation (docs/robustness.md
"Gray failures").

The gray-failure ladder works because each detector's memory has ONE
writer, and every state step is loud (a registered event + a metric):

- ``NodeHealthMonitor._suspicion`` (controller/nodehealth.py) — the
  EWMA of peer-relative heartbeat lateness. Only the monitor folds
  observations; a write from anywhere else can flip Ready ⇄ Degraded
  without the NodeDegraded/NodeRecovered events the remediation
  trigger and the chaos verdicts key on.
- ``SimCluster._failslow`` (sim/cluster.py) — the seeded fail-slow
  fault registry (kubelet-side NODE state). Armed and healed only via
  ``inject_failslow``/``heal_failslow``; harness swaps re-inject via
  the public ``failslow_names()``/``failslow_spec()`` accessors. A
  direct graft desyncs the lag trace from the suspicion oracle.
- ``StoreDurability.degraded_mode`` (durability/recovery.py) — the WAL
  degradation ladder (ok → degraded → read-only). Stepped only by the
  durability package's ``_set_degraded_mode``, which emits
  WalDegraded/WalRecovered and fences/unfences writes atomically with
  the step; a bare assignment leaves the fence and the mode disagreeing.
- the worker-boundary fault plan and its dedup ledgers
  (runtime/procworkers.py ``_faults`` / ``_tx_seq`` / ``_rx_seq`` /
  ``_last_sent`` / ``_crx_high`` / ``_creply_cache``) — armed only via
  ``inject_boundary_faults`` BEFORE the first drain (children inherit
  the plan at fork); mutating any of it mid-run splits the coordinator
  and its forked workers into different fault universes.

The injection KNOBS stay public by design — ``inject_failslow(...)``,
``inject_boundary_faults(...)``, ``wal.fault_slow_fsync``,
``wal.fault_disk_full`` are the sanctioned seams chaos and the smokes
drive — it is the detectors' memory and the ladder position that only
their owners may write.
"""

from __future__ import annotations

import ast
from typing import Iterable

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

# attr -> (owning package prefix, what breaks when grafted)
_OWNED = {
    "_suspicion": (
        "grove_tpu_torch/controller/",
        "the suspicion EWMA is NodeHealthMonitor memory; Ready ⇄"
        " Degraded must flip through _suspect (events + metrics)",
    ),
    "_failslow": (
        "grove_tpu_torch/sim/",
        "the fail-slow registry is kubelet state; arm/heal via"
        " inject_failslow/heal_failslow, re-inject across harness"
        " swaps via failslow_names()/failslow_spec()",
    ),
    "degraded_mode": (
        "grove_tpu_torch/durability/",
        "the WAL ladder steps only through _set_degraded_mode, which"
        " emits WalDegraded/WalRecovered and moves the write fence"
        " atomically with the mode",
    ),
    "_faults": (
        "grove_tpu_torch/runtime/",
        "the boundary fault plan is fixed at arm time"
        " (inject_boundary_faults); a mid-run write splits coordinator"
        " and forked workers into different fault universes",
    ),
    "_tx_seq": (
        "grove_tpu_torch/runtime/",
        "frame-sequence state is the dedup protocol's memory",
    ),
    "_rx_seq": (
        "grove_tpu_torch/runtime/",
        "frame-sequence state is the dedup protocol's memory",
    ),
    "_last_sent": (
        "grove_tpu_torch/runtime/",
        "the retransmit buffer is the dedup protocol's memory",
    ),
    "_crx_high": (
        "grove_tpu_torch/runtime/",
        "the worker-side high-water mark is the dedup protocol's memory",
    ),
    "_creply_cache": (
        "grove_tpu_torch/runtime/",
        "the cached-reply ring is the idempotent-RPC memory",
    ),
}

_MUTATORS = {"append", "add", "clear", "pop", "popitem", "update",
             "setdefault", "extend", "remove", "discard"}


class GrayFailStateRule(Rule):
    id = "GL022"
    name = "grayfail-state"
    description = (
        "gray-failure detector memory (suspicion EWMA, fail-slow"
        " registry, WAL ladder position, boundary fault plan + dedup"
        " ledgers) has one writer each — state steps go through the"
        " owner's verbs, which emit the registered events"
    )
    paths = ("grove_tpu_torch/",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in walk(ctx.tree):
            for name, base, lineno, col in self._written_attrs(node):
                owned = _OWNED.get(name)
                if owned is None:
                    continue
                owner, why = owned
                if ctx.rel.startswith(owner):
                    continue
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=lineno,
                    col=col,
                    message=(
                        f"gray-failure state `{base}.{name}` written"
                        f" outside {owner} — {why} (GL022)"
                    ),
                )

    @staticmethod
    def _written_attrs(node):
        """Every (attr, base, line, col) that `node` WRITES: assignment
        / augmented assignment / delete targets (tuple unpacking and
        subscript writes included), or a mutating method call on the
        attribute (`monitor._suspicion.clear()`)."""
        targets = ()
        if isinstance(node, (ast.Assign, ast.Delete)):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = (node.target,)
        for t in targets:
            elts = (
                t.elts if isinstance(t, (ast.Tuple, ast.List)) else (t,)
            )
            for elt in elts:
                inner = elt
                while isinstance(inner, ast.Subscript):
                    inner = inner.value
                if isinstance(inner, ast.Attribute):
                    yield (
                        inner.attr, dotted(inner.value), inner.lineno,
                        inner.col_offset,
                    )
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _MUTATORS
            and isinstance(node.func.value, ast.Attribute)
        ):
            owner = node.func.value
            yield (
                owner.attr, dotted(owner.value), owner.lineno,
                owner.col_offset,
            )
