"""AST inventory collectors: what the port's tree actually emits.

Counterpart of ``grove_tpu/analysis/inventory.py``: the event reasons,
metric names and profiler phases the port emits, which
tests/test_torch_grovelint.py holds equal to the JAX package's. Pure-AST — no imports of
the scanned modules, so collection can't be skewed by runtime state.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, Set, Tuple

from grove_tpu_torch.analysis.engine import (
    dotted,
    event_record_reason,
    repo_python_files,
)

_METRIC_METHODS = {"inc", "set", "observe"}


def _metric_base(text: str) -> str:
    """Base metric name: everything before the `/label` and `@shard`
    suffixes (observability/metrics.py grammar)."""
    return text.split("/", 1)[0].split("@", 1)[0]


def _literal_prefix(node: ast.AST) -> str:
    """Literal text of a metric-name argument: a plain string, or the
    leading constant of an f-string (names label with `/{...}` and/or
    `@{...}` suffixes — the base name is everything before either)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _metric_base(node.value)
    if isinstance(node, ast.JoinedStr) and node.values:
        head = node.values[0]
        if isinstance(head, ast.Constant) and isinstance(head.value, str):
            return _metric_base(head.value).rstrip("/@")
    return ""


def _string_constants(root: Path, rel: str, prefix: str) -> Dict[str, str]:
    """``NAME -> value`` of the module-level string constants of ``rel``
    whose names start with ``prefix``, read without importing it."""
    out: Dict[str, str] = {}
    for node in ast.walk(ast.parse((root / rel).read_text())):
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id.startswith(prefix)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            out[node.targets[0].id] = node.value.value
    return out


def _name_of(node: ast.AST):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def emitted_event_reasons(
    root: Path,
) -> Dict[str, Set[Tuple[str, int]]]:
    """reason -> {(path, line)} for every record()/record_event() call
    site with a resolvable reason (literal or REASON_ constant)."""
    out: Dict[str, Set[Tuple[str, int]]] = {}
    # resolve REASON_* constant values without importing
    constants = _string_constants(root, "grove_tpu_torch/observability/events.py", "REASON_")
    for rel in repo_python_files(root):
        tree = ast.parse((root / rel).read_text())
        for node in ast.walk(tree):
            # a REASON_* constant referenced anywhere outside events.py
            # counts as emittable: several sites thread reasons through an
            # `event_reason` parameter into one shared record() call
            if rel != "grove_tpu_torch/observability/events.py":
                name = _name_of(node)
                if name in constants:
                    out.setdefault(constants[name], set()).add(
                        (rel, node.lineno)
                    )
            if not isinstance(node, ast.Call):
                continue
            reason_node = event_record_reason(node)
            if reason_node is None:
                continue
            if isinstance(reason_node, ast.Constant) and isinstance(
                reason_node.value, str
            ):
                value = reason_node.value
            else:
                value = constants.get(_name_of(reason_node))
            if value is not None:
                out.setdefault(value, set()).add((rel, node.lineno))
    return out


def emitted_metric_names(root: Path) -> Dict[str, Set[Tuple[str, int]]]:
    """metric base name -> {(path, line)} for every METRICS.inc/set/
    observe call with a literal (or f-string-prefixed) name."""
    out: Dict[str, Set[Tuple[str, int]]] = {}
    for rel in repo_python_files(root):
        tree = ast.parse((root / rel).read_text())
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_METHODS
                and dotted(node.func.value).split(".")[-1].upper()
                == "METRICS"
                and node.args
            ):
                continue
            name = _literal_prefix(node.args[0])
            if name:
                out.setdefault(name, set()).add((rel, node.lineno))
    return out


def emitted_profile_phases(root: Path) -> Dict[str, Set[Tuple[str, int]]]:
    """phase name -> {(path, line)} for every ``PROFILER.phase("...")``
    call with a literal name, plus the implicit ``reconcile`` phase for
    ``PROFILER.reconcile(...)`` call sites. Feeds the docs-drift gate: an
    instrumented phase cannot ship outside the profile.py registry or the
    docs/observability.md "Wall-attribution profiler" table. A
    ``PHASE_*`` constant of observability/profile.py resolves to its value
    (the port names its engine and store phases so)."""
    out: Dict[str, Set[Tuple[str, int]]] = {}
    phases = _string_constants(root, "grove_tpu_torch/observability/profile.py", "PHASE_")
    for rel in repo_python_files(root):
        tree = ast.parse((root / rel).read_text())
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
            ):
                continue
            base = dotted(node.func.value).split(".")[-1].lower()
            if "profiler" not in base:
                continue
            if node.func.attr == "reconcile":
                out.setdefault("reconcile", set()).add((rel, node.lineno))
            elif node.func.attr == "phase" and node.args:
                arg = node.args[0]
                # literal or PHASE_* constant, or a conditional between
                # them (the store's status-write vs store-commit split)
                candidates = (
                    (arg.body, arg.orelse)
                    if isinstance(arg, ast.IfExp)
                    else (arg,)
                )
                for cand in candidates:
                    if isinstance(cand, ast.Constant) and isinstance(
                        cand.value, str
                    ):
                        value = cand.value
                    else:
                        value = phases.get(_name_of(cand))
                    if value is not None:
                        out.setdefault(value, set()).add((rel, node.lineno))
    return out


def all_string_literals(root: Path, rels: Iterable[str]) -> Set[str]:
    """Every string constant in the given files (docs→code direction of
    the metric drift check: a documented name must exist in code)."""
    out: Set[str] = set()
    for rel in rels:
        for node in ast.walk(ast.parse((root / rel).read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                out.add(node.value)
            elif isinstance(node, ast.JoinedStr):
                for part in node.values:
                    if isinstance(part, ast.Constant) and isinstance(
                        part.value, str
                    ):
                        out.add(part.value)
    return out
