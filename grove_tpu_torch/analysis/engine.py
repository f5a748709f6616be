"""grovelint rule engine over the port's tree: per-file AST visitor
dispatch, path-scoped rule applicability, inline suppression pragmas,
JSON + human output. Counterpart of ``grove_tpu/analysis/engine.py``, with
the same pragma contract and report.

Design (mirroring `go vet`'s shape, the correctness tool the reference
operator leans on):

- A **Rule** declares path scope (`paths`/`exclude` prefixes relative to
  the repo root) and a `check(FileContext)` generator yielding Violations.
  Rules that need whole-repo state (lock-order cycles) accumulate in
  `check` and emit from `finalize()`.
- The **pragma contract**: ``# grovelint: disable=RULE -- reason`` on (or
  immediately above) the offending line suppresses that rule there. The
  justification is MANDATORY — a pragma without ``-- reason`` is itself a
  violation (``GL000``), so the suppression inventory stays reviewable.
- **Exit-code contract** (scripts/torch_lint.py): 0 clean, 1 violations,
  2 internal/usage error.

The engine is stdlib-only (ast/re/json): linting imports no torch.
Individual rules may import grove_tpu_torch modules lazily (the event-reason
registry) — those imports are cheap and torch-free.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

BARE_PRAGMA_RULE = "GL000"

_PRAGMA_RE = re.compile(
    r"#\s*grovelint:\s*disable=([A-Za-z0-9_*,\-]+)\s*(?:--\s*(\S.*))?$"
)


@dataclass
class Violation:
    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    suppressed: bool = False
    justification: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        doc = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }
        if self.suppressed:
            doc["suppressed"] = True
            doc["justification"] = self.justification
        return doc


@dataclass
class Pragma:
    line: int
    rules: frozenset  # rule ids, or {"*"}
    reason: str

    def covers(self, rule: str) -> bool:
        return "*" in self.rules or rule in self.rules


class FileContext:
    """One parsed file handed to every applicable rule (parse once)."""

    def __init__(self, rel: str, source: str) -> None:
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        # line -> Pragma for that line AND the next (a pragma-only line
        # suppresses the statement below it)
        self.pragmas: Dict[int, Pragma] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m is None:
                continue
            pragma = Pragma(
                line=i,
                rules=frozenset(
                    r.strip() for r in m.group(1).split(",") if r.strip()
                ),
                reason=(m.group(2) or "").strip(),
            )
            self.pragmas[i] = pragma
            # a comment-only pragma line governs the line it annotates
            if text.split("#", 1)[0].strip() == "":
                self.pragmas.setdefault(i + 1, pragma)

    def pragma_for(self, rule: str, line: int) -> Optional[Pragma]:
        p = self.pragmas.get(line)
        if p is not None and p.covers(rule):
            return p
        return None

    # -- shared AST helpers (used by several rules) ----------------------

    def functions(self) -> Iterator[ast.AST]:
        for node in walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def enclosing_class(self, fn: ast.AST) -> Optional[str]:
        return getattr(fn, "_grovelint_class", None)

    def annotate_classes(self) -> None:
        """Stamp each function with its enclosing class name (one pass)."""
        for node in walk(self.tree):
            if isinstance(node, ast.ClassDef):
                for child in walk(node):
                    if isinstance(
                        child, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ) and not hasattr(child, "_grovelint_class"):
                        child._grovelint_class = node.name


def walk(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk``'s nodes in its own breadth-first order, kept on the node
    after the first walk: every rule walks every file, so each tree and
    function body is expanded once instead of once a walk."""
    try:
        return iter(node._grovelint_walk)
    except AttributeError:
        pass
    out = [node]
    i = 0
    while i < len(out):
        out.extend(ast.iter_child_nodes(out[i]))
        i += 1
    node._grovelint_walk = out
    return iter(out)


def call_name(node: ast.Call) -> str:
    """Trailing identifier of a call target: f() -> f, a.b.f() -> f."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def dotted(node: ast.AST) -> str:
    """Best-effort dotted source of an expression (a.b.c)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted(node.func)
    return ""


# event-recorder call shapes shared by the GL006 rule and the inventory
# collectors (tests/test_docs_drift.py): attr name -> positional index of
# the reason argument. ONE definition, or the lint rule and the docs-drift
# inventory diverge — the drift class this subsystem exists to prevent.
_EVENT_RECORD_SHAPES = {"record": 2, "record_event": 1}


def event_record_reason(node: ast.Call) -> Optional[ast.AST]:
    """The reason-argument AST node of an event-recorder call
    (``EVENTS.record(ref, type, reason, msg)`` /
    ``ctx.record_event(kind, reason, msg, ...)``), or None when the call
    is not an event-recorder call."""
    if not isinstance(node.func, ast.Attribute):
        return None
    idx = _EVENT_RECORD_SHAPES.get(node.func.attr)
    if idx is None:
        return None
    # only event-recorder receivers (EVENTS.record, recorder.record,
    # ctx.record_event, self.ctx.record_event) — not dict.record etc.
    base = dotted(node.func.value).lower()
    if node.func.attr == "record" and not (
        "events" in base or "recorder" in base
    ):
        return None
    for kw in node.keywords:
        if kw.arg == "reason":
            return kw.value
    if len(node.args) > idx:
        return node.args[idx]
    return None


class Rule:
    """Base rule. Subclasses set id/name/description and path scope."""

    id = "GL???"
    name = "unnamed"
    description = ""
    paths: Tuple[str, ...] = ("grove_tpu_torch/",)
    exclude: Tuple[str, ...] = ()

    def applies(self, rel: str) -> bool:
        if any(rel == e or rel.startswith(e) for e in self.exclude):
            return False
        return any(rel == p or rel.startswith(p) for p in self.paths)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        raise NotImplementedError

    def finalize(self) -> Iterable[Violation]:
        """Whole-repo emission hook (after every file was checked)."""
        return ()

    def summary(self) -> Optional[dict]:
        """Optional machine-readable extra for the JSON report (e.g. the
        extracted lock partial order)."""
        return None


@dataclass
class LintReport:
    violations: List[Violation] = field(default_factory=list)
    suppressed: List[Violation] = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)
    rule_summaries: Dict[str, dict] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.violations and not self.parse_errors

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for v in self.violations:
            out[v.rule] = out.get(v.rule, 0) + 1
        return out

    def as_json(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "violations": [v.as_dict() for v in self.violations],
            "suppressed": [v.as_dict() for v in self.suppressed],
            "counts": self.counts(),
            "suppression_count": len(self.suppressed),
            "parse_errors": self.parse_errors,
            "rules": self.rule_summaries,
        }

    def render_human(self) -> str:
        lines = [v.render() for v in self.violations]
        lines.extend(f"parse error: {e}" for e in self.parse_errors)
        lines.append(
            f"grovelint: {self.files_scanned} file(s), "
            f"{len(self.violations)} violation(s), "
            f"{len(self.suppressed)} suppression(s)"
        )
        return "\n".join(lines)


def default_rules() -> List[Rule]:
    from grove_tpu_torch.analysis.rules import ALL_RULES

    return [cls() for cls in ALL_RULES]


def _apply_pragmas(
    ctx: FileContext, raw: Iterable[Violation]
) -> Tuple[List[Violation], List[Violation]]:
    live: List[Violation] = []
    suppressed: List[Violation] = []
    for v in raw:
        # GL000 is exempt from suppression: a bare `disable=*` pragma must
        # not be able to suppress the violation flagging its own bareness
        pragma = (
            ctx.pragma_for(v.rule, v.line)
            if v.rule != BARE_PRAGMA_RULE
            else None
        )
        if pragma is not None:
            v.suppressed = True
            v.justification = pragma.reason
            suppressed.append(v)
        else:
            live.append(v)
    return live, suppressed


def _bare_pragma_violations(ctx: FileContext) -> List[Violation]:
    out = []
    seen = set()
    for pragma in ctx.pragmas.values():
        if pragma.line in seen:
            continue
        seen.add(pragma.line)
        if not pragma.reason:
            out.append(
                Violation(
                    rule=BARE_PRAGMA_RULE,
                    path=ctx.rel,
                    line=pragma.line,
                    col=0,
                    message=(
                        "bare suppression: every `# grovelint: disable=...`"
                        " pragma must carry `-- <justification>`"
                    ),
                )
            )
    return out


def lint_source(
    source: str, rel: str, rules: Optional[List[Rule]] = None
) -> LintReport:
    """Lint one in-memory source blob as if it lived at repo path `rel`
    (fixture snippets in tests; single-file checks)."""
    rules = default_rules() if rules is None else rules
    report = LintReport(files_scanned=1)
    try:
        ctx = FileContext(rel, source)
    except SyntaxError as e:
        report.parse_errors.append(f"{rel}: {e}")
        return report
    raw: List[Violation] = list(_bare_pragma_violations(ctx))
    for rule in rules:
        if rule.applies(rel):
            raw.extend(rule.check(ctx))
    for rule in rules:
        raw.extend(rule.finalize())
        extra = rule.summary()
        if extra is not None:
            report.rule_summaries[rule.id] = extra
    live, suppressed = _apply_pragmas(ctx, raw)
    report.violations.extend(live)
    report.suppressed.extend(suppressed)
    _sort(report)
    return report


def lint_paths(
    root: Path,
    rel_paths: Iterable[str],
    rules: Optional[List[Rule]] = None,
) -> LintReport:
    rules = default_rules() if rules is None else rules
    report = LintReport()
    contexts: Dict[str, FileContext] = {}
    for rel in sorted(rel_paths):
        path = root / rel
        try:
            source = path.read_text()
        except OSError as e:
            report.parse_errors.append(f"{rel}: {e}")
            continue
        try:
            ctx = FileContext(rel, source)
        except SyntaxError as e:
            report.parse_errors.append(f"{rel}: {e}")
            continue
        contexts[rel] = ctx
        report.files_scanned += 1
        raw: List[Violation] = list(_bare_pragma_violations(ctx))
        for rule in rules:
            if rule.applies(rel):
                raw.extend(rule.check(ctx))
        live, suppressed = _apply_pragmas(ctx, raw)
        report.violations.extend(live)
        report.suppressed.extend(suppressed)
    for rule in rules:
        for v in rule.finalize():
            ctx = contexts.get(v.path)
            pragma = ctx.pragma_for(v.rule, v.line) if ctx else None
            if pragma is not None:
                v.suppressed = True
                v.justification = pragma.reason
                report.suppressed.append(v)
            else:
                report.violations.append(v)
        extra = rule.summary()
        if extra is not None:
            report.rule_summaries[rule.id] = extra
    _sort(report)
    return report


def _sort(report: LintReport) -> None:
    report.violations.sort(key=lambda v: (v.path, v.line, v.rule))
    report.suppressed.sort(key=lambda v: (v.path, v.line, v.rule))


def repo_python_files(root: Path) -> List[str]:
    """The lint universe: every .py under grove_tpu_torch/ (generated protos
    excluded — machine output is not held to hand-written invariants)."""
    out = []
    for path in sorted((root / "grove_tpu_torch").rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if "__pycache__" in rel or "/protos/" in rel:
            continue
        out.append(rel)
    return out


def run_repo_lint(
    root: Optional[Path] = None, rules: Optional[List[Rule]] = None
) -> LintReport:
    """Lint the port's whole tree (the core of `scripts/torch_lint.py`)."""
    if root is None:
        root = Path(__file__).resolve().parents[2]
    return lint_paths(root, repo_python_files(root), rules)


def main_json(report: LintReport) -> str:
    return json.dumps(report.as_json(), indent=2, sort_keys=True)
