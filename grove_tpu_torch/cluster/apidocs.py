"""API reference generation from the typed model.

Counterpart of ``grove_tpu/cluster/apidocs.py``, with the same names, wire
format and status codes.

The counterpart of the reference's generated API docs
(upstream docs/api-reference/operator-api.md,
upstream docs/api-reference/scheduler-api.md — produced there by
crd-ref-docs from Go struct comments). Here the same document is derived
reflectively from the dataclasses: field tables (wire name, type, default)
plus descriptions pulled from the comment lines that annotate each field in
the source, so the docs can never drift from the model (drift-tested like
the CRDs, tests/test_cluster_mode.py).

``render_api_reference`` renders it and ``write_api_reference`` writes it;
docs/api-reference.md holds the committed copy (its header names the JAX
package's CLI, which wrote it: the text is byte for byte the JAX package's).
"""

from __future__ import annotations

import dataclasses
import inspect
import re
import typing
from typing import Any, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Field-comment extraction
# ---------------------------------------------------------------------------

_FIELD_RE = re.compile(r"^\s+(\w+)\s*(?::|\s*=)")
_COMMENT_RE = re.compile(r"^\s+#\s?(.*)$")


def _field_comments(cls: type) -> Dict[str, str]:
    """Map field name -> the contiguous `#` comment block directly above its
    declaration in the class body (the dataclass idiom this codebase uses for
    per-field docs)."""
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):
        return {}
    names = {f.name for f in dataclasses.fields(cls)}
    out: Dict[str, str] = {}
    pending: List[str] = []
    for line in src.splitlines():
        m = _COMMENT_RE.match(line)
        if m:
            pending.append(m.group(1).rstrip())
            continue
        fm = _FIELD_RE.match(line)
        if fm and fm.group(1) in names:
            if pending:
                out[fm.group(1)] = " ".join(pending).strip()
            pending = []
            continue
        if line.strip():  # any other code breaks the comment run
            pending = []
    return out


# the documented wire names come from the SAME helper the serializer uses,
# so they cannot drift from what the wire actually accepts
from grove_tpu_torch.api.serialize import _camel  # noqa: E402


# ---------------------------------------------------------------------------
# Type rendering + reachability walk
# ---------------------------------------------------------------------------


def _render_type(hint: Any, refs: List[type]) -> str:
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        inner = ", ".join(_render_type(a, refs) for a in args)
        return f"optional {inner}" if len(args) == 1 else f"union[{inner}]"
    if origin in (list, typing.List):
        (item,) = typing.get_args(hint) or (Any,)
        return f"list of {_render_type(item, refs)}"
    if origin in (dict, typing.Dict):
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is not Any:
            return f"map of string → {_render_type(args[1], refs)}"
        return "object (free-form)"
    if dataclasses.is_dataclass(hint):
        if hint not in refs:
            refs.append(hint)
        return f"[{hint.__name__}](#{hint.__name__.lower()})"
    if hint is Any:
        return "any"
    if hint is type(None):
        return "null"
    return {bool: "boolean", int: "integer", float: "number", str: "string"}.get(
        hint, getattr(hint, "__name__", str(hint))
    )


def _render_default(f: dataclasses.Field) -> str:
    if f.default is not dataclasses.MISSING:
        if f.default is None:
            return ""
        if isinstance(f.default, str):
            return f"`{f.default}`" if f.default else '`""`'
        return f"`{f.default}`"
    if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
        try:
            v = f.default_factory()  # type: ignore[misc]
        except Exception:
            return ""
        # nested objects and long structured defaults are documented by their
        # own tables; inlining the repr would be noise
        if dataclasses.is_dataclass(v) or len(repr(v)) > 40:
            return ""
        if v in ({}, [], ()):  # empty containers read better blank
            return ""
        return f"`{v}`"
    return "required"


def _doc_summary(cls: type) -> str:
    doc = inspect.getdoc(cls) or ""
    if doc.startswith(f"{cls.__name__}("):  # dataclass auto-signature, not docs
        return ""
    return doc.strip()


def _render_dataclass(cls: type, refs: List[type]) -> str:
    hints = typing.get_type_hints(cls)
    lines = [f"### {cls.__name__}", ""]
    summary = _doc_summary(cls)
    if summary:
        lines += [summary, ""]
    comments = _field_comments(cls)
    lines += [
        "| Field | Type | Default | Description |",
        "|---|---|---|---|",
    ]
    for f in dataclasses.fields(cls):
        desc = comments.get(f.name, "").replace("|", "\\|")
        lines.append(
            f"| `{_camel(f.name)}` | {_render_type(hints[f.name], refs)}"
            f" | {_render_default(f)} | {desc} |"
        )
    lines.append("")
    return "\n".join(lines)


def _section(
    title: str,
    intro: str,
    roots: List[type],
    skip: Optional[set] = None,
) -> str:
    """Render the roots plus every dataclass transitively reachable from
    their fields, each type documented exactly once, in first-reached order.
    Types in `skip` are linked but rendered elsewhere (the shared section)."""
    skip = skip or set()
    refs: List[type] = list(roots)
    out = [f"## {title}", "", intro, ""]
    i = 0
    while i < len(refs):
        if refs[i] not in skip:
            out.append(_render_dataclass(refs[i], refs))
        i += 1
    return "\n".join(out)


# ---------------------------------------------------------------------------
# The document
# ---------------------------------------------------------------------------


def render_api_reference() -> str:
    from grove_tpu_torch.api.meta import Condition, ObjectMeta
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.types import (
        PodClique,
        PodCliqueScalingGroup,
        PodCliqueSet,
        PodGang,
        Queue,
    )
    from grove_tpu_torch.config.operator import OperatorConfiguration

    header = (
        "# API reference\n\n"
        "Generated from the typed model (`grove-tpu api-docs`); do not edit\n"
        "by hand — regenerate with `grove-tpu api-docs --write"
        " docs/api-reference.md`.\n"
        "Field names are the camelCase wire names accepted in YAML manifests\n"
        "(reference-format manifests load unchanged). Counterpart of the\n"
        "reference's generated API docs"
        " (docs/api-reference/{operator-api,scheduler-api}.md).\n"
    )
    shared_types = {ObjectMeta, Condition}
    operator = _section(
        "Operator API (`grove.io/v1alpha1`)",
        "The user-facing custom resources: `PodCliqueSet` (the one manifest a\n"
        "user writes), its children `PodClique` and `PodCliqueScalingGroup`,\n"
        "and the cluster-scoped `ClusterTopology` hierarchy.",
        [PodCliqueSet, PodClique, PodCliqueScalingGroup, ClusterTopology],
        skip=shared_types,
    )
    scheduler = _section(
        "Scheduler API (`scheduler.grove.io/v1alpha1`)",
        "The gang-scheduling contract consumed by the placement engine (the\n"
        "in-tree TPU solver, the gRPC sidecar, or an external scheduler),\n"
        "plus the cluster-scoped tenant `Queue` of the quota/fair-share\n"
        "subsystem (docs/quota.md).",
        [PodGang, Queue],
        skip=shared_types,
    )
    shared = _section(
        "Shared metadata types",
        "Object metadata and condition types used across both API groups.",
        [ObjectMeta, Condition],
    )
    config = _section(
        "Operator configuration (file API)",
        "The versioned configuration file loaded at operator startup\n"
        "(`grove-tpu run --config`, `grove-tpu config-check`).",
        [OperatorConfiguration],
    )
    return "\n".join([header, operator, scheduler, shared, config])


def write_api_reference(path: str) -> str:
    import pathlib

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(render_api_reference())
    return str(p)
