"""GL010 wire-decodable public API types.

`api/serialize.py::to_dict` and `api/wire.py::decode_dataclass` give the
real-cluster mode its lossless object round trip. The reflective decoder
understands a fixed annotation grammar; a field added to `api/types.py`
outside it (a tuple, a multi-type Union, a non-str-keyed dict) serializes
fine but silently fails — or corrupts — on decode. This rule pins the
grammar statically; tests/test_serialize_roundtrip.py is its runtime twin
(seeded property round trips over every public dataclass).

Checked per dataclass field in api/types.py:
- annotation ∈ {str, int, float, bool, Any, dataclass ref, Optional[T],
  List[T], Dict[str, T]} recursively;
- the field name survives the camelCase round trip
  (snake(camel(name)) == name), or carries a wire alias.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, walk

_SCALARS = {"str", "int", "float", "bool", "Any", "object"}
_FORBIDDEN = {
    "tuple",
    "Tuple",
    "set",
    "Set",
    "frozenset",
    "FrozenSet",
    "bytes",
    "Callable",
    "Iterator",
    "Iterable",
    "Generator",
}


def _camel(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(w.capitalize() for w in rest)


def _snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _is_dataclass_def(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        name = (
            dec.id
            if isinstance(dec, ast.Name)
            else dec.attr
            if isinstance(dec, ast.Attribute)
            else getattr(getattr(dec, "func", None), "id", None)
            or getattr(getattr(dec, "func", None), "attr", None)
        )
        if name == "dataclass":
            return True
    return False


class WireRoundTripRule(Rule):
    id = "GL010"
    name = "wire-roundtrip"
    description = (
        "public API dataclass fields must use the wire-decodable annotation"
        " grammar (scalars, dataclass refs, Optional/List/Dict[str, T])"
        " and camelCase-round-trippable names"
    )
    paths = ("grove_tpu_torch/api/types.py",)

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        local_classes = {
            n.name
            for n in walk(ctx.tree)
            if isinstance(n, ast.ClassDef)
        }
        for node in walk(ctx.tree):
            if not isinstance(node, ast.ClassDef) or not _is_dataclass_def(
                node
            ):
                continue
            for stmt in node.body:
                if not isinstance(stmt, ast.AnnAssign) or not isinstance(
                    stmt.target, ast.Name
                ):
                    continue
                fname = stmt.target.id
                if fname.startswith("_") or fname == "kind":
                    continue
                problem = self._check_annotation(
                    stmt.annotation, local_classes
                )
                if problem is not None:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=stmt.lineno,
                        col=stmt.col_offset,
                        message=(
                            f"{node.name}.{fname}: {problem} — the"
                            " api/wire.py decoder cannot round-trip it"
                        ),
                    )
                if _snake(_camel(fname)) != fname:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=stmt.lineno,
                        col=stmt.col_offset,
                        message=(
                            f"{node.name}.{fname}: field name does not"
                            " survive the camelCase round trip"
                            f" ({_camel(fname)} -> {_snake(_camel(fname))})"
                            " — rename or add a wire alias in"
                            " api/wire.py::_FIELD_ALIASES"
                        ),
                    )

    def _check_annotation(
        self, ann: ast.AST, local: set
    ) -> Optional[str]:
        # string forward refs: re-parse
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return f"unparseable forward reference {ann.value!r}"
        if isinstance(ann, ast.Name):
            if ann.id in _FORBIDDEN:
                return f"type `{ann.id}` is outside the wire grammar"
            if ann.id in _SCALARS or ann.id in local:
                return None
            # imported dataclass refs (ObjectMeta, Condition, ...) pass:
            # conventionally UpperCamelCase types
            if ann.id[:1].isupper():
                return None
            return f"type `{ann.id}` is outside the wire grammar"
        if isinstance(ann, ast.Attribute):
            return None  # module-qualified dataclass ref
        if isinstance(ann, ast.Subscript):
            base = ann.value
            base_name = (
                base.id
                if isinstance(base, ast.Name)
                else base.attr
                if isinstance(base, ast.Attribute)
                else ""
            )
            args = (
                list(ann.slice.elts)
                if isinstance(ann.slice, ast.Tuple)
                else [ann.slice]
            )
            if base_name in ("Optional",):
                return self._check_annotation(args[0], local)
            if base_name in ("List", "list"):
                return self._check_annotation(args[0], local)
            if base_name in ("Dict", "dict"):
                key = args[0]
                if not (isinstance(key, ast.Name) and key.id == "str"):
                    return "Dict keys must be `str` on the wire"
                return self._check_annotation(args[1], local)
            if base_name == "Union":
                non_none = [
                    a
                    for a in args
                    if not (
                        isinstance(a, ast.Constant) and a.value is None
                    )
                    and not (isinstance(a, ast.Name) and a.id == "None")
                ]
                if len(non_none) > 1:
                    return (
                        "multi-type Union is undecodable (the decoder"
                        " picks the first member)"
                    )
                return self._check_annotation(non_none[0], local)
            if base_name in _FORBIDDEN:
                return f"type `{base_name}[...]` is outside the wire grammar"
            return f"unsupported generic `{base_name}[...]`"
        return "unsupported annotation shape"
