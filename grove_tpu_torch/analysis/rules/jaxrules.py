"""GL005 torch hygiene inside the port's device regions.

Counterpart of the JAX package's jit-hygiene rule (same module name, same
id). The port has no ``jax.jit``; its device regions are the functions
PyTorch traces or re-dispatches:

- functions registered with ``torch.library`` (``@torch.library.custom_op``,
  ``@torch.library.register_*``) and the rules registered on such an
  operator (``@op.register_vmap``, ``register_fake``, ``register_kernel``,
  ``register_autograd``);
- functions called under ``torch.func.vmap`` (``vmap(fn)(...)``: ``fn`` is
  resolved by name in the same file), and lambdas passed to it.

Inside them, and everything nested inside them, it flags:

- **Python side effects**: ``print(...)`` and ``global`` mutation (vmap
  runs the body once for every lane at once, an operator's rule once per
  dispatch, not once per value);
- **dtype creep**: a ``float64`` dtype or literal (the float32 contract
  the kernels' plain versions and the JAX reference are held to);
- **host syncs**: ``.item()``, ``.tolist()``, ``.cpu()`` and
  ``torch.cuda.synchronize`` each wait for the card inside a region that
  should only queue work on it;
- **wall-clock calls** (``time.*``).

Anywhere in those files it also flags a CUDA extension built or loaded at
module import (``_build.load``/``load_all``, ``torch.utils.cpp_extension``,
``ctypes.CDLL``, ``torch.ops.load_library``) and a module-level ``triton``
import: the port builds its kernels at first use, so every module imports
on a machine without ``nvcc``, ``triton`` or a card.

Scope: ``ops/``, ``solver/kernel.py``, ``quota/ordering.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, List, Set, Tuple

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, call_name, dotted, walk

# decorators on an operator object that register a rule of that operator
_OP_REGISTRATIONS = {
    "register_vmap",
    "register_fake",
    "register_kernel",
    "register_autograd",
    "register_torch_dispatch",
}
# calls that build or load a CUDA library
_LOADERS = {"load_all", "load_inline", "CDLL", "LoadLibrary", "load_library"}
_HOST_SYNCS = {"item", "tolist", "cpu"}


def _is_torch_library_decorator(dec: ast.AST) -> bool:
    """torch.library.custom_op(...) / torch.library.register_*(...) /
    <op>.register_vmap (and the other per-operator registrations)."""
    name = dotted(dec.func if isinstance(dec, ast.Call) else dec)
    if name.startswith("torch.library.") or name.startswith("library."):
        return True
    return name.rsplit(".", 1)[-1] in _OP_REGISTRATIONS


def _is_vmap(node: ast.Call) -> bool:
    return dotted(node.func).rsplit(".", 1)[-1] == "vmap"


def _module_level(tree: ast.Module) -> Iterator[ast.AST]:
    """Every node that runs when the module is imported: not inside a
    function or a lambda (class bodies run at import too)."""
    todo: List[ast.AST] = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # decorators and defaults run at import, the body does not
            todo.extend(getattr(node, "decorator_list", ()))
            todo.extend(node.args.defaults)
            todo.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        yield node
        todo.extend(ast.iter_child_nodes(node))


class JitHygieneRule(Rule):
    id = "GL005"
    name = "torch-hygiene"
    description = (
        "torch.library operators and vmapped functions must be pure float32"
        " device code: no print/global, no float64, no host syncs (.item/"
        ".tolist/.cpu/torch.cuda.synchronize) or wall clock; no CUDA"
        " extension built or loaded at import"
    )
    paths = (
        "grove_tpu_torch/ops/",
        "grove_tpu_torch/solver/kernel.py",
        "grove_tpu_torch/quota/ordering.py",
    )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for node in _module_level(ctx.tree):
            msg = self._import_time(node)
            if msg is not None:
                yield Violation(self.id, ctx.rel, node.lineno, node.col_offset,
                                f"{msg} at module import (build kernels at first use)")
        seen: Set[int] = set()
        for region, what in self._regions(ctx):
            for node in walk(region):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                msg = self._classify(node)
                if msg is not None:
                    yield Violation(self.id, ctx.rel, node.lineno, node.col_offset,
                                    f"{msg} inside {what}")

    @staticmethod
    def _regions(ctx: FileContext) -> List[Tuple[ast.AST, str]]:
        by_name: Dict[str, List[ast.AST]] = {}
        regions: List[Tuple[ast.AST, str]] = []
        for fn in ctx.functions():
            by_name.setdefault(fn.name, []).append(fn)
            if any(_is_torch_library_decorator(d) for d in fn.decorator_list):
                regions.append((fn, f"torch.library function `{fn.name}()`"))
        for node in walk(ctx.tree):
            if not (isinstance(node, ast.Call) and _is_vmap(node) and node.args):
                continue
            target = node.args[0]
            if isinstance(target, ast.Lambda):
                regions.append((target, "a vmapped lambda"))
            elif isinstance(target, ast.Name):
                for fn in by_name.get(target.id, ()):
                    regions.append((fn, f"vmapped `{fn.name}()`"))
        return regions

    @staticmethod
    def _import_time(node: ast.AST):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "triton" for a in node.names):
                return "`import triton`"
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "triton":
                return "`from triton import ...`"
        elif isinstance(node, ast.Call):
            src, name = dotted(node.func), call_name(node)
            if name in _LOADERS or (
                name == "load" and ("_build" in src or "cpp_extension" in src)
            ):
                return f"CUDA extension build or load `{src}()`"
        return None

    @staticmethod
    def _classify(node: ast.AST):
        if isinstance(node, ast.Global):
            return "`global` mutation (a host side effect)"
        if isinstance(node, ast.Constant) and node.value == "float64":
            return "'float64' dtype literal (float32 contract)"
        if isinstance(node, ast.Attribute) and node.attr == "float64":
            return f"`{dotted(node)}` dtype (float32 contract)"
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "print":
                return "`print()` (a host side effect)"
            if isinstance(fn, ast.Attribute):
                src = dotted(fn)
                if fn.attr in _HOST_SYNCS:
                    return f"`.{fn.attr}()` host sync"
                if src.endswith("cuda.synchronize"):
                    return f"`{src}()` host sync"
                if src.startswith("time."):
                    return f"wall-clock `{src}()`"
        return None
