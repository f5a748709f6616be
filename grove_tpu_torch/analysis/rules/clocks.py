"""GL001 virtual-clock discipline + GL008 non-blocking reconcile bodies.

Determinism is what makes `make chaos-matrix` replayable and the bench
A/Bs honest: everything the sim/solver/control plane does must run on the
injectable clock (runtime/clock.py) and seeded RNGs. The real-cluster
paths (cluster/lease.py, cluster/cert.py, cluster/manager.py,
utils/platform.py) legitimately read wall time and are out of scope.
`time.perf_counter`/`time.monotonic` are deliberately allowed: they
measure real latency (tracing, metrics) without steering simulated-time
logic.

EXCEPT in the strict-scope files (``sim/traffic.py``): a traffic trace
must replay bit-identically from its seed, so not even a latency
measurement may read the wall — the SLO observatory's windowed numbers
(and `make serving-smoke`'s breach schedule) are only reproducible if
the generator is a pure function of (seed, virtual time).
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

_BANNED_TIME_ATTRS = {"time", "sleep"}
# additionally banned in the strict scope (pure seed+virtual-time files)
_STRICT_TIME_ATTRS = {"time", "sleep", "perf_counter", "monotonic",
                      "monotonic_ns", "perf_counter_ns", "time_ns"}
_SEEDED_RNG_CTORS = {"Random", "default_rng", "RandomState", "SystemRandom"}
_DATETIME_ATTRS = {"now", "utcnow", "today"}


class _ImportTracker(ast.NodeVisitor):
    """Module aliases in one file: which local names are `time`, `random`,
    `numpy`, `datetime` (handles `import time as _time` etc.)."""

    def __init__(self) -> None:
        self.time: Set[str] = set()
        self.random: Set[str] = set()
        self.numpy: Set[str] = set()
        self.datetime: Set[str] = set()
        # names imported FROM those modules (from time import sleep)
        self.from_time: Set[str] = set()
        self.from_time_strict: Set[str] = set()  # perf_counter/monotonic
        self.from_random: Set[str] = set()

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            local = alias.asname or alias.name.split(".")[0]
            if alias.name == "time":
                self.time.add(local)
            elif alias.name == "random":
                self.random.add(local)
            elif alias.name in ("numpy", "numpy.random"):
                self.numpy.add(local)
            elif alias.name == "datetime":
                self.datetime.add(local)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for alias in node.names:
            local = alias.asname or alias.name
            if node.module == "time" and alias.name in _BANNED_TIME_ATTRS:
                self.from_time.add(local)
            elif node.module == "time" and alias.name in _STRICT_TIME_ATTRS:
                self.from_time_strict.add(local)
            elif node.module == "random":
                self.from_random.add(local)
            elif node.module == "datetime" and alias.name == "datetime":
                self.datetime.add(local)


class ClockDisciplineRule(Rule):
    id = "GL001"
    name = "wall-clock"
    description = (
        "sim/solver/controller/runtime/disruption/quota code must use the"
        " injectable clock and seeded RNGs — no time.time()/time.sleep(),"
        " unseeded random, numpy global RNG, or datetime.now()"
    )
    paths = (
        "grove_tpu_torch/sim/",
        "grove_tpu_torch/solver/",
        "grove_tpu_torch/controller/",
        "grove_tpu_torch/runtime/",
        "grove_tpu_torch/disruption/",
        "grove_tpu_torch/quota/",
        "grove_tpu_torch/observability/forecast.py",
    )
    # strict scope: bit-replayable generators — even perf_counter/
    # monotonic are wall reads there (the serving traffic trace must be a
    # pure function of seed + virtual time; the forecaster is pinned
    # bit-equal to a NumPy oracle over that same virtual timeline)
    strict_paths = (
        "grove_tpu_torch/sim/traffic.py",
        "grove_tpu_torch/observability/forecast.py",
    )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        imports = _ImportTracker()
        imports.visit(ctx.tree)
        strict = ctx.rel in self.strict_paths
        for node in walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = self._classify(node, imports, strict)
            if msg is not None:
                yield Violation(
                    rule=self.id,
                    path=ctx.rel,
                    line=node.lineno,
                    col=node.col_offset,
                    message=msg,
                )

    def _classify(
        self, node: ast.Call, imports: _ImportTracker, strict: bool = False
    ):
        banned_attrs = _STRICT_TIME_ATTRS if strict else _BANNED_TIME_ATTRS
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value
            # time.time() / time.sleep() (any alias of the time module)
            if (
                isinstance(base, ast.Name)
                and base.id in imports.time
                and fn.attr in banned_attrs
            ):
                return (
                    f"wall-clock call `{dotted(fn)}()` — use the injectable"
                    " Clock (store.clock / harness clock) so virtual-time"
                    " runs stay deterministic"
                    + (
                        " (STRICT scope: traffic traces must replay"
                        " bit-identically, even latency reads are banned)"
                        if strict and fn.attr not in _BANNED_TIME_ATTRS
                        else ""
                    )
                )
            # random.<fn>() — only seeded constructors with args pass
            if isinstance(base, ast.Name) and base.id in imports.random:
                if fn.attr in _SEEDED_RNG_CTORS and (
                    node.args or node.keywords
                ):
                    return None
                return (
                    f"unseeded/global RNG `{dotted(fn)}()` — construct a"
                    " seeded random.Random(seed) instead"
                )
            # np.random.<fn>()
            if (
                isinstance(base, ast.Attribute)
                and base.attr == "random"
                and isinstance(base.value, ast.Name)
                and base.value.id in imports.numpy
            ):
                if fn.attr in _SEEDED_RNG_CTORS and (
                    node.args or node.keywords
                ):
                    return None
                return (
                    f"numpy global RNG `{dotted(fn)}()` — use"
                    " np.random.default_rng(seed)"
                )
            # datetime.now()/utcnow()/today() — the base must resolve to an
            # imported datetime module/class (aliases included), so a local
            # variable that happens to be named `datetime` is not flagged
            if fn.attr in _DATETIME_ATTRS:
                root = dotted(base)
                head, _, tail = root.partition(".")
                if head in imports.datetime and tail in ("", "datetime"):
                    return (
                        f"wall-clock call `{dotted(fn)}()` — derive"
                        " timestamps from the injectable Clock"
                    )
        elif isinstance(fn, ast.Name):
            if fn.id in imports.from_time or (
                strict and fn.id in imports.from_time_strict
            ):
                return (
                    f"wall-clock call `{fn.id}()` (imported from time) —"
                    " use the injectable Clock"
                )
            if fn.id in imports.from_random:
                if fn.id in _SEEDED_RNG_CTORS and (node.args or node.keywords):
                    return None
                return (
                    f"unseeded RNG `{fn.id}()` (imported from random) —"
                    " construct a seeded random.Random(seed)"
                )
        return None


_TICK_IO_ROOTS = {"socket", "subprocess", "requests", "urllib", "http"}


class BlockingTickRule(Rule):
    id = "GL008"
    name = "blocking-tick"
    description = (
        "reconcile/sync/tick bodies must not block: no sleep, socket,"
        " subprocess, HTTP, or open() inside a controller round"
    )
    paths = (
        "grove_tpu_torch/controller/",
        "grove_tpu_torch/runtime/",
        "grove_tpu_torch/disruption/",
        "grove_tpu_torch/solver/scheduler.py",
        "grove_tpu_torch/autoscale/",
    )

    @staticmethod
    def _is_tick_fn(name: str) -> bool:
        return (
            name in ("reconcile", "sync", "tick")
            or name.endswith("_tick")
            or name.startswith("tick_")
            or "reconcile" in name
        )

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        for fn in ctx.functions():
            if not self._is_tick_fn(fn.name):
                continue
            for node in walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._classify(node)
                if msg is not None:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=f"{msg} inside `{fn.name}()` — controller"
                        " rounds must stay non-blocking (requeue instead)",
                    )

    @staticmethod
    def _classify(node: ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id == "open":
            return "blocking file I/O `open()`"
        if isinstance(fn, ast.Attribute):
            src = dotted(fn)
            root = src.split(".", 1)[0]
            if root in _TICK_IO_ROOTS:
                return f"blocking I/O `{src}()`"
            # any .sleep() that is not the injectable clock's
            if fn.attr == "sleep" and "clock" not in src.lower():
                return f"blocking `{src}()`"
        return None
