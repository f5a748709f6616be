"""GL020 process-boundary (docs/control-plane.md §5).

The worker-process control plane (runtime/procworkers.py) crosses its
process boundary ONLY through the wire codec: JSON envelopes over
``Connection.send_bytes``/``recv_bytes``. That is a semantic contract,
not a style preference — pickling a store object onto the channel would
ship live references (clock, subscriber lists, lock state) whose
unpickled twins silently diverge from the coordinator's, and the
serial-twin bit-identity argument (tests/test_procworkers.py) would rot
into "usually identical". The boundary also carries the durability
story: WAL records written by a worker must be byte-identical to the
serial run's, which only the deterministic wire encoding guarantees.

Scope: any module that imports ``multiprocessing`` owns a process
boundary, and inside it:

- ``import pickle`` / ``marshal`` / ``dill`` / ``shelve`` (and
  ``from pickle import ...``) are flagged — object serialization on a
  boundary module bypasses the codec (runtime/store.py's in-process
  canonical blobs are fine: that module never forks);
- ``conn.send(...)`` / ``conn.recv()`` — the PICKLING Connection
  methods — are flagged; the codec path is ``send_bytes``/
  ``recv_bytes`` around an explicit encode/decode;
- ``multiprocessing.Queue``/``SimpleQueue``/``JoinableQueue``/
  ``Manager``/``Pool`` are flagged: each is a transparently-pickling
  channel, invisible to the codec discipline.

A second tooth is tree-wide (like GL018's privacy tooth): the process
drain's channel/generation state (``_procs``/``_conns``/``_log``/
``_cursors``/``_rings``/``_ring_gate``/``_dead``/``_gen_active``/
``_epoch``) reached through a drain/workers-named binding takes no
foreign writer — a foreign ``_conns`` poke could tear a round's frame
sequence mid-generation. The documented chaos hook
(``chaos_kill_worker``) and the public surface (``enable_workers``,
``drain``, ``stats``, ``close``) pass anywhere.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from grove_tpu_torch.analysis.engine import FileContext, Rule, Violation, dotted, walk

_BANNED_IMPORTS = {"pickle", "marshal", "dill", "shelve", "cPickle"}
_PICKLING_CHANNEL_CTORS = {
    "Queue",
    "SimpleQueue",
    "JoinableQueue",
    "Manager",
    "Pool",
}
_PICKLING_CONN_METHODS = {"send", "recv"}
# the process drain's channel/generation privates (runtime/procworkers.py
# owns them; reached through a drain/workers-named binding elsewhere they
# accept no foreign writer)
_DRAIN_PRIVATE = {
    "_procs",
    "_conns",
    "_log",
    "_cursors",
    "_rings",
    "_ring_gate",
    "_dead",
    "_gen_active",
    "_epoch",
}
_DRAIN_OWNER = "grove_tpu_torch/runtime/procworkers.py"


def _mp_aliases(tree: ast.AST) -> Set[str]:
    """Local names bound to the multiprocessing module (handles `import
    multiprocessing as mp` and `get_context()` results are still reached
    via attribute calls on these)."""
    names: Set[str] = set()
    for node in walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == "multiprocessing":
                    names.add(alias.asname or "multiprocessing")
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "multiprocessing":
                names.add("")  # marks the file as boundary-owning
    return names


class ProcessBoundaryRule(Rule):
    id = "GL020"
    name = "process-boundary"
    description = (
        "a module that forks worker processes crosses the boundary only"
        " through the wire codec: no pickle/marshal imports, no pickling"
        " Connection.send/recv (use send_bytes/recv_bytes around an"
        " explicit encode/decode), no transparently-pickling"
        " multiprocessing channels (Queue/Manager/Pool)"
    )
    # repo-wide: ANY module may decide to fork; the moment it imports
    # multiprocessing it inherits the codec discipline
    paths = ("grove_tpu_torch/",)
    exclude = ()

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        if ctx.rel != _DRAIN_OWNER:
            for node in walk(ctx.tree):
                if not isinstance(node, ast.Attribute):
                    continue
                base = dotted(node.value)
                leaf = (base.split(".")[-1] if base else "").lower()
                if node.attr in _DRAIN_PRIVATE and (
                    "drain" in leaf or "workers" in leaf
                ):
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"process-drain private `{base}.{node.attr}`"
                            " touched outside runtime/procworkers.py"
                            " (GL020 process-boundary) — the channel/"
                            "generation state takes no foreign writer;"
                            " go through the public drain API"
                        ),
                    )
        mp_names = _mp_aliases(ctx.tree)
        if not mp_names:
            return
        for node in walk(ctx.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = (
                    [a.name for a in node.names]
                    if isinstance(node, ast.Import)
                    else [node.module or ""]
                )
                for mod in mods:
                    if mod.split(".")[0] in _BANNED_IMPORTS:
                        yield Violation(
                            rule=self.id,
                            path=ctx.rel,
                            line=node.lineno,
                            col=node.col_offset,
                            message=(
                                f"`{mod}` imported in a process-boundary"
                                " module (GL020 process-boundary,"
                                " docs/control-plane.md §5) — objects"
                                " cross the worker boundary only through"
                                " the wire codec (api/wire.py +"
                                " durability envelopes)"
                            ),
                        )
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                base = dotted(node.func.value)
                root = base.split(".")[0] if base else ""
                attr = node.func.attr
                if attr in _PICKLING_CHANNEL_CTORS and root in mp_names:
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"`{base}.{attr}(...)` is a transparently-"
                            "pickling channel (GL020 process-boundary) —"
                            " worker traffic goes over Pipe connections"
                            " as wire-codec bytes"
                            " (send_bytes/recv_bytes)"
                        ),
                    )
                elif attr in _PICKLING_CONN_METHODS and (
                    "conn" in (base.split(".")[-1] if base else "").lower()
                ):
                    yield Violation(
                        rule=self.id,
                        path=ctx.rel,
                        line=node.lineno,
                        col=node.col_offset,
                        message=(
                            f"`{base}.{attr}(...)` pickles its argument"
                            " onto the process channel (GL020"
                            " process-boundary) — encode explicitly and"
                            f" use {attr}_bytes"
                        ),
                    )
