"""One package's control-plane names, for the durability and parallel-drain
tests that run the same scenario through both packages.

``cp_side("grove_tpu")`` and ``cp_side("grove_tpu_torch")`` give the same
names from either package: the store, clock, engine, API types, durability
layer, ``sim/recovery``, ``sim/parallel``, ``sim/scale``, the metrics and
events singletons and ``resource_signature`` (``sim/chaos`` in both
packages). ``harness(**kw)`` and
``kw`` give the side's ``SimHarness`` and the keyword arguments its sim
functions need (``device="cpu"`` on the port's side).
"""

from __future__ import annotations

import functools
import importlib
import types


@functools.lru_cache(maxsize=None)
def cp_side(root: str) -> types.SimpleNamespace:
    def module(path: str):
        return importlib.import_module(f"{root}.{path}")

    port = root == "grove_tpu_torch"
    kw = {"device": "cpu"} if port else {}
    recovery = module("sim.recovery")
    harness_cls = module("sim.harness").SimHarness
    return types.SimpleNamespace(
        root=root,
        kw=kw,
        SimHarness=harness_cls,
        harness=functools.partial(harness_cls, **kw),
        Store=module("runtime.store").Store,
        commit_status=module("runtime.store").commit_status,
        Clock=module("runtime.clock").Clock,
        VirtualClock=module("runtime.clock").VirtualClock,
        Engine=module("runtime.engine").Engine,
        Controller=module("runtime.engine").Controller,
        continue_reconcile=module("runtime.flow").continue_reconcile,
        shard_of=module("runtime.shards").shard_of,
        GroveError=module("runtime.errors").GroveError,
        ObjectMeta=module("api.meta").ObjectMeta,
        deep_copy=module("api.meta").deep_copy,
        reset_uid_namespace=module("api.meta").reset_uid_namespace,
        is_ready=module("api.pod").is_ready,
        load_podcliquesets=module("api.load").load_podcliquesets,
        LABEL_PODGANG=module("api.names").LABEL_PODGANG,
        types=module("api.types"),
        OperatorContext=module("controller.common").OperatorContext,
        durability=module("durability"),
        wal=module("durability.wal"),
        snapshot=module("durability.snapshot"),
        recovery=recovery,
        store_dump=recovery.store_dump,
        resource_signature=module("sim.chaos").resource_signature,
        parallel=module("sim.parallel"),
        scale=module("sim.scale"),
        METRICS=module("observability.metrics").METRICS,
        EVENTS=module("observability.events").EVENTS,
        TRACER=module("observability.tracing").TRACER,
    )


SIDES = ("grove_tpu", "grove_tpu_torch")


def fresh(side) -> None:
    """A fresh uid namespace, metrics and events on one side (uids carry
    their counter, so equal counters give equal wire lengths)."""
    side.reset_uid_namespace()
    side.METRICS.reset()
    side.EVENTS.reset()


def both(run) -> list:
    """``run(side)`` on the JAX side, then the port's, each fresh."""
    out = []
    for root in SIDES:
        side = cp_side(root)
        fresh(side)
        out.append(run(side))
    return out
