"""The JAX package's scheduler rounds for the port's check on the card.

Builds each scheduler world of ``grove_tpu_torch.models.scenarios``
(``scheduler_world``: (s) flat, (q) fair-share, (r) preemption + reclaim)
from its wire documents into a ``grove_tpu.runtime.store.Store`` and a
``grove_tpu.sim.cluster.SimCluster`` (documents decoded with
``grove_tpu.api.wire.decode_object``), with a ``VirtualClock`` frozen at 0,
and runs its rounds through the JAX ``GangScheduler`` from scratch (a bare
scheduler: no delta state, no broker, no monitor). For every round it
prints ``round_summary``: admitted gangs, bound pods, the placement score
sum, the sha256 of the sorted ``ns/pod=node`` bindings, the evicted gangs,
admitted gangs per queue and event counts by reason. ``chip_smoke.py``
holds the port's rounds on the card against these numbers (its
``JAX_SCHEDULER_REFERENCE``). Run on the CPU, one world at a time or all:

    JAX_PLATFORMS=cpu python scripts/scheduler_reference.py [s] [q] [r] [delta]

``delta`` is the churn world: (q)'s round, then its churn ticks
(``scheduler_world("delta")``, ``apply_tick`` with the JAX decoder), through
a JAX ``GangScheduler`` with ``enable_delta()`` and ``delta_selfcheck`` on
every round. Per round it also prints the delta counters, the crc32 of the
free-capacity matrix (``state_fingerprint()[2]``) and the sha256 of the
whole ``state_fingerprint()``; ``chip_smoke.py`` holds the port's delta
rounds to them (``JAX_DELTA_REFERENCE``).

``frontier`` is (phi), the partitioned frontier's world
(``scheduler_world("frontier")``: the churn world with 16 ticks) through a
JAX ``GangScheduler`` with ``enable_delta()``, ``enable_frontier()``,
``delta_selfcheck`` and ``frontier_selfcheck`` on every round. Per round it
prints what ``delta`` prints and the deterministic fields of the frontier
state's ``stats()`` (``frontier_counters``); ``chip_smoke.py`` holds the
port's frontier rounds to them (``JAX_FRONTIER_REFERENCE``).

A world can be cut for a quick look: ``--nodes N --gangs G`` (and
``--ticks T --seed S`` for ``delta``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from grove_tpu.api.topology import ClusterTopology  # noqa: E402
from grove_tpu.api.wire import decode_object  # noqa: E402
from grove_tpu.observability.events import EVENTS  # noqa: E402
from grove_tpu.runtime.clock import VirtualClock  # noqa: E402
from grove_tpu.runtime.store import Store  # noqa: E402
from grove_tpu.sim.cluster import SimCluster, make_nodes  # noqa: E402
from grove_tpu.solver.scheduler import GangScheduler  # noqa: E402
from grove_tpu_torch.models.scenarios import (  # noqa: E402
    EventCapture,
    apply_tick,
    delta_counters,
    frontier_counters,
    round_summary,
    scheduler_world,
)


def run_world(name: str, n_nodes=None, n_gangs=None) -> list:
    world = scheduler_world(name, n_nodes, n_gangs)
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store=store, nodes=make_nodes(*world["nodes"]))
    scheduler = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"])
    assert scheduler.delta is None and scheduler.broker is None and scheduler.monitor is None
    for doc in world["queues"]:
        store.create(decode_object(doc))
    rounds = []
    for docs in world["rounds"]:
        for doc in docs:
            store.create(decode_object(doc))
        t0 = time.perf_counter()
        with EventCapture(EVENTS) as cap:
            scheduler.schedule_pending()
        summary = round_summary(store, cluster, cap.events)
        summary["seconds"] = time.perf_counter() - t0
        print(f"[{name}] round {len(rounds) + 1}: {json.dumps(summary)}", file=sys.stderr,
              flush=True)
        rounds.append(summary)
    return rounds


def delta_state(delta) -> dict:
    """The delta counters, the free matrix's crc32 and the sha256 of the
    whole state fingerprint after a round."""
    fp = delta.state_fingerprint()
    return {"counters": delta_counters(delta), "free_crc": fp[2],
            "state_sha256": hashlib.sha256(repr(fp).encode()).hexdigest()}


def run_delta(n_nodes=None, n_gangs=None, ticks=None, seed=0, frontier=False) -> list:
    name = "frontier" if frontier else "delta"
    world = scheduler_world(name, n_nodes, n_gangs, ticks, seed)
    store = Store(VirtualClock(0.0))
    cluster = SimCluster(store=store, nodes=make_nodes(*world["nodes"]))
    scheduler = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"])
    assert scheduler.enable_delta()
    scheduler.delta_selfcheck = True
    if frontier:
        assert scheduler.enable_frontier()
        scheduler.frontier_selfcheck = True
    for doc in world["queues"] + world["rounds"][0]:
        store.create(decode_object(doc))
    rounds = []
    for tick in [None] + world["ticks"]:
        if tick:
            apply_tick(store, cluster, tick, decode_object)
        t0 = time.perf_counter()
        with EventCapture(EVENTS) as cap:
            scheduler.schedule_pending()
        summary = round_summary(store, cluster, cap.events)
        summary.update(delta_state(scheduler.delta))
        if frontier:
            summary["frontier"] = frontier_counters(scheduler.frontier)
        summary["seconds"] = time.perf_counter() - t0
        print(f"[{name}] round {len(rounds) + 1}: {json.dumps(summary)}", file=sys.stderr,
              flush=True)
        rounds.append(summary)
    return rounds


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("worlds", nargs="*", default=["s", "q", "r"])
    parser.add_argument("--nodes", type=int, default=None)
    parser.add_argument("--gangs", type=int, default=None)
    parser.add_argument("--ticks", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    out = {"jax": jax.__version__, "backend": jax.default_backend()}
    for name in args.worlds:
        if name in ("delta", "frontier"):
            out[name] = run_delta(args.nodes, args.gangs, args.ticks, args.seed,
                                  frontier=name == "frontier")
        else:
            out[name] = run_world(name, args.nodes, args.gangs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
