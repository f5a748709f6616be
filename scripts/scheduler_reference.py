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

    JAX_PLATFORMS=cpu python scripts/scheduler_reference.py [s] [q] [r]

A world can be cut for a quick look: ``--nodes N --gangs G``.
"""

from __future__ import annotations

import argparse
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("worlds", nargs="*", default=["s", "q", "r"])
    parser.add_argument("--nodes", type=int, default=None)
    parser.add_argument("--gangs", type=int, default=None)
    args = parser.parse_args()
    out = {"jax": jax.__version__, "backend": jax.default_backend()}
    for name in args.worlds:
        out[name] = run_world(name, args.nodes, args.gangs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
