"""External gang scheduler: a KAI stand-in consuming the PodGang contract
over the wire.

Counterpart of ``grove_tpu/cluster/extscheduler.py``. The reference
delegates placement to the out-of-process KAI scheduler, which watches
PodGang CRs and ungated pods and binds them all-or-nothing. This module is
that consumer: a standalone process that speaks only the HTTP wire format,
so drift between the operator's PodGang emission and an external scheduler
shows in tests instead of hiding behind the in-tree solver. It runs the
solver-backed ``GangScheduler`` over an ``HttpStore``: the Store interface
is the contract boundary.

The scheduler solves on ``device``: the card unless the caller passes
another (``device="cpu"``, as the tests do); without CUDA and without a
device ``run_external_scheduler`` raises before it connects. ``main``
probes the card first (``utils/platform.ensure_healthy_backend``), which
raises on an unhealthy card and never falls back to the CPU.

    python -m grove_tpu_torch.cluster.extscheduler --apiserver http://...:PORT
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

# no module-level solver imports: ``main`` probes the card in a child
# process before this process initializes CUDA


def run_external_scheduler(
    apiserver: str,
    nodes: List,
    topology=None,
    priority_map: Optional[Dict[str, int]] = None,
    poll: float = 0.2,
    stop=None,
    kubelet: bool = False,
    solver_sidecar: Optional[str] = None,
    device=None,
) -> None:
    """Blocking scheduler loop against a remote apiserver. `kubelet=True`
    additionally runs the kubelet tick (pods become Ready), for e2e setups
    where this process is the only thing animating the data plane. The
    solves run on `device` (the card unless given)."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.cluster.client import HttpStore
    from grove_tpu_torch.sim.cluster import SimCluster
    from grove_tpu_torch.solver.scheduler import GangScheduler
    from grove_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device)

    store = HttpStore(
        apiserver, watch_kinds=("Pod", "PodGang", "PodClique")
    ).start()
    cluster = SimCluster(store=store, nodes=nodes)
    scheduler = GangScheduler(
        store, cluster, topology or ClusterTopology(),
        priority_map=priority_map or {},
        solver_sidecar=solver_sidecar,
        device=device,
    )
    from grove_tpu_torch.runtime.errors import GroveError

    try:
        while stop is None or not stop.is_set():
            try:
                bound = scheduler.schedule_pending()
                started = cluster.kubelet_tick() if kubelet else 0
            except GroveError as e:
                # conflicts/races with the concurrently-writing operator are
                # normal in a live cluster: re-read next round, never die
                print(f"scheduler round error (retrying): {e}", file=sys.stderr)
                bound = started = 0
            if bound == 0 and started == 0:
                time.sleep(poll)
    finally:
        store.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="grove-tpu-torch-scheduler", description=__doc__
    )
    parser.add_argument("--apiserver", required=True)
    parser.add_argument("--nodes", type=int, default=32)
    parser.add_argument(
        "--kubelet", action="store_true",
        help="also run the kubelet tick (sim data plane)",
    )
    parser.add_argument("--poll-interval", type=float, default=0.2)
    parser.add_argument(
        "--solver-sidecar",
        help="route packing solves through a gRPC gang-solver sidecar"
        " (host:port; see grove_tpu_torch.cluster.grpcsolver)",
    )
    args = parser.parse_args(argv)

    # probe the card in a child first: an unhealthy card raises here
    # instead of hanging the scheduler process
    from grove_tpu_torch.utils.platform import ensure_healthy_backend

    ensure_healthy_backend(timeout_s=45.0)

    from grove_tpu_torch.sim.cluster import make_nodes

    print(
        f"external gang scheduler consuming PodGangs from {args.apiserver}",
        flush=True,
    )
    run_external_scheduler(
        args.apiserver,
        make_nodes(args.nodes),
        poll=args.poll_interval,
        kubelet=args.kubelet,
        solver_sidecar=args.solver_sidecar,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
