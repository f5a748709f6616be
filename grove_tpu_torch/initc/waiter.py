"""Pod-side startup-ordering waiter (grove-initc equivalent).

Counterpart of ``grove_tpu/initc/waiter.py``.

Re-host of reference operator/initc/internal/wait.go:110-275: an init
step that blocks the pod's main containers until every parent clique has at
least minAvailable Ready pods. Like the reference, it observes only pods
carrying its own `grove.io/podgang` label (the downward-API-provided gang
name, wait.go:76-90) and maps pods to parent cliques by name prefix
(wait.go:240-265).

In the simulator the kubelet calls `is_ready_to_start` each tick instead of
running a blocking informer; `Waiter` keeps the blocking-CLI shape for a real
deployment (it polls the same predicate).
"""

from __future__ import annotations

import sys
from typing import Dict, List

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.api.pod import is_ready
from grove_tpu_torch.runtime.errors import ERR_TRANSPORT, GroveError
from grove_tpu_torch.runtime.store import Store


def parent_ready_counts(
    store: Store, namespace: str, podgang: str, parent_pclqs: List[str]
) -> Dict[str, int]:
    pods = store.list("Pod", namespace, {namegen.LABEL_PODGANG: podgang})
    counts = {p: 0 for p in parent_pclqs}
    for pod in pods:
        if not is_ready(pod):
            continue
        # exact pod→clique mapping via the podclique label (the reference
        # prefix-matches, wait.go:240-265, but picks exactly one parent;
        # the label avoids prefix collisions between clique names)
        parent = pod.metadata.labels.get(namegen.LABEL_PODCLIQUE)
        if parent in counts:
            counts[parent] += 1
    return counts


def is_ready_to_start(store: Store, namespace: str, waiter_config: Dict) -> bool:
    """waiter_config = {"podcliques": [{"pclq": fqn, "min_available": n}...],
    "podgang": name} — the initcontainer args contract
    (initc/cmd/opts/options.go)."""
    deps = waiter_config.get("podcliques", [])
    if not deps:
        return True
    podgang = waiter_config.get("podgang", "")
    counts = parent_ready_counts(
        store, namespace, podgang, [d["pclq"] for d in deps]
    )
    return all(counts[d["pclq"]] >= int(d["min_available"]) for d in deps)


class Waiter:
    """Blocking form for real-pod usage: poll until ready (wait.go:110-164)."""

    def __init__(self, store: Store, namespace: str, waiter_config: Dict) -> None:
        self.store = store
        self.namespace = namespace
        self.config = waiter_config

    def wait(self, poll_interval: float = 1.0, timeout: float = 3600.0) -> bool:
        # wall-clock deadline, NOT an iteration count: a black-holed
        # apiserver makes each probe itself block for the transport timeout,
        # and counting only sleep intervals would overshoot `timeout` by the
        # ratio of the two
        deadline = self.store.clock.now() + timeout
        while True:
            if ready_or_transport_down(self.store, self.namespace, self.config):
                return True
            if self.store.clock.now() >= deadline:
                return False
            self.store.clock.sleep(poll_interval)


def ready_or_transport_down(store: Store, namespace: str, config: Dict) -> bool:
    """is_ready_to_start, surviving TRANSIENT apiserver outages: transport
    failures read as not-ready-yet (retry until the caller's deadline — the
    reference's informer client reconnects the same way); every other error
    (forbidden, not found, bad request) is permanent and re-raises so the
    init container fails fast with the real diagnosis."""
    try:
        return is_ready_to_start(store, namespace, config)
    except GroveError as e:
        if e.code != ERR_TRANSPORT:
            raise
        print(
            f"grove-tpu-initc: apiserver unavailable ({e.code}); retrying",
            file=sys.stderr,
        )
        return False
