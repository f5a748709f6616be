"""grove-tpu-torch-initc: deployable pod-side startup-ordering waiter.

Counterpart of ``grove_tpu/initc/__main__.py``, with its flags, messages
and exit codes; it runs on the host and needs no device.

The container-runnable form of the reference operator's grove-initc
binary (operator/initc/): parses repeated
``--podcliques=<fqn>:<minAvailable>`` flags (initc/cmd/opts/options.go),
reads the pod's namespace + podgang name from downward-API files
(initc/internal/wait.go:76-90), then blocks on a pod WATCH filtered by the
``grove.io/podgang`` label until every parent clique has >= minAvailable
Ready pods (wait.go:110-164, readiness predicate :267-275). Exit code 0
unblocks the main containers.

    python -m grove_tpu_torch.initc \
        --apiserver http://operator:8080 \
        --pod-info-dir /etc/grove/pod-info \
        --podcliques my-set-0-prefill:2 --podcliques my-set-0-router:1

Connection: the apiserver URL comes from --apiserver or GROVE_APISERVER
(the in-cluster-config analogue of wait.go:166-187's SA-token client).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
from typing import Dict, List

from grove_tpu_torch.api import names as namegen
from grove_tpu_torch.initc.waiter import ready_or_transport_down
from grove_tpu_torch.runtime.errors import GroveError


def parse_podclique_flag(values: List[str]) -> List[Dict]:
    """--podcliques=<fqn>:<minAvailable>, repeated (options.go contract)."""
    deps = []
    for raw in values:
        fqn, sep, min_str = raw.rpartition(":")
        if not sep or not fqn or not min_str.isdigit():
            raise ValueError(
                f"--podcliques expects <pclq-fqn>:<minAvailable>, got {raw!r}"
            )
        deps.append({"pclq": fqn, "min_available": int(min_str)})
    return deps


def read_pod_info(pod_info_dir: str) -> Dict[str, str]:
    """Downward-API file contract (wait.go:76-90): the operator injects a
    volume exposing metadata.namespace and the grove.io/podgang label."""
    out = {}
    for key in ("namespace", "podgang"):
        path = os.path.join(pod_info_dir, key)
        with open(path) as f:
            out[key] = f.read().strip()
    return out


def wait_for_parents(
    store,
    namespace: str,
    podgang: str,
    deps: List[Dict],
    timeout: float = 3600.0,
    poll_interval: float = 5.0,
) -> bool:
    """Watch-driven wait: recheck on every pod event of the gang (the
    reference's informer handlers, wait.go:189-237); the poll interval is
    only a safety net against missed events."""
    config = {"podcliques": deps, "podgang": podgang}
    wake = threading.Event()

    def on_event(ev) -> None:
        if (
            ev.kind == "Pod"
            and ev.obj.metadata.labels.get(namegen.LABEL_PODGANG) == podgang
        ):
            wake.set()

    store.subscribe(on_event)
    deadline = store.clock.now() + timeout
    while True:
        if ready_or_transport_down(store, namespace, config):
            return True
        if store.clock.now() >= deadline:
            return False
        wake.clear()
        wake.wait(poll_interval)
    # unreachable


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="grove-tpu-torch-initc", description=__doc__)
    parser.add_argument(
        "--podcliques",
        action="append",
        default=[],
        metavar="FQN:MIN",
        help="parent clique and its minAvailable; repeatable",
    )
    parser.add_argument(
        "--apiserver",
        default=os.environ.get("GROVE_APISERVER", ""),
        help="apiserver base URL (or GROVE_APISERVER)",
    )
    parser.add_argument(
        "--pod-info-dir",
        default="/etc/grove/pod-info",
        help="downward-API mount with namespace/podgang files",
    )
    parser.add_argument("--timeout", type=float, default=3600.0)
    parser.add_argument("--poll-interval", type=float, default=5.0)
    args = parser.parse_args(argv)

    try:
        deps = parse_podclique_flag(args.podcliques)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if not deps:
        print("grove-tpu-initc: no parent cliques; nothing to wait for")
        return 0
    if not args.apiserver:
        print(
            "grove-tpu-initc: --apiserver (or GROVE_APISERVER) is required",
            file=sys.stderr,
        )
        return 2
    try:
        info = read_pod_info(args.pod_info_dir)
    except OSError as e:
        print(f"grove-tpu-initc: pod-info read failed: {e}", file=sys.stderr)
        return 2

    from grove_tpu_torch.cluster.client import HttpStore

    store = HttpStore(args.apiserver, watch_kinds=("Pod",)).start()
    try:
        ok = wait_for_parents(
            store,
            info["namespace"],
            info["podgang"],
            deps,
            timeout=args.timeout,
            poll_interval=args.poll_interval,
        )
    except GroveError as e:
        # permanent apiserver rejection (forbidden / not found / bad
        # request): a misconfiguration, not a timeout — distinct diagnosis
        # and exit code so operators can tell the two apart from logs
        print(
            f"grove-tpu-initc: apiserver rejected the wait ({e.code}): {e}",
            file=sys.stderr,
        )
        return 2
    finally:
        store.stop()
    if ok:
        print("grove-tpu-initc: all parent cliques ready; starting")
        return 0
    print(
        f"grove-tpu-initc: timed out after {args.timeout}s waiting for parents",
        file=sys.stderr,
    )
    return 1


if __name__ == "__main__":
    sys.exit(main())
