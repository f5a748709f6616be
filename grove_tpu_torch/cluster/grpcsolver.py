"""The gRPC gang-solver sidecar: the north-star boundary, on the card.

Counterpart of ``grove_tpu/cluster/grpcsolver.py``. ``GangSolver.Solve``
takes the whole pending-gang batch and a cluster snapshot
(``protos/solver.proto``) and returns per-gang placements with their
placement scores, solved by the wave solver (``solver/kernel.solve_waves``,
whose fills launch the CUDA fill kernel).

- ``solve_decoded``: a decoded request (nodes, gang specs, topology)
  through sticky group padding, ``build_problem`` and ``solve_waves`` to
  plain dicts with the fields of ``SolveResponse``;
- ``solve_request``: a ``SolveRequest`` to a ``SolveResponse`` through
  ``solve_decoded``, the endpoint's sticky padding ``_PAD_GROUPS`` shared
  across requests; malformed requests and contradicting constraints raise
  ``RequestDecodeError`` (INVALID_ARGUMENT on the wire);
- ``SolverServer``: the gRPC server (the deadline guard before a solve,
  ``MAX_DENSE_CELLS``, the ``grpc.health.v1`` Check and Watch with its cap
  on watchers, drain to NOT_SERVING in ``stop``), ``SolverClient`` and
  ``build_request``; ``main`` runs the server after
  ``utils/platform.ensure_healthy_backend``.

Every solve runs on ``device``: the card unless the caller passes another
(``device="cpu"``, as the tests do); without CUDA and without a device the
server and ``solve_request`` raise, never fall back. ``grpc`` and
``protobuf`` are optional: the module imports without them (``solve_decoded``
needs neither), and ``_require_grpc`` raises once the wire is used.
"""

from __future__ import annotations

from concurrent import futures
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

try:  # the sidecar's optional dependencies: fail on use, not at import
    import grpc
except ImportError as _exc:  # pragma: no cover - absent on some hosts
    grpc = None
    _GRPC_IMPORT_ERROR: Optional[ImportError] = _exc
else:
    _GRPC_IMPORT_ERROR = None

try:
    from grove_tpu_torch.cluster.protos import health_pb2
    from grove_tpu_torch.cluster.protos import solver_pb2 as pb
except ImportError as _exc:  # pragma: no cover - absent on some hosts
    health_pb2 = pb = None
    _PROTOBUF_IMPORT_ERROR: Optional[ImportError] = _exc
else:
    _PROTOBUF_IMPORT_ERROR = None

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.solver.encode import ConstraintError, StickyGroupPad, build_problem
from grove_tpu_torch.solver.kernel import solve_waves
from grove_tpu_torch.utils.platform import resolve_device

_SERVICE = "grove.solver.v1.GangSolver"
_HEALTH_SERVICE = "grpc.health.v1.Health"

# wire-size ceiling, both directions: the 10k-gang x 5k-node stress request
# with allocations is tens of MB (grpc's default receive limit is 4 MB),
# and an unbounded one would let a rogue request exhaust the sidecar
MAX_MESSAGE_BYTES = 256 * 1024 * 1024
# request-complexity guard: the dense alloc tensor holds gangs x max groups
# x nodes int32s; past this many cells the request is RESOURCE_EXHAUSTED
# rather than an out-of-memory kill mid-solve (the stress shape, 10k gangs
# x ~4 groups x 5k nodes = 2.0e8, fits under it)
MAX_DENSE_CELLS = 250_000_000


def _require_protobuf() -> None:
    if pb is None:
        raise RuntimeError(
            "the gang-solver wire layer needs protobuf (pip install 'protobuf>=4.25')"
        ) from _PROTOBUF_IMPORT_ERROR


def _require_grpc() -> None:
    if grpc is None:
        raise RuntimeError(
            "the gang-solver sidecar needs grpcio (pip install 'grpcio>=1.60')"
        ) from _GRPC_IMPORT_ERROR
    _require_protobuf()


def _topology_from_keys(level_keys: List[str]) -> ClusterTopology:
    from grove_tpu_torch.api.topology import ClusterTopologySpec, TopologyLevel

    if not level_keys:
        return ClusterTopology()
    return ClusterTopology(
        spec=ClusterTopologySpec(
            levels=[TopologyLevel(domain=f"level-{i}", key=key) for i, key in enumerate(level_keys)]
        )
    )


def _decode_request(request):
    from grove_tpu_torch.sim.cluster import Node

    nodes = [
        Node(
            name=n.name,
            capacity={q.resource: q.value for q in n.capacity},
            labels=dict(n.labels),
        )
        for n in request.nodes
    ]
    gang_specs = []
    for gang in request.gangs:
        gang_specs.append(
            {
                "name": gang.name,
                "groups": [
                    {
                        "name": grp.name,
                        "demand": {q.resource: q.value for q in grp.demand},
                        "count": grp.count,
                        "min_count": grp.min_count,
                        "required_key": grp.pack_level_key or None,
                        "pinned_node": grp.pinned_node or None,
                    }
                    for grp in gang.groups
                ],
                "required_key": gang.required_level_key or None,
                "preferred_key": gang.preferred_level_key or None,
                "spread_key": gang.spread_level_key or None,
                "spread_min_domains": gang.spread_min_domains or 2,
                "spread_required": gang.spread_required,
                "spread_survivor_nodes": list(gang.spread_survivor_nodes),
                "priority": gang.priority,
                "gang_pinned_node": gang.pinned_node or None,
            }
        )
    topology = _topology_from_keys(list(request.topology_level_keys))
    return nodes, gang_specs, topology


class RequestDecodeError(ValueError):
    """Malformed or undecodable request: INVALID_ARGUMENT on the wire."""


# The endpoint's sticky group-axis padding: grows to the widest template
# seen by this process and never shrinks, so the padded shapes of
# successive requests stay few (the JAX sidecar pays an XLA compile per
# shape; here it keeps the chunk shapes, and the answers, equal to JAX's).
# Built at import: a lazy check-then-act could race two first requests
# into two instances; the helper locks its read-modify-write.
_PAD_GROUPS = StickyGroupPad()


def solve_decoded(
    nodes: Sequence,
    gang_specs: List[dict],
    topology: ClusterTopology,
    with_alloc: bool = True,
    chunk_size: Optional[int] = None,
    max_waves: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    free_capacity: Optional[Dict[str, Dict[str, float]]] = None,
    pad_groups: Optional[StickyGroupPad] = None,
) -> dict:
    """Solve one decoded request. `pad_groups`: the endpoint's sticky group
    padding (a fresh one pads this batch exactly). `free_capacity`
    overrides node capacity per node name.

    Returns ``{"solve_seconds": float, "placements": [{"gang",
    "admitted", "placement_score", "chosen_level_key", "assignments":
    [(group, node, count), ...]}, ...]}`` in request order.
    """
    pad = pad_groups if pad_groups is not None else StickyGroupPad()
    problem = build_problem(
        nodes, gang_specs, topology,
        free_capacity=free_capacity,
        pad_groups=pad.grow(gang_specs),
    )
    solve_kwargs = {"with_alloc": with_alloc, "device": device}
    if chunk_size:
        solve_kwargs["chunk_size"] = chunk_size
    if max_waves:
        solve_kwargs["max_waves"] = max_waves
    result = solve_waves(problem, **solve_kwargs)
    return {"solve_seconds": result.solve_seconds,
            "placements": placements_of(problem, gang_specs, result, topology)}


def placements_of(problem, gang_specs: List[dict], result, topology: ClusterTopology) -> list:
    """A solve's result as the response's placements, in request order:
    ``[{"gang", "admitted", "placement_score", "chosen_level_key",
    "assignments": [(group, node, count), ...]}, ...]`` (assignments from
    the result's allocations, when it has them)."""
    level_keys = [lvl.key for lvl in topology.spec.levels]
    placements = []
    for gi, spec in enumerate(gang_specs):
        admitted = bool(result.admitted[gi])
        chosen = int(result.chosen_level[gi])
        assignments = []
        if result.alloc is not None and admitted:
            alloc = result.alloc[gi]  # [P, N] pod counts
            for pi, grp in enumerate(spec["groups"]):
                for ni in np.nonzero(alloc[pi])[0]:
                    assignments.append(
                        (grp["name"], problem.node_names[int(ni)], int(alloc[pi][ni]))
                    )
        placements.append(
            {
                "gang": spec["name"],
                "admitted": admitted,
                "placement_score": float(result.score[gi]),
                "chosen_level_key": (
                    level_keys[chosen] if 0 <= chosen < len(level_keys) else ""
                ),
                "assignments": assignments,
            }
        )
    return placements


def solve_request(request, device: Optional[Union[str, torch.device]] = None):
    """One ``SolveRequest`` to its ``SolveResponse`` on ``device`` (default:
    the card; raises without one): the gRPC handler's solve, also called in
    process by tests."""
    _require_protobuf()
    try:
        nodes, gang_specs, topology = _decode_request(request)
    except Exception as exc:
        raise RequestDecodeError(str(exc)) from exc
    options = request.options
    try:
        decoded = solve_decoded(
            nodes,
            gang_specs,
            topology,
            with_alloc=not options.stats_only,
            chunk_size=options.chunk_size or None,
            max_waves=options.max_waves or None,
            device=resolve_device(device),
            pad_groups=_PAD_GROUPS,
        )
    except ConstraintError as exc:
        # declared-constraint contradictions (unknown hard keys, spread with
        # a per-group pack) are the caller's fault: INVALID_ARGUMENT; any
        # other failure stays a server-side INTERNAL error
        raise RequestDecodeError(str(exc)) from exc
    response = pb.SolveResponse(solve_seconds=decoded["solve_seconds"])
    for row in decoded["placements"]:
        placement = response.placements.add()
        placement.gang = row["gang"]
        placement.admitted = row["admitted"]
        placement.placement_score = row["placement_score"]
        placement.chosen_level_key = row["chosen_level_key"]
        for group, node, count in row["assignments"]:
            assignment = placement.assignments.add()
            assignment.group = group
            assignment.node = node
            assignment.count = count
    return response


class SolverServer:
    """Standalone gRPC server of the sidecar. ``start()`` binds (port 0: an
    ephemeral port) and returns self; ``address`` is host:port. Solves run
    on ``device``: the card unless the caller passes another; raises at
    construction without CUDA and without a device."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 8,
        device: Optional[Union[str, torch.device]] = None,
    ):
        _require_grpc()
        self.device = resolve_device(device)
        self._requested = (host, port)
        self._workers = workers
        self._server = None
        self._serving = False
        # a health Watch stream holds one pool thread while it lives; cap
        # them well below the pool so watchers can never starve Solve
        self._watch_limit = max(workers // 4, 1)
        self._watchers = 0
        self._watchers_lock = __import__("threading").Lock()
        self.address: Optional[str] = None

    def start(self) -> "SolverServer":
        def solve_handler(request, context):
            # deadline guard before the solve: past (or about to pass) the
            # client's deadline the answer is of no use to it; do not spend
            # the card on it
            remaining = context.time_remaining()
            if remaining is not None and remaining < 0.05:
                context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    "client deadline expired before solve started",
                )
            max_groups = max((len(g.groups) for g in request.gangs), default=0)
            complexity = len(request.gangs) * max(max_groups, 1) * max(len(request.nodes), 1)
            if complexity > MAX_DENSE_CELLS:
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"request complexity {complexity} gangs x groups x nodes "
                    f"exceeds {MAX_DENSE_CELLS}",
                )
            try:
                response = solve_request(request, device=self.device)
            except RequestDecodeError as exc:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad request: {exc}")
            except Exception as exc:
                # solver and device failures are server-side and retryable:
                # never INVALID_ARGUMENT (clients take that as permanent)
                context.abort(grpc.StatusCode.INTERNAL, f"solve failed: {exc}")
            # the solve outran the deadline or the client hung up: skip the
            # (large) response marshal
            if not context.is_active():
                context.abort(
                    grpc.StatusCode.CANCELLED,
                    "client gone before solve completed",
                )
            return response

        def status_for(service: str) -> int:
            # empty service = server-wide; the solver service by name; any
            # other name is unknown to the health protocol
            if service not in ("", _SERVICE):
                return health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
            return (
                health_pb2.HealthCheckResponse.SERVING
                if self._serving
                else health_pb2.HealthCheckResponse.NOT_SERVING
            )

        def health_handler(request, context):
            return health_pb2.HealthCheckResponse(status=status_for(request.service))

        def health_watch(request, context):
            # Watch: the current status, then every change while the stream
            # lives (drain flips to NOT_SERVING inside stop()'s grace). Past
            # the watcher cap the stream is one-shot and the client
            # re-polls.
            import time as _time

            last = status_for(request.service)
            yield health_pb2.HealthCheckResponse(status=last)
            with self._watchers_lock:
                if self._watchers >= self._watch_limit:
                    return
                self._watchers += 1
            try:
                while context.is_active():
                    current = status_for(request.service)
                    if current != last:
                        last = current
                        yield health_pb2.HealthCheckResponse(status=current)
                    _time.sleep(0.2)
            finally:
                with self._watchers_lock:
                    self._watchers -= 1

        handlers = [
            grpc.method_handlers_generic_handler(
                _SERVICE,
                {
                    "Solve": grpc.unary_unary_rpc_method_handler(
                        solve_handler,
                        request_deserializer=pb.SolveRequest.FromString,
                        response_serializer=pb.SolveResponse.SerializeToString,
                    )
                },
            ),
            grpc.method_handlers_generic_handler(
                _HEALTH_SERVICE,
                {
                    "Check": grpc.unary_unary_rpc_method_handler(
                        health_handler,
                        request_deserializer=health_pb2.HealthCheckRequest.FromString,
                        response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
                    ),
                    "Watch": grpc.unary_stream_rpc_method_handler(
                        health_watch,
                        request_deserializer=health_pb2.HealthCheckRequest.FromString,
                        response_serializer=health_pb2.HealthCheckResponse.SerializeToString,
                    ),
                },
            ),
        ]
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._workers),
            options=[
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ],
        )
        self._server.add_generic_rpc_handlers(tuple(handlers))
        host, port = self._requested
        bound = self._server.add_insecure_port(f"{host}:{port}")
        self.address = f"{host}:{bound}"
        self._serving = True
        self._server.start()
        return self

    def stop(self, grace: float = 1.0) -> None:
        self._serving = False  # health reads NOT_SERVING during the drain
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None


class SolverClient:
    """Thin stub of GangSolver (hand-written; wire-compatible with any
    generated stub of protos/solver.proto)."""

    def __init__(self, address: str):
        _require_grpc()
        self._channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
                ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
            ],
        )
        self._solve = self._channel.unary_unary(
            f"/{_SERVICE}/Solve",
            request_serializer=pb.SolveRequest.SerializeToString,
            response_deserializer=pb.SolveResponse.FromString,
        )
        self._health = self._channel.unary_unary(
            f"/{_HEALTH_SERVICE}/Check",
            request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=health_pb2.HealthCheckResponse.FromString,
        )

    def solve(self, request, timeout: float = 120.0):
        return self._solve(request, timeout=timeout)

    def healthy(self, timeout: float = 2.0) -> bool:
        """The standard grpc.health.v1 Check, as kube gRPC probes ask it."""
        try:
            response = self._health(health_pb2.HealthCheckRequest(service=_SERVICE), timeout=timeout)
        except grpc.RpcError:
            return False
        return response.status == health_pb2.HealthCheckResponse.SERVING

    def close(self) -> None:
        self._channel.close()


def build_request(nodes, gang_specs: List[dict], topology=None):
    """Encode scheduler-side nodes and gang specs into the wire request (the
    inverse of ``_decode_request``)."""
    _require_protobuf()
    request = pb.SolveRequest()
    for node in nodes:
        n = request.nodes.add()
        n.name = node.name
        for resource, value in sorted(node.capacity.items()):
            q = n.capacity.add()
            q.resource = resource
            q.value = value
        for k, v in node.labels.items():
            n.labels[k] = v
    for spec in gang_specs:
        gang = request.gangs.add()
        gang.name = spec["name"]
        gang.required_level_key = spec.get("required_key") or ""
        gang.preferred_level_key = spec.get("preferred_key") or ""
        gang.spread_level_key = spec.get("spread_key") or ""
        gang.spread_min_domains = int(spec.get("spread_min_domains") or 0)
        gang.spread_required = bool(spec.get("spread_required", False))
        gang.spread_survivor_nodes.extend(spec.get("spread_survivor_nodes") or [])
        gang.priority = int(spec.get("priority", 0))
        gang.pinned_node = spec.get("gang_pinned_node") or ""
        for grp in spec["groups"]:
            group = gang.groups.add()
            group.name = grp["name"]
            group.count = int(grp["count"])
            group.min_count = int(grp["min_count"])
            group.pack_level_key = grp.get("required_key") or ""
            group.pinned_node = grp.get("pinned_node") or ""
            for resource, value in sorted(grp["demand"].items()):
                q = group.demand.add()
                q.resource = resource
                q.value = value
    if topology is not None:
        request.topology_level_keys.extend(lvl.key for lvl in topology.spec.levels)
    return request


def main(argv: Optional[List[str]] = None) -> int:
    """Console entry: run the sidecar on the card until interrupted. Raises
    when the card is unhealthy (``ensure_healthy_backend``)."""
    import argparse
    import time

    parser = argparse.ArgumentParser(prog="grove-tpu-torch-solver")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=50061)
    args = parser.parse_args(argv)

    from grove_tpu_torch.utils.platform import ensure_healthy_backend

    ensure_healthy_backend(timeout_s=45.0)
    server = SolverServer(args.host, args.port).start()
    print(f"gang-solver sidecar listening on {server.address} ({server.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
