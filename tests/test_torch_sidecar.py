"""The port's sidecar wire layer, its scheduler's remote branch and its
device-health probe, against the JAX package, on the CPU.

- ``solve_request``: one ``SolveRequest`` per flag set (plain, per-group
  packs, spread with survivors, recovery pins; one stats-only with solve
  options) through the JAX ``solve_request`` and the port's
  ``solve_request(device="cpu")``: the response bytes equal once
  ``solve_seconds`` is zeroed, the placement score held apart at rtol 1e-6
  (XLA's CPU backend fuses a multiply-add the port does not). Malformed
  requests raise ``RequestDecodeError`` with the JAX text.
- The port's ``SolverServer`` and ``SolverClient`` (on the CPU) against the
  JAX server: the same response over the wire, health Check and Watch
  (drain to NOT_SERVING), an expired deadline, the complexity guard.
- The scheduler's remote branch: cut worlds through a port scheduler whose
  solves go to a port sidecar, every round equal to the in-process port
  round and to the JAX round; a dead sidecar counted in
  ``sidecar_fallbacks`` and reattached; the back-off after
  INVALID_ARGUMENT.
- ``utils/platform``: the probe without a card, and ``ensure_healthy_backend``
  retrying, memoizing and raising (never falling back to the CPU).

Every RPC carries a deadline. Both modules' sticky group pads are fresh for
each test, so the padded widths do not depend on the tests run before.
"""

import threading
import time

import grpc
import numpy as np
import pytest
import torch

from grove_tpu.api.topology import ClusterTopology as JaxTopology
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.cluster import grpcsolver as jgs
from grove_tpu.observability.events import EVENTS as JAX_EVENTS
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu.sim.cluster import SimCluster as JaxCluster, make_nodes as jax_make_nodes
from grove_tpu.solver.encode import StickyGroupPad as JaxPad
from grove_tpu.solver.scheduler import GangScheduler as JaxScheduler
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.cluster import grpcsolver as tgs
from grove_tpu_torch.cluster.protos import health_pb2
from grove_tpu_torch.cluster.protos import solver_pb2 as pb
from grove_tpu_torch.models.scenarios import (
    EventCapture,
    _renamed,
    apply_tick,
    gang_world_docs,
    round_summary,
    scheduler_world,
    stress_gang_specs,
)
from grove_tpu_torch.observability.events import EVENTS
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store
from grove_tpu_torch.sim.cluster import SimCluster, make_nodes
from grove_tpu_torch.solver.encode import StickyGroupPad
from grove_tpu_torch.solver.scheduler import GangScheduler
from grove_tpu_torch.utils import platform as plat
from tests.test_torch_flags import flag_specs
from tests.test_torch_scheduler import assert_same_events, assert_same_world

RPC_TIMEOUT = 60.0
HEALTH_TIMEOUT = 5.0


@pytest.fixture(autouse=True)
def fresh_pads(monkeypatch):
    monkeypatch.setattr(jgs, "_PAD_GROUPS", JaxPad())
    monkeypatch.setattr(tgs, "_PAD_GROUPS", StickyGroupPad())


@pytest.fixture
def port_server():
    server = tgs.SolverServer(device="cpu").start()
    yield server
    server.stop(grace=0.5)


# -- solve_request -------------------------------------------------------------

FLAG_SETS = {
    "plain": ("plain",),
    "pack": ("grouped",),
    "spread": ("spread",),
    "pins": ("pinned",),
    "stats_only": ("plain",),
}


def flag_request(case: str, n_gangs: int = 40, n_nodes: int = 64):
    nodes = make_nodes(n_nodes, {"cpu": 16.0, "tpu": 4.0}, 4, 4)
    specs = flag_specs(n_gangs, len(case), FLAG_SETS[case], uniform=False, n_nodes=n_nodes)
    # the plain request carries no topology keys (the server's default
    # topology), the others carry the default levels' keys
    request = tgs.build_request(nodes, specs, None if case == "plain" else ClusterTopology())
    if case == "stats_only":
        request.options.stats_only = True
        request.options.chunk_size = 8
        request.options.max_waves = 4
    return request


def assert_same_response(got, want):
    """Equal bytes less solve_seconds; placement scores at rtol 1e-6."""
    got, want = pb.SolveResponse.FromString(got.SerializeToString()), \
        pb.SolveResponse.FromString(want.SerializeToString())
    np.testing.assert_allclose(
        [p.placement_score for p in got.placements],
        [p.placement_score for p in want.placements], rtol=1e-6, atol=0)
    for msg in (got, want):
        msg.solve_seconds = 0.0
        for p in msg.placements:
            p.placement_score = 0.0
    assert got.SerializeToString() == want.SerializeToString()


@pytest.mark.parametrize("case", list(FLAG_SETS))
def test_solve_request_matches_jax(case):
    request = flag_request(case)
    jax_request = jgs.pb.SolveRequest.FromString(request.SerializeToString())
    want = jgs.solve_request(jax_request)
    got = tgs.solve_request(request, device="cpu")
    admitted = sum(p.admitted for p in want.placements)
    assert 0 < admitted
    if case == "stats_only":
        assert not any(p.assignments for p in want.placements)
    else:
        assert any(p.assignments for p in want.placements)
    assert_same_response(got, want)


def test_build_request_matches_jax():
    nodes = make_nodes(16, {"cpu": 16.0, "tpu": 4.0}, 4, 4)
    specs = flag_specs(12, 3, ("grouped", "pinned", "spread", "plain"))
    got = tgs.build_request(nodes, specs, ClusterTopology())
    want = jgs.build_request(jax_make_nodes(16, {"cpu": 16.0, "tpu": 4.0}, 4, 4), specs,
                             JaxTopology())
    assert got.SerializeToString() == want.SerializeToString()


def _malformed(case: str):
    nodes = make_nodes(16, {"cpu": 16.0, "tpu": 4.0}, 4, 4)
    group = {"name": "g-a", "demand": {"cpu": 1.0}, "count": 2, "min_count": 2}
    spec = {"name": "g", "groups": [group], "priority": 0}
    if case == "unknown_gang_key":
        spec["required_key"] = "example.com/no-such-level"
    elif case == "unknown_group_key":
        group["required_key"] = "example.com/no-such-level"
    elif case == "spread_with_group_pack":
        group["required_key"] = "kubernetes.io/hostname"
        spec.update(spread_key="cloud.google.com/gke-tpu-ici-block", spread_required=True)
    elif case == "spread_not_narrower":
        spec.update(required_key="cloud.google.com/gke-tpu-ici-block",
                    spread_key="cloud.google.com/gke-tpu-slice", spread_required=True)
    return tgs.build_request(nodes, [spec], ClusterTopology())


@pytest.mark.parametrize("case", ["unknown_gang_key", "unknown_group_key",
                                  "spread_with_group_pack", "spread_not_narrower"])
def test_malformed_request_raises_as_jax(case):
    request = _malformed(case)
    with pytest.raises(jgs.RequestDecodeError) as want:
        jgs.solve_request(jgs.pb.SolveRequest.FromString(request.SerializeToString()))
    with pytest.raises(tgs.RequestDecodeError) as got:
        tgs.solve_request(request, device="cpu")
    assert str(got.value) == str(want.value)


# -- the server and the client --------------------------------------------------


def test_round_trip_matches_jax_server(port_server):
    request = flag_request("pack", n_gangs=24)
    jax_server = jgs.SolverServer().start()
    try:
        port_client = tgs.SolverClient(port_server.address)
        jax_client = jgs.SolverClient(jax_server.address)
        got = port_client.solve(request, timeout=RPC_TIMEOUT)
        want = jax_client.solve(jgs.pb.SolveRequest.FromString(request.SerializeToString()),
                                timeout=RPC_TIMEOUT)
        assert_same_response(got, want)
        # wire-compatible: the port's stub against the JAX server
        cross = tgs.SolverClient(jax_server.address)
        assert_same_response(cross.solve(request, timeout=RPC_TIMEOUT), want)
        cross.close()
        # and the in-process solve of the same request
        assert_same_response(tgs.solve_request(request, device="cpu"), got)
        port_client.close()
        jax_client.close()
    finally:
        jax_server.stop(grace=0.5)


def test_health_check_and_stop(port_server):
    client = tgs.SolverClient(port_server.address)
    assert client.healthy(timeout=HEALTH_TIMEOUT)
    serving = health_pb2.HealthCheckResponse.SERVING
    unknown = health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
    for service, status in (("", serving), (tgs._SERVICE, serving), ("no.such.Service", unknown)):
        response = client._health(health_pb2.HealthCheckRequest(service=service),
                                  timeout=HEALTH_TIMEOUT)
        assert response.status == status
    port_server.stop(grace=0.5)
    assert not client.healthy(timeout=HEALTH_TIMEOUT)
    client.close()


def test_health_watch_streams_not_serving_on_drain():
    server = tgs.SolverServer(device="cpu").start()
    channel = grpc.insecure_channel(server.address)
    watch = channel.unary_stream(
        f"/{tgs._HEALTH_SERVICE}/Watch",
        request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
        response_deserializer=health_pb2.HealthCheckResponse.FromString,
    )
    stream = watch(health_pb2.HealthCheckRequest(service=""), timeout=30.0)
    statuses = []
    done = threading.Event()

    def consume():
        try:
            for response in stream:
                statuses.append(response.status)
                if len(statuses) >= 2:
                    break
        except grpc.RpcError:
            pass
        done.set()

    threading.Thread(target=consume, daemon=True).start()
    deadline = time.monotonic() + 10.0
    while not statuses and time.monotonic() < deadline:
        time.sleep(0.05)
    assert statuses == [health_pb2.HealthCheckResponse.SERVING]
    server.stop(grace=2.0)
    done.wait(timeout=10.0)
    stream.cancel()
    channel.close()
    assert statuses[:2] == [health_pb2.HealthCheckResponse.SERVING,
                            health_pb2.HealthCheckResponse.NOT_SERVING]


def test_watchers_past_the_cap_are_one_shot():
    server = tgs.SolverServer(workers=4, device="cpu").start()  # cap: one watcher
    channel = grpc.insecure_channel(server.address)
    watch = channel.unary_stream(
        f"/{tgs._HEALTH_SERVICE}/Watch",
        request_serializer=health_pb2.HealthCheckRequest.SerializeToString,
        response_deserializer=health_pb2.HealthCheckResponse.FromString,
    )
    try:
        held = watch(health_pb2.HealthCheckRequest(service=""), timeout=30.0)
        assert next(held).status == health_pb2.HealthCheckResponse.SERVING
        deadline = time.monotonic() + 10.0
        while server._watchers < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert server._watchers == 1
        # the second stream gets the status and ends at once
        second = list(watch(health_pb2.HealthCheckRequest(service=""), timeout=10.0))
        assert [r.status for r in second] == [health_pb2.HealthCheckResponse.SERVING]
        held.cancel()
    finally:
        channel.close()
        server.stop(grace=0.5)


def test_expired_deadline_is_deadline_exceeded(port_server):
    client = tgs.SolverClient(port_server.address)
    request = tgs.build_request(
        make_nodes(4),
        [{"name": "g0", "groups": [{"name": "a", "demand": {"cpu": 0.1}, "count": 1,
                                    "min_count": 1}]}],
    )
    with pytest.raises(grpc.RpcError) as err:
        client.solve(request, timeout=1e-6)
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    client.close()


def test_oversized_request_is_resource_exhausted(port_server, monkeypatch):
    """The complexity guard, with the ceiling lowered so that a small
    request crosses it (the handler reads the module's ceiling)."""
    request = flag_request("plain", n_gangs=8, n_nodes=16)
    cells = len(request.gangs) * max(len(g.groups) for g in request.gangs) * len(request.nodes)
    monkeypatch.setattr(tgs, "MAX_DENSE_CELLS", cells - 1)
    client = tgs.SolverClient(port_server.address)
    with pytest.raises(grpc.RpcError) as err:
        client.solve(request, timeout=RPC_TIMEOUT)
    assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    monkeypatch.setattr(tgs, "MAX_DENSE_CELLS", cells)
    assert len(client.solve(request, timeout=RPC_TIMEOUT).placements) == 8
    client.close()


def test_server_bad_request_is_invalid_argument(port_server):
    client = tgs.SolverClient(port_server.address)
    with pytest.raises(grpc.RpcError) as err:
        client.solve(_malformed("unknown_gang_key"), timeout=RPC_TIMEOUT)
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "is not a level of the cluster topology" in err.value.details()
    client.close()


def test_server_and_solve_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """No fallback: without CUDA and without a device, the server and the
    solve raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.SolverServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.solve_request(flag_request("plain", n_gangs=4, n_nodes=16))
    assert tgs.SolverServer(device="cpu").device == torch.device("cpu")


# -- the scheduler's remote branch ----------------------------------------------


def _schedulers(world_name, n_nodes, n_gangs, sidecar, delta=False, ticks=None):
    w = scheduler_world(world_name, n_nodes, n_gangs, ticks)
    jax_store = JaxStore(JaxClock(0.0))
    jax_cluster = JaxCluster(store=jax_store, nodes=jax_make_nodes(*w["nodes"]))
    jax_sched = JaxScheduler(jax_store, jax_cluster, JaxTopology(), w["priority_map"])
    ports = []
    for remote in (None, sidecar):
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*w["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), w["priority_map"],
                              solver_sidecar=remote, device="cpu")
        sched.sidecar_timeout = RPC_TIMEOUT
        ports.append((store, cluster, sched))
    if delta:
        assert jax_sched.enable_delta()
        for _, _, sched in ports:
            assert sched.enable_delta()
    return w, (jax_store, jax_cluster, jax_sched), ports


def _round(sched, recorder):
    with EventCapture(recorder) as cap:
        sched.schedule_pending()
    return cap.events


@pytest.mark.parametrize("world,n_nodes,n_gangs", [("q", 64, 96), ("r", 48, 96),
                                                   ("delta", 64, 96)])
def test_rounds_through_the_sidecar_match(port_server, world, n_nodes, n_gangs):
    """A cut world loaded from the same documents into a JAX scheduler, a
    port scheduler and a port scheduler whose solves (the rounds' and the
    preemption and reclaim trials') go to the port's sidecar: every round
    equal on all three; the delta world's ticks solve through the sidecar
    from the delta state's free-capacity dicts."""
    JAX_EVENTS.reset()
    EVENTS.reset()
    delta = world == "delta"
    w, (jax_store, jax_cluster, jax_sched), ports = _schedulers(
        world, n_nodes, n_gangs, port_server.address, delta=delta, ticks=4)

    def load(docs):
        for doc in docs:
            jax_store.create(jax_decode(doc))
            for store, _, _ in ports:
                store.create(decode_object(doc))

    def churn(tick):
        apply_tick(jax_store, jax_cluster, tick, jax_decode)
        for store, cluster, _ in ports:
            apply_tick(store, cluster, tick, decode_object)

    steps = [lambda: load(w["queues"] + w["rounds"][0])]
    steps += [(lambda t=t: churn(t)) for t in w["ticks"]] if delta else [
        (lambda d=d: load(d)) for d in w["rounds"][1:]]
    reasons = set()
    for index, step in enumerate(steps):
        step()
        jax_events = _round(jax_sched, JAX_EVENTS)
        want = round_summary(jax_store, jax_cluster, jax_events)
        want_score = want.pop("score_sum")
        summaries = []
        for store, cluster, sched in ports:
            events = _round(sched, EVENTS)
            assert_same_events(events, jax_events)
            got = round_summary(store, cluster, events)
            summaries.append(dict(got))
            assert np.isclose(got.pop("score_sum"), want_score, rtol=1e-6)
            assert got == want, f"round {index + 1}"
            assert_same_world(store, cluster, jax_store, jax_cluster)
        # the sidecar's round equals the in-process port round bit for bit
        assert summaries[0] == summaries[1]
        reasons |= {e[4] for e in jax_events}
    remote = ports[1][2]
    assert remote.sidecar_fallbacks == 0 and remote._sidecar_client is not None
    assert len(steps) == (5 if delta else len(w["rounds"]))
    if world == "r":
        assert {"Preempted", "QuotaReclaim"} <= reasons
    JAX_EVENTS.reset()
    EVENTS.reset()


def test_frontier_stays_off_with_a_sidecar():
    store = Store(VirtualClock(0.0))
    sched = GangScheduler(store, SimCluster(store, make_nodes(8)),
                          solver_sidecar="127.0.0.1:1", device="cpu")
    assert not sched.enable_frontier() and sched.frontier is None
    assert sched.enable_delta()


def test_dead_sidecar_falls_back_then_reattaches():
    """Nothing listens at the sidecar's address: the round is solved in
    process, on the round's device, equal to a port round without a
    sidecar, and counted; a sidecar that comes up is used from the next
    round on."""
    EVENTS.reset()
    w, _, ports = _schedulers("s", 32, 48, "127.0.0.1:1")
    (store0, cluster0, local), (store1, cluster1, remote) = ports
    remote.sidecar_timeout = 10.0
    for docs in w["rounds"][:1]:
        for doc in docs:
            store0.create(decode_object(doc))
            store1.create(decode_object(doc))
    want = round_summary(store0, cluster0, _round(local, EVENTS))
    got = round_summary(store1, cluster1, _round(remote, EVENTS))
    assert got == want and got["admitted"] > 0
    assert remote.sidecar_fallbacks == 1 and remote._sidecar_client is None
    assert remote._sidecar_skip_until == 0.0  # unavailable, not doomed: no back-off
    server = tgs.SolverServer(device="cpu").start()
    try:
        remote.solver_sidecar = server.address
        more = gang_world_docs(_renamed(stress_gang_specs(4, seed=9), "late"))
        calls = []
        real = tgs.solve_request

        def counted(request, device=None):
            calls.append(len(request.gangs))
            return real(request, device=device)

        tgs.solve_request = counted
        try:
            for doc in more:
                store1.create(decode_object(doc))
            _round(remote, EVENTS)
        finally:
            tgs.solve_request = real
        assert calls and remote.sidecar_fallbacks == 1
    finally:
        server.stop(grace=0.5)
    EVENTS.reset()


def test_invalid_argument_backs_off_the_sidecar(port_server, monkeypatch):
    """A sidecar that answers INVALID_ARGUMENT: the batch is solved in
    process and the sidecar is skipped for sidecar_backoff_s, so the next
    round sends no request."""
    EVENTS.reset()
    calls = []

    def reject(request, device=None):
        calls.append(len(request.gangs))
        raise tgs.RequestDecodeError("rejected by the test")

    monkeypatch.setattr(tgs, "solve_request", reject)
    w, _, ports = _schedulers("s", 32, 48, port_server.address)
    (store0, cluster0, local), (store1, cluster1, remote) = ports
    for doc in w["rounds"][0]:
        store0.create(decode_object(doc))
        store1.create(decode_object(doc))
    want = round_summary(store0, cluster0, _round(local, EVENTS))
    t0 = time.monotonic()
    got = round_summary(store1, cluster1, _round(remote, EVENTS))
    assert got == want
    assert calls == [48] and remote.sidecar_fallbacks == 1
    assert remote._sidecar_skip_until >= t0 + remote.sidecar_backoff_s
    want = round_summary(store0, cluster0, _round(local, EVENTS))
    got = round_summary(store1, cluster1, _round(remote, EVENTS))
    assert got == want
    assert calls == [48] and remote.sidecar_fallbacks == 1
    EVENTS.reset()


# -- utils/platform ---------------------------------------------------------------


@pytest.fixture
def fresh_backend(monkeypatch):
    monkeypatch.setattr(plat, "_backend_note", None)


def test_probe_without_cuda_build_fails_with_a_reason(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda, "is_built", lambda: False)
    assert plat.probe_device_health(timeout_s=5.0, require_accelerator=True) is False
    detail = plat.last_probe_detail()
    assert detail["ok"] is False and "without CUDA" in detail["reason"]
    assert detail["retryable"] is False


def test_probe_child_without_a_device_fails_with_a_reason():
    """The child runs, but every CUDA device is hidden from it: it answers
    on the CPU, which a caller that needs the card rejects."""
    env = plat.cpu_subprocess_env()
    assert plat.probe_device_health(timeout_s=120.0, env=env, require_accelerator=True,
                                    precheck=False) is False
    detail = plat.last_probe_detail()
    assert "on the CPU" in detail["reason"] and "OK cpu" in detail["output_tail"]
    assert plat.check_platform_available(env) is not None
    # without require_accelerator the same child is a healthy answer
    assert plat.probe_device_health(timeout_s=120.0, env=env, precheck=False) is True


def test_ensure_healthy_backend_retries_until_the_probe_succeeds(fresh_backend, monkeypatch):
    calls = []

    def fake_probe(timeout_s, require_accelerator=False):
        calls.append(require_accelerator)
        return len(calls) >= 3

    monkeypatch.setattr(plat, "probe_device_health", fake_probe)
    assert plat.ensure_healthy_backend(timeout_s=1.0, retries=5) == "default"
    assert calls == [True, True, True]
    assert plat.ensure_healthy_backend(timeout_s=1.0) == "default"  # memoized
    assert len(calls) == 3


def test_ensure_healthy_backend_raises_instead_of_falling_back(fresh_backend, monkeypatch):
    calls = []

    def fake_probe(timeout_s, require_accelerator=False):
        calls.append(1)
        plat._last_probe = {"ok": False, "reason": "card wedged", "output_tail": "trace",
                            "retryable": True}
        return False

    monkeypatch.setattr(plat, "probe_device_health", fake_probe)
    with pytest.raises(RuntimeError, match="card wedged"):
        plat.ensure_healthy_backend(timeout_s=1.0, retries=3)
    assert len(calls) == 3
    assert plat._backend_note is None
    # a deterministic configuration error stops at the first probe
    calls.clear()
    monkeypatch.setattr(plat, "probe_device_health", lambda timeout_s, require_accelerator=False: (
        calls.append(1), setattr(plat, "_last_probe", {"reason": "no build", "retryable": False})
    ) and False)
    with pytest.raises(RuntimeError, match="no build"):
        plat.ensure_healthy_backend(timeout_s=1.0, retries=3)
    assert len(calls) == 1


def test_host_fingerprint_matches_jax():
    from grove_tpu.utils import platform as jplat

    assert plat.host_machine_fingerprint() == jplat.host_machine_fingerprint()
