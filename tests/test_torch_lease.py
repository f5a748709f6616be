"""Lease election of the port against the JAX package's, on the CPU.

A port ``LeaseElector`` and a JAX one share one apiserver (either
package's), each through its own package's ``HttpStore``: they exclude each
other, and the scripted scenario of ``tests/test_leader_election.py`` (the
create race, a graceful release, a crash and the takeover after expiry, the
deposed leader's renew) gives the same holders and ``leaseTransitions`` as
the JAX-only run. Then the port's operator pair (``start_operator(device=
"cpu")``, one with the embedded apiserver, one its client) runs that file's
operator cases, and a JAX operator's run loop hands over to a port one.
Durations are the JAX test's, its smallest: a 1.5 s lease, a 1.0 s renew
deadline, a 0.1 s retry period.
"""

from __future__ import annotations

import importlib
import pathlib
import threading
import time

import pytest
import yaml

REPO = pathlib.Path(__file__).resolve().parents[1]
LEASE = "grove-tpu-leader-election"
TIMING = {"lease_duration": 1.5, "renew_deadline": 1.0, "retry_period": 0.1}


def mod(root: str, path: str):
    return importlib.import_module(f"{root}.{path}")


def wait_for(cond, timeout=10.0, msg=""):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out: {msg}")


def _lease(store) -> dict:
    lease = store.get("Lease", "default", LEASE)
    return dict(lease.spec) if lease is not None else {}


def _elector_script(server_root: str, a_root: str, b_root: str) -> list:
    """The scenario on one apiserver, elector A of ``a_root``, B of
    ``b_root``; returns what each step saw."""
    server = mod(server_root, "cluster.apiserver").APIServer().start()
    stores = [mod(r, "cluster.client").HttpStore(server.address) for r in (a_root, b_root)]
    a, b = (mod(r, "cluster.lease").LeaseElector(s, identity=ident, **TIMING)
            for r, s, ident in zip((a_root, b_root), stores, ("op-a", "op-b")))
    trace = []

    def note(step, *got):
        spec = _lease(stores[0])
        trace.append((step, got, spec.get("holderIdentity"), spec.get("leaseTransitions"),
                      spec.get("leaseDurationSeconds")))

    try:
        note("race", a.try_acquire(), b.try_acquire(), a.is_leader, b.is_leader)
        note("live", b.try_acquire(), a.renew())
        a.release()
        note("release", a.is_leader, b.try_acquire(), b.is_leader)
        # B crashes: its renewer halts and the holder stays set; A must see
        # renewTime stand still for a full lease duration on its own clock
        b.stop_renewing()
        t0 = time.monotonic()
        first = a.try_acquire()
        wait_for(a.try_acquire, timeout=10.0, msg="no takeover after expiry")
        waited = time.monotonic() - t0
        note("expiry", first, waited >= TIMING["lease_duration"], a.is_leader)
        note("deposed", b.renew(), b.is_leader, a.renew())
        a.release()
        note("end", a.is_leader)
    finally:
        for s in stores:
            s.stop()
        server.stop()
    return trace


@pytest.mark.parametrize("server_root,a_root,b_root", [
    ("grove_tpu", "grove_tpu", "grove_tpu_torch"),
    ("grove_tpu", "grove_tpu_torch", "grove_tpu"),
    ("grove_tpu_torch", "grove_tpu", "grove_tpu_torch"),
    ("grove_tpu_torch", "grove_tpu_torch", "grove_tpu_torch"),
])
def test_mixed_electors_exclude_each_other_as_the_jax_pair(server_root, a_root, b_root):
    got = _elector_script(server_root, a_root, b_root)
    assert got == _elector_script("grove_tpu", "grove_tpu", "grove_tpu")
    steps = dict((s[0], s) for s in got)
    assert steps["race"][1] == (True, False, True, False)
    assert steps["release"][2:4] == ("op-b", 1)
    assert steps["expiry"][1] == (False, True, True) and steps["expiry"][2:4] == ("op-a", 2)
    assert steps["deposed"][1] == (False, False, True)
    assert steps["end"][2:4] == ("", 2)


def test_renew_survives_blips_within_the_deadline():
    from grove_tpu_torch.cluster.apiserver import APIServer
    from grove_tpu_torch.cluster.client import HttpStore
    from grove_tpu_torch.cluster.lease import LeaseElector
    from grove_tpu_torch.runtime.errors import GroveError

    server = APIServer().start()
    store = HttpStore(server.address)
    a, b = (LeaseElector(store, identity=i, **TIMING) for i in ("op-a", "op-b"))
    calls = {"n": 0}

    def flaky_get():
        calls["n"] += 1
        raise GroveError("ERR_TRANSPORT", "connection reset", "get")

    try:
        assert a.try_acquire()
        orig, a._get = a._get, flaky_get
        assert a.renew() and a.is_leader  # inside the deadline: still leading
        a._last_renew_ok -= 10.0
        assert not a.renew() and not a.is_leader  # past it: step down
        a._get = orig
        b._get = flaky_get
        assert not b.try_acquire()  # campaigning through errors never raises
        assert calls["n"] >= 3
    finally:
        store.stop()
        server.stop()


@pytest.fixture
def ha_pair():
    """Port operator A (embedded apiserver) and port operator B (A's
    client), both campaigning for one lease."""
    from grove_tpu_torch.cluster.manager import start_operator
    from grove_tpu_torch.config.operator import OperatorConfiguration

    cfg = OperatorConfiguration()
    cfg.leader_election.enabled = True
    for key, value in TIMING.items():
        setattr(cfg.leader_election, key, value)
    a = start_operator(config=cfg, with_webhooks=False, leader_identity="op-a", device="cpu")
    b = start_operator(config=cfg, with_webhooks=False, apiserver_url=a.store.base_url,
                       leader_identity="op-b", device="cpu")
    try:
        yield a, b
    finally:
        b.shutdown()
        a.shutdown()


def _simple1(root: str):
    pcs = mod(root, "api.load").load_podcliqueset_file(str(REPO / "samples" / "simple1.yaml"))
    mod(root, "admission.defaulting").default_podcliqueset(pcs)
    return pcs


def test_readopting_its_own_lease_restarts_the_renewer(ha_pair):
    a, _ = ha_pair
    assert a.elector.try_acquire()
    a.elector.stop_renewing()
    a.elector.is_leader = False
    assert a.elector.try_acquire() and a.elector.is_leader
    t0 = _lease(a.store)["renewTime"]
    wait_for(lambda: _lease(a.store)["renewTime"] > t0, timeout=5.0,
             msg="the renewer did not restart")


def test_deposed_leader_acts_not_and_standby_publishes_nothing():
    from grove_tpu_torch.api.topology import default_cluster_topology
    from grove_tpu_torch.cluster.manager import start_operator
    from grove_tpu_torch.config.operator import OperatorConfiguration

    cfg = OperatorConfiguration()
    cfg.leader_election.enabled = True
    for key, value in TIMING.items():
        setattr(cfg.leader_election, key, value)
    t_leader, t_other = default_cluster_topology(), default_cluster_topology()
    t_other.spec.levels = t_other.spec.levels[2:]
    a = start_operator(config=cfg, with_webhooks=False, topology=t_leader,
                       leader_identity="op-a", device="cpu")
    b = start_operator(config=cfg, with_webhooks=False, apiserver_url=a.store.base_url,
                       topology=t_other, leader_identity="op-b", device="cpu")
    try:
        assert a.store.get("ClusterTopology", "", "default") is None  # no leader yet
        assert a.elector.try_acquire()
        a.converge_once()
        assert len(a.store.get("ClusterTopology", "", "default").spec.levels) == len(
            t_leader.spec.levels)
        assert not b.elector.try_acquire() and b.converge_once() == 0
        assert len(a.store.get("ClusterTopology", "", "default").spec.levels) == len(
            t_leader.spec.levels)
        a.elector.stop_renewing()
        wait_for(b.elector.try_acquire, timeout=10.0, msg="no takeover")
        a.elector.is_leader = False  # what A's own renew would conclude
        assert a.converge_once() == 0
    finally:
        b.shutdown()
        a.shutdown()


def test_failover_learns_bindings_and_standby_drops_its_backlog(ha_pair):
    a, b = ha_pair
    assert a.elector.try_acquire()
    a.store.create(_simple1("grove_tpu_torch"))
    for _ in range(30):
        if a.cluster.bindings and all(p.status.phase == "Running"
                                      for p in a.store.list("Pod", "default")):
            break
        a.converge_once()
    assert a.cluster.bindings
    wait_for(lambda: len(b.engine._event_backlog) > 0, msg="the standby saw no event")
    assert b.engine.discard_pending_events() > 0 and len(b.engine._event_backlog) == 0
    assert not b.cluster.bindings
    assert b.cluster.rebuild_bindings() == len(a.cluster.bindings)
    assert b.cluster.bindings == a.cluster.bindings
    free_a = {n.name: a.cluster.node_free(n) for n in a.cluster.nodes}
    assert {n.name: b.cluster.node_free(n) for n in b.cluster.nodes} == free_a


@pytest.mark.parametrize("a_root", ["grove_tpu_torch", "grove_tpu"])
def test_run_loops_hand_over_to_a_port_standby(a_root):
    """Both run loops campaign; one leads; stopping it hands over, and the
    new leader (always the port's when A is the JAX operator) reconciles a
    manifest through the shared apiserver."""
    cfg = mod(a_root, "config.operator").OperatorConfiguration()
    cfg.leader_election.enabled = True
    for key, value in TIMING.items():
        setattr(cfg.leader_election, key, value)
    kw_a = {"device": "cpu"} if a_root.endswith("torch") else {}
    a = mod(a_root, "cluster.manager").start_operator(
        config=cfg, with_webhooks=False, leader_identity="op-a", **kw_a)
    from grove_tpu_torch.cluster.manager import start_operator
    from grove_tpu_torch.config.operator import OperatorConfiguration

    cfg_b = OperatorConfiguration()
    cfg_b.leader_election.enabled = True
    for key, value in TIMING.items():
        setattr(cfg_b.leader_election, key, value)
    b = start_operator(config=cfg_b, with_webhooks=False, apiserver_url=a.store.base_url,
                       leader_identity="op-b", device="cpu")
    stops = {"a": threading.Event(), "b": threading.Event()}
    threads = [threading.Thread(target=rt.run, args=(stops[k],), daemon=True)
               for k, rt in (("a", a), ("b", b))]
    try:
        if a_root == "grove_tpu":
            assert a.elector.try_acquire()  # the JAX operator leads first
        for t in threads:
            t.start()
        wait_for(lambda: a.elector.is_leader or b.elector.is_leader, msg="no leader")
        time.sleep(0.3)
        assert a.elector.is_leader != b.elector.is_leader
        leader, standby = ("a", b) if a.elector.is_leader else ("b", a)
        stops[leader].set()
        wait_for(lambda: standby.elector.is_leader, msg="the standby never took over")
        doc = yaml.safe_load((REPO / "samples" / "simple1.yaml").read_text())
        root = "grove_tpu_torch" if standby is b else a_root
        obj = mod(root, "api.wire").decode_object(doc)
        mod(root, "admission.defaulting").default_podcliqueset(obj)
        standby.store.create(obj)
        wait_for(lambda: standby.store.list("Pod", "default"), timeout=30.0,
                 msg="the new leader did not reconcile")
        assert _lease(b.store)["holderIdentity"] == ("op-a" if standby is a else "op-b")
        assert _lease(b.store)["leaseTransitions"] >= 1
    finally:
        for ev in stops.values():
            ev.set()
        for t in threads:
            t.join(timeout=5)
        b.shutdown()
        a.shutdown()
