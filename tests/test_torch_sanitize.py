"""The port's runtime sanitizer (``analysis/sanitize.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_sanitize.py`` on the port's objects and
singletons: each dynamic check detects its failure class (a lock-order
inversion, direct, transitive or across threads; a leaked span through
the tracer's ``SPAN_HOOK``; accountant drift; a stranded hold), the
violation lists equal the JAX tracker's on the same acquisitions,
``install`` / ``uninstall`` wrap and restore the port's singleton locks,
the environment and the tracer, and a sanitized converge stays green. Then
the chaos matrix's sanitized seed (42) through both packages: equal
reports, no problem found.
"""

import os
import threading

import pytest

from grove_tpu.analysis import sanitize as jax_sanitize
from grove_tpu_torch.analysis import sanitize
from tests.torch_sim_sides import sim_side


def _orders(mod, script):
    """Run ``script`` (lists of nested lock names) on ``mod``'s tracker;
    returns (violations, observed order)."""
    t = mod.LockOrderTracker()
    locks = {}

    def lock(name):
        if name not in locks:
            locks[name] = mod.TrackingLock(threading.RLock(), name, t)
        return locks[name]

    for outer, inner in script:
        with lock(outer):
            with lock(inner):
                pass
    return t.violations, t.observed_order()


class TestLockOrderTracker:
    @pytest.mark.parametrize("script,violations", [
        ([("A", "B")] * 3, 0),
        ([("A", "B"), ("B", "A")], 1),
        ([("A", "B"), ("B", "C"), ("C", "A")], 1),
        ([("A", "A")], 0),
    ], ids=["consistent", "inversion", "transitive", "reentrant"])
    def test_tracker_equals_jax(self, script, violations):
        port = _orders(sanitize, script)
        assert port == _orders(jax_sanitize, script)
        assert len(port[0]) == violations
        if violations:
            assert "inversion" in port[0][0]

    def test_cross_thread_order_is_global(self):
        t = sanitize.LockOrderTracker()
        a = sanitize.TrackingLock(threading.Lock(), "A", t)
        b = sanitize.TrackingLock(threading.Lock(), "B", t)

        def t1():
            with a:
                with b:
                    pass

        th = threading.Thread(target=t1)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with b:
            with a:
                pass
        assert len(t.violations) == 1


class TestInstallUninstall:
    def test_span_leak_detection(self, monkeypatch):
        from grove_tpu_torch.observability import tracing
        from grove_tpu_torch.observability.tracing import TRACER

        monkeypatch.delenv("GROVE_TPU_SANITIZE", raising=False)
        san = sanitize.install()
        try:
            assert tracing.SPAN_HOOK is san and TRACER.enabled
            leaky = TRACER.span("leaky-span")
            with TRACER.span("closed-span"):
                pass
            assert san.spans.leaked() == ["leaky-span"]
            assert any("leaked span" in p for p in san.problems())
            leaky.end()
            assert san.spans.leaked() == [] and san.problems() == []
        finally:
            sanitize.uninstall()
        assert not sanitize.active()
        assert tracing.SPAN_HOOK is None and not TRACER.enabled
        TRACER.reset()

    def test_install_wraps_singleton_locks(self, monkeypatch):
        from grove_tpu_torch.api import hashing
        from grove_tpu_torch.observability.events import EVENTS
        from grove_tpu_torch.observability.metrics import METRICS
        from grove_tpu_torch.observability.tracing import TRACER

        monkeypatch.delenv("GROVE_TPU_SANITIZE", raising=False)
        sanitize.install()
        try:
            for holder, attr in ((EVENTS, "_lock"), (METRICS, "_lock"), (TRACER, "_lock"),
                                 (hashing, "_EVICT_LOCK")):
                assert isinstance(getattr(holder, attr), sanitize.TrackingLock), attr
            assert os.environ["GROVE_TPU_SANITIZE"] == "1"
            assert sanitize.enabled() and sanitize.store_guard_enabled()
            EVENTS.record(("Pod", "default", "p"), "Normal", "PodBound", "x")
            METRICS.inc("sanitize_test_counter")
            assert sanitize.install() is sanitize.SANITIZER  # idempotent
        finally:
            sanitize.uninstall()
            TRACER.reset()
        for holder, attr in ((EVENTS, "_lock"), (METRICS, "_lock"), (TRACER, "_lock"),
                             (hashing, "_EVICT_LOCK")):
            assert not isinstance(getattr(holder, attr), sanitize.TrackingLock), attr
        assert "GROVE_TPU_SANITIZE" not in os.environ

    def test_uninstall_restores_externally_set_env(self, monkeypatch):
        monkeypatch.setenv("GROVE_TPU_SANITIZE", "1")
        sanitize.install()
        sanitize.uninstall()
        assert os.environ.get("GROVE_TPU_SANITIZE") == "1"
        assert sanitize.store_guard_enabled()

    @pytest.mark.parametrize("sanitize_env,guard_env", [
        (None, None), ("1", None), (None, "1"), ("0", "false"), ("true", None)])
    def test_switches_equal_jax(self, monkeypatch, sanitize_env, guard_env):
        for name, value in (("GROVE_TPU_SANITIZE", sanitize_env),
                            ("GROVE_TPU_STORE_GUARD", guard_env)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        assert sanitize.enabled() == jax_sanitize.enabled()
        assert sanitize.store_guard_enabled() == jax_sanitize.store_guard_enabled()


_TINY = """
apiVersion: grove.io/v1alpha1
kind: PodCliqueSet
metadata:
  name: tiny
spec:
  template:
    cliques:
      - name: w
        spec:
          roleName: w
          replicas: 1
          podSpec:
            containers:
              - name: c
                resources:
                  requests:
                    cpu: 1
"""


class TestHarnessChecks:
    @pytest.fixture()
    def harness(self):
        from grove_tpu_torch.sim.harness import SimHarness

        h = SimHarness(num_nodes=4, device="cpu")
        h.apply_yaml(_TINY)
        h.converge(max_ticks=40)
        yield h
        h.engine.close()

    def test_accountant_drift_clean_after_converge(self, harness):
        assert sanitize.accountant_drift(harness.scheduler.quota.accountant, harness.store) == []

    def test_accountant_drift_detects_skew(self, harness):
        acct = harness.scheduler.quota.accountant
        acct.ensure_built(harness.store)
        snap = acct.snapshot()
        assert snap
        queue = next(iter(snap))
        resource = next(iter(snap[queue]))
        acct._usage[queue][resource] += 1.5
        problems = sanitize.accountant_drift(acct, harness.store)
        assert problems and "!= recount" in problems[0]
        acct._usage[queue][resource] -= 1.5

    def test_stranded_hold_detected(self, harness):
        monitor = harness.node_monitor
        assert sanitize.stranded_holds(monitor) == []
        monitor._held.add(("default", "phantom-gang"))
        problems = sanitize.stranded_holds(monitor)
        assert problems and "stranded" in problems[0]
        monitor._held.discard(("default", "phantom-gang"))

    def test_harness_problems_green_on_healthy_tree(self, harness):
        assert sanitize.harness_problems(harness) == []


def test_sanitized_chaos_seed_equals_jax_and_finds_nothing(monkeypatch):
    """The chaos matrix's sanitized seed: lock order, leaked spans,
    stranded holds, accountant drift and the store guard over a whole
    chaos run, in both packages."""
    monkeypatch.delenv("GROVE_TPU_SANITIZE", raising=False)
    out = []
    for side, kw in ((sim_side("grove_tpu"), {}),
                     (sim_side("grove_tpu_torch", device="cpu"), {"device": "cpu"})):
        side.reset_uid_namespace()
        side.METRICS.reset()
        side.EVENTS.reset()
        side.sanitize.install()
        try:
            doc = side.chaos.run_chaos(seed=42, **kw).as_dict()
        finally:
            side.sanitize.uninstall()
            side.TRACER.reset()
        doc.pop("recovery_wall_seconds")
        out.append(doc)
    jax, port = out
    assert port == jax
    assert port["invariant_violations"] == [] and port["ok"]


def test_one_home_for_the_switches():
    import importlib.util

    from grove_tpu_torch.runtime import store
    from grove_tpu_torch.solver import deltastate

    assert importlib.util.find_spec("grove_tpu_torch.utils.sanitize") is None
    assert store.store_guard_enabled is sanitize.store_guard_enabled
    assert deltastate.sanitize_enabled is sanitize.enabled
