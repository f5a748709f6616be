"""The port's quota subsystem against the JAX package's, on the CPU.

The DRF order's plain twin (``grove_tpu_torch.quota.ordering``) against the
JAX scan and the oracle, bit for bit, over ``tests/test_quota.py``'s 200
random queue trees (its generator, seed 7) and the tie, zero-deserved,
empty, drained and no-resource cases; the kernel's two-phase plain version
(share table, then merge) against both, on the same trees, on
``chip_smoke.drf_edge_trees`` and above 1,024 queues; ``QuotaManager.order_specs``
and the usage accountant against the JAX package's on the same inputs.
"""

import numpy as np
import pytest
import torch

from chip_smoke import drf_edge_trees, past_g_tree, wide_queue_tree
from grove_tpu.api.wire import decode_object as jax_decode
from grove_tpu.quota.accountant import QuotaAccountant as JaxAccountant
from grove_tpu.quota.manager import QuotaManager as JaxQuotaManager
from grove_tpu.quota.oracle import fair_order_oracle, usage_oracle as jax_usage_oracle
from grove_tpu.quota.ordering import _compiled, fair_order as jax_fair_order
from grove_tpu.runtime.clock import VirtualClock as JaxClock
from grove_tpu.runtime.store import Store as JaxStore
from grove_tpu_torch.api.wire import decode_object
from grove_tpu_torch.models.scenarios import queue_docs
from grove_tpu_torch.quota import oracle as port_oracle
from grove_tpu_torch.quota.accountant import QuotaAccountant
from grove_tpu_torch.quota.manager import QuotaManager
from grove_tpu_torch.quota.ordering import (
    fair_order,
    fair_order_merge_ref,
    fair_order_ref,
    fair_order_scan,
    merge_cuda,
    share_table_cuda,
    share_table_ref,
)
from grove_tpu_torch.runtime.clock import VirtualClock
from grove_tpu_torch.runtime.store import Store

Q, G, R = 8, 16, 4  # tests/test_quota.py's padded shape


def random_tree(rng):
    """tests/test_quota.py TestOrderingEquivalence._random_case."""
    n_q = int(rng.integers(1, Q + 1))
    n_r = int(rng.integers(1, R + 1))
    deserved = np.zeros((Q, R), np.float32)
    usage = np.zeros((Q, R), np.float32)
    demand = np.zeros((Q, G, R), np.float32)
    counts = np.zeros((Q,), np.int32)
    for q in range(n_q):
        if rng.random() > 0.25:
            deserved[q, :n_r] = rng.integers(0, 5, n_r)
        if rng.random() > 0.3:
            usage[q, :n_r] = rng.integers(0, 9, n_r) * rng.choice([0.25, 0.5, 1.0, 2.0])
        counts[q] = rng.integers(0, G + 1)
        demand[q, :, :n_r] = rng.integers(0, 4, (G, n_r)) * rng.choice([0.5, 1.0])
    if n_q >= 2 and rng.random() > 0.5:
        src, dst = rng.choice(n_q, 2, replace=False)
        deserved[dst] = deserved[src]
        usage[dst] = usage[src]
    return deserved, usage, demand, counts


def random_trees():
    rng = np.random.default_rng(7)
    return [random_tree(rng) for _ in range(200)]


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_twin_matches_jax_and_oracle_on_random_trees():
    for trial, (deserved, usage, demand, counts) in enumerate(random_trees()):
        got = fair_order(deserved, usage, demand, counts, device="cpu")
        np.testing.assert_array_equal(
            got, jax_fair_order(deserved, usage, demand, counts), err_msg=f"trial {trial}"
        )
        np.testing.assert_array_equal(
            got, fair_order_oracle(deserved, usage, demand, counts), err_msg=f"trial {trial}"
        )


def test_raw_scan_matches_jax_scan_rows_with_drained_tail():
    """All Q*G steps of the scan, (-1, -1) rows after every queue drains
    included, equal the JAX scan's untrimmed rows."""
    run = _compiled(Q, G, R)
    for trial, (deserved, usage, demand, counts) in enumerate(random_trees()[:40]):
        want = np.asarray(run(deserved, usage, demand, counts))
        got = fair_order_scan(*_tensors(deserved, usage, demand, counts), Q * G)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"trial {trial}")


@pytest.mark.parametrize(
    "case",
    ["tie", "zero_deserved", "empty", "drained", "no_resources", "overflow_to_inf"],
)
def test_edge_cases_match_jax_and_oracle(case):
    if case == "tie":
        deserved = np.array([[2.0], [2.0]], np.float32)
        usage = np.zeros((2, 1), np.float32)
        demand = np.ones((2, 4, 1), np.float32)
        counts = np.array([4, 4], np.int32)
    elif case == "zero_deserved":
        deserved = np.array([[4.0], [0.0]], np.float32)
        usage = np.zeros((2, 1), np.float32)
        demand = np.ones((2, 3, 1), np.float32)
        counts = np.array([3, 3], np.int32)
    elif case == "empty":
        deserved = usage = np.zeros((0, 2), np.float32)
        demand = np.zeros((0, 4, 2), np.float32)
        counts = np.zeros((0,), np.int32)
    elif case == "drained":
        deserved = np.ones((2, 1), np.float32)
        usage = np.zeros((2, 1), np.float32)
        demand = np.ones((2, 2, 1), np.float32)
        counts = np.array([0, 0], np.int32)
    elif case == "no_resources":
        # the r_dim == 0 branch: shares all 0, queue-index round robin
        deserved = usage = np.zeros((3, 0), np.float32)
        demand = np.zeros((3, 2, 0), np.float32)
        counts = np.array([2, 1, 2], np.int32)
    else:
        # zero-deserved usage*BIG overflows to +inf: every active key is
        # +inf, so the argmin falls on the lowest index, drained or not
        deserved = np.array([[0.0], [0.0], [1.0]], np.float32)
        usage = np.array([[0.0], [1e21], [1e30]], np.float32)
        demand = np.ones((3, 2, 1), np.float32)
        counts = np.array([0, 2, 0], np.int32)
    got = fair_order(deserved, usage, demand, counts, device="cpu")
    want = jax_fair_order(deserved, usage, demand, counts)
    np.testing.assert_array_equal(got, want)
    if case not in ("no_resources", "overflow_to_inf"):
        np.testing.assert_array_equal(got, fair_order_oracle(deserved, usage, demand, counts))
    if case == "tie":
        assert got[:, 0].tolist() == [0, 1, 0, 1, 0, 1, 0, 1]


def test_ref_runs_the_twin_on_cpu_tensors_and_never_counts():
    deserved, usage, demand, counts = random_trees()[3]
    share_table_cuda.launches = merge_cuda.launches = 0
    a = fair_order_scan(*_tensors(deserved, usage, demand, counts), 20)
    b = fair_order_ref(*_tensors(deserved, usage, demand, counts), 20)
    assert torch.equal(a, b)
    assert share_table_cuda.launches == merge_cuda.launches == 0


# -- the kernel's two phases (share table, then merge) -------------------------


def _merge_matches(deserved, usage, demand, counts, steps):
    """The two-phase version against the step twin over ``steps`` steps and
    against the JAX scan's untrimmed rows (it runs Q*G steps) and its
    trimmed order."""
    q_dim, g_dim, r_dim = demand.shape
    tensors = _tensors(deserved, usage, demand, counts)
    got = fair_order_merge_ref(*tensors, steps)
    assert torch.equal(got, fair_order_ref(*tensors, steps))
    scan = np.asarray(_compiled(q_dim, g_dim, r_dim)(deserved, usage, demand, counts))
    n = min(steps, len(scan))
    np.testing.assert_array_equal(got.numpy()[:n], scan[:n])
    total = int(counts.sum())
    if total <= min(steps, q_dim * g_dim):
        np.testing.assert_array_equal(
            got.numpy()[:total], jax_fair_order(deserved, usage, demand, counts))
    return got


@pytest.mark.parametrize("part", range(4))
def test_merge_ref_matches_jax_and_twin_on_random_trees(part):
    for deserved, usage, demand, counts in random_trees()[part * 50:(part + 1) * 50]:
        _merge_matches(deserved, usage, demand, counts, Q * G)


@pytest.mark.parametrize("case", sorted(drf_edge_trees()))
def test_merge_ref_edge_cases_match_jax_and_twin(case):
    deserved, usage, demand, counts, steps = drf_edge_trees()[case]
    got = _merge_matches(deserved, usage, demand, counts, steps)
    if case == "signed_zero_tie":
        assert got[:, 0].tolist() == [0, 0, 0, 1, 1, 1]
    if case == "overflow_to_inf":  # queue 0 is drained but wins every +inf tie
        assert got.tolist() == [[0, k] for k in range(6)]
    if case == "drained_before_t":
        assert (got[int(counts.sum()):] == -1).all()


@pytest.mark.parametrize("q_dim", [1025, 2048])
def test_merge_ref_matches_jax_above_1024_queues(q_dim):
    deserved, usage, demand, counts = wide_queue_tree(q_dim, q_dim)
    got = _merge_matches(deserved, usage, demand, counts, q_dim * demand.shape[1])
    assert (got[: int(counts.sum()), 0] >= 0).all()


@pytest.mark.parametrize("q_dim", [8, 64, 1025])
def test_merge_ref_matches_jax_past_g(q_dim):
    """Every fifth queue holds more pending gangs than G: past its table row
    the merge charges demand row G-1 to the tail, as the gather clamps."""
    deserved, usage, demand, counts = past_g_tree(q_dim)
    _merge_matches(deserved, usage, demand, counts, int(counts.sum()) + 4)


def test_share_table_is_the_twins_shares_per_charge():
    """Entry [q, k] of the table is the dominant share of queue q after its
    first k charges, as the JAX step computes it; the tail is the usage
    after G charges."""
    deserved, usage, demand, counts = random_trees()[5]
    table, tail = share_table_ref(*_tensors(deserved, usage, demand))
    safe = np.where(deserved > 0, deserved, np.float32(1.0))
    u = usage.copy()
    for k in range(G):
        share = np.where(deserved > 0, u / safe, u * np.float32(1e18)).max(axis=1)
        np.testing.assert_array_equal(table[:, k].numpy(), share)
        u = u + demand[:, k]
    np.testing.assert_array_equal(tail.numpy(), u)


def test_fair_order_without_a_device_needs_a_card():
    deserved, usage, demand, counts = random_trees()[0]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fair_order(deserved, usage, demand, np.ones((Q,), np.int32))


# -- QuotaManager.order_specs ---------------------------------------------------


def _random_specs(rng, n, queues):
    specs = []
    for i in range(n):
        groups = [
            {
                "name": f"g{i}-{p}",
                "demand": {"cpu": float(rng.integers(1, 5)) * 0.5,
                           "tpu": float(rng.integers(0, 3))},
                "count": int(rng.integers(1, 4)),
                "min_count": 1,
            }
            for p in range(int(rng.integers(1, 3)))
        ]
        specs.append({
            "name": f"ns/gang-{i:03d}",
            "gang_name": f"gang-{i:03d}",
            "namespace": "ns",
            "groups": groups,
            "priority": int(rng.integers(0, 3)),
            "queue": queues[int(rng.integers(0, len(queues)))],
        })
    return specs


@pytest.mark.parametrize("ceilings", [False, True], ids=["no_ceiling", "ceilings"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_specs_matches_jax(seed, ceilings):
    rng = np.random.default_rng(seed)
    deserved = {"team-a": {"cpu": 8.0, "tpu": 4.0}, "team-b": {"cpu": 4.0},
                "team-c": {"tpu": 2.0}, "team-z": {}}
    ceiling = {"team-a": {"cpu": 9.0}, "team-c": {"tpu": 3.0, "cpu": 6.0}} if ceilings else None
    docs = queue_docs(deserved, ceiling)
    # team-x has gangs and usage but no Queue CR (an implicit queue)
    specs = _random_specs(rng, 40, ["team-a", "team-b", "team-c", "team-z", "team-x"])
    usage = {"team-a": {"cpu": 3.0, "tpu": 1.0}, "team-b": {"cpu": 5.0},
             "team-x": {"cpu": 1.0, "memory": 2.0}}

    jax_store = JaxStore(JaxClock(0.0))
    jax_mgr = JaxQuotaManager(jax_store)
    jax_crs = {d["metadata"]["name"]: jax_decode(d) for d in docs}
    port_mgr = QuotaManager(Store(VirtualClock(0.0)), device="cpu")
    port_crs = {d["metadata"]["name"]: decode_object(d) for d in docs}

    for _ in range(2):  # twice: the sticky pads carry over
        want_order, want_held = jax_mgr.order_specs(specs, crs=jax_crs, usage=usage)
        got_order, got_held = port_mgr.order_specs(specs, crs=port_crs, usage=usage)
        assert [s["name"] for s in got_order] == [s["name"] for s in want_order]
        assert [(s["name"], why) for s, why in got_held] == [
            (s["name"], why) for s, why in want_held
        ]
        strip = [({k: v for k, v in row.items() if k != "cr"},
                  row["cr"] is None or row["cr"].metadata.name) for row in jax_mgr.last_rows]
        assert [({k: v for k, v in row.items() if k != "cr"},
                 row["cr"] is None or row["cr"].metadata.name)
                for row in port_mgr.last_rows] == strip
        assert (port_mgr._pad_q, port_mgr._pad_g, port_mgr._pad_r) == (
            jax_mgr._pad_q, jax_mgr._pad_g, jax_mgr._pad_r)
        if ceilings:
            assert want_held, "the ceilings held nothing"
        specs = specs[: len(specs) // 2]


def test_order_specs_without_queues_is_the_flat_sort():
    rng = np.random.default_rng(5)
    specs = _random_specs(rng, 30, ["team-a"])
    port_mgr = QuotaManager(Store(VirtualClock(0.0)), device="cpu")
    ordered, held = port_mgr.order_specs(specs)
    assert held == [] and port_mgr.last_rows == []
    assert ordered == sorted(specs, key=lambda s: (-s["priority"], s["name"]))


# -- the usage accountant ---------------------------------------------------------


def _pod_doc(name, queue, requests):
    labels = {"scheduler.grove.io/queue": queue} if queue else {}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "ns", "labels": labels},
            "spec": {"containers": [{"name": "c", "requests": requests}]}}


def _storm(store, decode, bind, rng_seed=3):
    """tests/test_quota.py's event storm on either package's store."""
    rng = np.random.default_rng(rng_seed)
    queues = ["team-a", "team-b", "team-c", None]
    live = []
    checkpoints = []
    for step in range(300):
        op = rng.random()
        if op < 0.45 or not live:
            name = f"p{step}"
            q = queues[int(rng.integers(0, len(queues)))]
            store.create(decode(_pod_doc(name, q, {"cpu": float(rng.integers(1, 5)) * 0.25,
                                                   "tpu": float(rng.integers(0, 3))})))
            live.append(name)
            if rng.random() < 0.8:
                bind(name)
        elif op < 0.8:
            bind(live[int(rng.integers(0, len(live)))])
        else:
            store.delete("Pod", "ns", live.pop(int(rng.integers(0, len(live)))))
        if step % 25 == 0:
            yield step
    for name in list(live):
        store.delete("Pod", "ns", name)
    yield "drained"


def test_accountant_matches_jax_and_usage_oracle_over_event_storm():
    from grove_tpu.api.meta import Condition as JaxCondition, set_condition as jax_set
    from grove_tpu_torch.api.meta import Condition, set_condition

    jax_store = JaxStore(JaxClock(0.0))
    jax_acc = JaxAccountant()
    jax_store.subscribe_system(jax_acc.on_event)
    jax_acc.ensure_built(jax_store)
    port_store = Store(VirtualClock(0.0))
    port_acc = QuotaAccountant()
    port_store.subscribe_system(port_acc.on_event)
    port_acc.ensure_built(port_store)

    def binder(store, cond_cls, setter):
        def bind(name):
            pod = store.get("Pod", "ns", name)
            setter(pod.status.conditions,
                   cond_cls(type="PodScheduled", status="True", reason="Bound"),
                   store.clock.now())
            store.update_status(pod)
        return bind

    jax_steps = _storm(jax_store, jax_decode, binder(jax_store, JaxCondition, jax_set))
    port_steps = _storm(port_store, decode_object, binder(port_store, Condition, set_condition))
    for a, b in zip(jax_steps, port_steps):
        assert a == b
        got = port_acc.snapshot()
        assert got == jax_acc.snapshot(), a  # the same folds in the same order
        want = port_oracle.usage_oracle(port_store.scan("Pod"), "default")
        assert want == jax_usage_oracle(jax_store.scan("Pod"), "default"), a
        assert set(got) == set(want), a
        for queue in want:
            for r in set(want[queue]) | set(got[queue]):
                assert got[queue].get(r, 0.0) == pytest.approx(
                    want[queue].get(r, 0.0), abs=1e-9), (a, queue, r)
    assert port_acc.snapshot() == {}
