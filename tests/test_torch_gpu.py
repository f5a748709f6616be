"""Tests of the port that need the card (marked ``gpu``; skipped without CUDA).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

The CUDA fill kernel is held bit for bit against its plain PyTorch version,
alone and inside the solvers (the binding path, the stats path and the
exact kernel); each solver on the card is also held against the same solver
on the CPU (which the CPU tests hold against the JAX package).
"""

import numpy as np
import pytest
import torch

from chip_smoke import nonuniform_specs
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.models.scenarios import STRESS_CAPACITY, build_stress_problem
from grove_tpu_torch.ops import packing
from grove_tpu_torch.ops.fill import fill_batch, fill_batch_ref
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.dedup import dedup_extra_args, level_widths_of
from grove_tpu_torch.solver.encode import build_problem
from grove_tpu_torch.solver.kernel import (
    BENCH_CHUNK_SIZE,
    BENCH_MAX_WAVES,
    pad_problem_for_waves,
    solve,
    solve_waves,
    solve_waves_stats,
)

FIELDS = ("admitted", "placed", "score", "chosen_level", "alloc", "free_after")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fill kernel has no CPU mode)")
    return torch.device("cuda")


def _fill_inputs(seed, shared, density, c=32, p=3, n=5120, r=2):
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 129, (n, r) if shared else (c, n, r)).astype(np.float32)
    mask = rng.random((c, n)) < density
    demand = rng.integers(0, 9, (c, p, r)).astype(np.float32)
    demand[rng.random((c, p, r)) < 0.2] = 0.0
    count = rng.integers(0, 40, (c, p)).astype(np.int32)
    count[rng.random((c, p)) < 0.2] = 0
    return free, mask, demand, count


def _zero_counts(free, mask, demand, count):
    """Every count 0; some demands -0.0 (a zero take then turns a -0.0 of
    free into +0.0, so those groups must still be debited) beside -0.0s in
    free."""
    demand[:, ::2, 0] = -0.0
    free.reshape(-1)[::7] = -0.0
    count[:] = 0


def _fractional(free, mask, demand, count):
    """Capacities and demands over nine and six decades, not integers, so
    the fits' quotients land anywhere between floats."""
    rng = np.random.default_rng(11)
    free[:] = (10.0 ** rng.uniform(-3, 6, free.shape)).astype(np.float32)
    demand[:] = (10.0 ** rng.uniform(-3, 3, demand.shape)).astype(np.float32)
    count[:] = rng.integers(1, 5000, count.shape)


def _near_integer(free, mask, demand, count):
    """Per-gang capacities within two ulps of a whole multiple (0 to 299,
    and 2^20 - 2 to 2^20 + 2 on 1 % of nodes) of group 0's non-integer
    demand: each quotient lies next to an integer, where its floor depends
    on the last bit of the IEEE quotient. The count is never reached, so
    every fit shows in alloc."""
    rng = np.random.default_rng(12)
    demand[:] = (10.0 ** rng.uniform(-3, 3, demand.shape)).astype(np.float32)
    multiple = rng.integers(0, 300, free.shape)
    near_cap = rng.random(free.shape) < 0.01
    multiple[near_cap] = rng.integers((1 << 20) - 2, (1 << 20) + 3, int(near_cap.sum()))
    exact = (multiple * demand[:, :1, :].astype(np.float64)).astype(np.float32)
    nudge = rng.integers(-2, 3, free.shape).astype(np.int32)
    bits = np.where(exact == 0, np.abs(nudge), exact.view(np.int32) + nudge)
    free[:] = bits.astype(np.int32).view(np.float32)
    count[:] = 1 << 30


def _wrap(free, mask, demand, count):
    """Group 0 has no demand and a count of 2^30 on every node: its capped
    fits are 2^20 each, so the int32 prefix passes 2^31 and wraps."""
    mask[:] = True
    demand[:, 0] = 0.0
    count[:, 0] = 1 << 30


# (id, c, p, n, r, shared, density, with_free_after, change to the inputs)
KERNEL_CASES = [
    pytest.param(32, 3, 5120, 2, shared, density, True, None,
                 id=f"{'shared' if shared else 'per_gang'}-{density}")
    for shared in (True, False) for density in (0.0, 0.5, 1.0)
] + [
    # N not a multiple of K * blockDim (K=8, 320 threads, slices of 628)
    pytest.param(32, 3, 5000, 2, False, 0.5, True, None, id="ragged"),
    pytest.param(1, 2, 3, 2, True, 1.0, True, None, id="n_below_cluster"),  # K=8
    pytest.param(4, 2, 1, 1, False, 1.0, True, None, id="one_node"),
    pytest.param(1, 3, 5120, 2, True, 0.5, True, None, id="one_gang"),
    pytest.param(33, 3, 5120, 2, False, 0.5, True, None, id="33_gangs"),
    pytest.param(32, 1, 2048, 1, True, 0.7, True, None, id="p1_r1"),
    pytest.param(32, 4, 4096, 4, True, 0.7, True, None, id="p4_r4"),
    pytest.param(32, 3, 5120, 2, False, 0.5, True, _zero_counts, id="zero_counts"),
    pytest.param(8, 2, 5120, 2, True, 1.0, True, _wrap, id="int32_wrap"),
    pytest.param(32, 3, 5120, 2, False, 0.7, True, _fractional, id="fractional_r2"),
    pytest.param(32, 3, 5120, 3, True, 0.7, True, _fractional, id="fractional_r3"),
    pytest.param(32, 1, 5120, 1, False, 1.0, True, _near_integer, id="near_integer"),
    # K=1 and 54 KB of shared memory per CTA (above the 48 KB default)
    pytest.param(200, 3, 6144, 2, True, 0.5, True, None, id="smem_above_48k"),
    # K=1: 46 KB of dynamic and 2 KB of static shared memory
    pytest.param(133, 3, 5120, 2, False, 0.5, True, None, id="smem_48k_with_static"),
    # K=8 with 1,024 threads of 16 nodes each (the largest run)
    pytest.param(1, 2, 131072, 2, False, 0.5, True, None, id="run_16"),
    pytest.param(32, 3, 5120, 2, False, 0.5, False, None, id="no_free_after"),
    # the grouped fill's P=1 calls: one group, masks of about one ici-block,
    # per-gang capacity after the first group
    pytest.param(32, 1, 5120, 2, False, 0.0125, True, None, id="p1_per_gang"),
    pytest.param(32, 1, 5120, 2, False, 0.0125, False, None, id="p1_per_gang_no_free_after"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("c,p,n,r,shared,density,with_free_after,change", KERNEL_CASES)
def test_cuda_kernel_matches_plain_version(cuda, c, p, n, r, shared, density,
                                           with_free_after, change):
    arrays = _fill_inputs(5, shared, density, c, p, n, r)
    if change is not None:
        change(*arrays)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = fill_batch.launches
    got = fill_batch(*args, with_free_after=with_free_after)
    torch.cuda.synchronize()
    assert fill_batch.launches == before + 1
    want = fill_batch_ref(*args, with_free_after=with_free_after)
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if not with_free_after:
        assert got[2] is None and want[2] is None
    else:  # bit for bit, so -0.0 and +0.0 differ
        assert got[2].dtype == want[2].dtype
        assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))
    if change is _wrap:  # the case really wraps: group 0's placed sum is negative
        assert bool((want[1][:, 0] < 0).all())


@pytest.mark.gpu
def test_cuda_kernel_rejects_wrong_dtype(cuda):
    free, mask, demand, count = _fill_inputs(6, True, 0.5)
    args = [torch.from_numpy(a).to(cuda) for a in (free, mask, demand, count.astype(np.int64))]
    with pytest.raises(TypeError, match="count"):
        fill_batch(*args)


@pytest.mark.gpu
def test_cuda_kernel_rejects_shape_beyond_shared_memory(cuda):
    """120,000 nodes of 4 resources do not fit 8 CTAs' shared memory."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _fill_inputs(7, True, 0.5, c=1, p=1, n=120_000, r=4)]
    before = fill_batch.launches
    with pytest.raises(ValueError, match="shared memory"):
        fill_batch(*args)
    assert fill_batch.launches == before


@pytest.mark.gpu
def test_cuda_solve_matches_plain_fill_and_cpu(cuda):
    problem = build_stress_problem(512, 1024)
    before = fill_batch.launches
    kern = solve_waves(problem, chunk_size=32, device=cuda)
    assert fill_batch.launches > before
    plain = solve_waves(problem, chunk_size=32, device=cuda, fill=fill_batch_ref)
    cpu = solve_waves(problem, chunk_size=32, device="cpu")
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(kern, name), getattr(plain, name), err_msg=name)
        np.testing.assert_array_equal(getattr(kern, name), getattr(cpu, name), err_msg=name)


def _flag_specs(kind, n_gangs, n_nodes, seed):
    """Gangs with one constraint kind: per-group ici-block packs
    (grouped), a slice pack pinned to a survivor (pinned), or a hard spread
    over ici-blocks inside a slice with survivors beside a soft spread over
    hosts (spread)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_gangs):
        groups = []
        for q in range(int(rng.integers(1, 4))):
            count = int(rng.integers(2, 6))
            groups.append({"name": f"{kind}{i}-{q}", "count": count,
                           "min_count": int(rng.integers(1, count + 1)),
                           "demand": {"tpu": float(rng.integers(1, 3)),
                                      "cpu": float(rng.integers(1, 9))}})
        spec = {"name": f"{kind}{i}", "groups": groups, "priority": 0,
                "required_key": None, "preferred_key": None}
        if kind == "grouped":
            for grp in groups:
                grp["required_key"] = "cloud.google.com/gke-tpu-ici-block"
        elif kind == "pinned":
            spec.update(required_key="cloud.google.com/gke-tpu-slice",
                        gang_pinned_node=f"node-{int(rng.integers(0, n_nodes))}")
        elif i % 2:
            spec.update(required_key="cloud.google.com/gke-tpu-slice",
                        spread_key="cloud.google.com/gke-tpu-ici-block",
                        spread_min_domains=3, spread_required=True)
            first = 8 * int(rng.integers(0, n_nodes // 8))
            spec["spread_survivor_nodes"] = [f"node-{first}", f"node-{first + 1}"]
        else:
            spec.update(spread_key="kubernetes.io/hostname", spread_min_domains=4)
        specs.append(spec)
    return specs


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["grouped", "pinned", "spread"])
def test_cuda_flag_solve_matches_plain_fill_and_cpu(cuda, kind):
    nodes = make_nodes(256, dict(STRESS_CAPACITY), 8, 8)  # contended: some gangs wait
    problem = build_problem(nodes, _flag_specs(kind, 384, 256, seed=3), ClusterTopology())
    flag = {"grouped": problem.group_req, "pinned": problem.gang_pin,
            "spread": problem.spread_level}[kind]
    assert (flag >= 0).any()
    before = fill_batch.launches
    kern = solve_waves(problem, chunk_size=32, device=cuda)
    assert fill_batch.launches > before
    plain = solve_waves(problem, chunk_size=32, device=cuda, fill=fill_batch_ref)
    cpu = solve_waves(problem, chunk_size=32, device="cpu")
    assert 0 < kern.admitted.sum() < len(problem.gang_names)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(kern, name), getattr(plain, name), err_msg=name)
        np.testing.assert_array_equal(getattr(kern, name), getattr(cpu, name), err_msg=name)


def _stats_problem(kind):
    """A contended cut of a smoke request: stress (demand dedup, slab fill,
    lazy rescue, an exact tail), non-uniform (eager rescue), or one of the
    flag kinds above."""
    if kind == "stress":
        return build_stress_problem(128, 1024)
    nodes = make_nodes(128, dict(STRESS_CAPACITY), 8, 8)
    specs = (nonuniform_specs(384, seed=2) if kind == "nonuniform"
             else _flag_specs(kind, 256, 128, 4))
    return build_problem(nodes, specs, ClusterTopology())


def _assert_same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        if name == "free_after":  # by the bits: -0.0 and +0.0 differ
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["stats", "exact"])
@pytest.mark.parametrize("kind", ["stress", "nonuniform", "grouped", "pinned", "spread"])
def test_cuda_stats_and_exact_match_plain_fill_and_cpu(cuda, kind, path):
    """solve_waves_stats and solve (no allocations) with the kernel equal
    the same solve with the plain fill on the card and on the CPU."""
    run = (solve_waves_stats if path == "stats"
           else lambda p, **kw: solve(p, with_alloc=False, **kw))
    problem = _stats_problem(kind)
    before = fill_batch.launches
    kern = run(problem, device=cuda)
    assert fill_batch.launches > before
    plain = run(problem, device=cuda, fill=fill_batch_ref)
    cpu = run(problem, device="cpu")
    assert 0 < kern.admitted.sum() < len(problem.gang_names)
    _assert_same(kern, plain)
    _assert_same(kern, cpu)


@pytest.mark.gpu
def test_cuda_exact_with_alloc_matches_cpu(cuda):
    problem = _stats_problem("grouped")
    _assert_same(solve(problem, device=cuda), solve(problem, device="cpu"))


def _no_sync_but_reads(monkeypatch):
    """CUDA's sync debug mode set to raise on every synchronizing call,
    except inside ``packing._host_int`` (the wave loop's one read)."""
    read = packing._host_int

    def read_synced(t):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(packing, "_host_int", read_synced)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stress", "nonuniform", "spread"])
def test_cuda_wave_loop_syncs_only_for_its_reads(cuda, kind, monkeypatch):
    """solve_waves_device on the card with the stream guarded: no device
    sync happens but the pending-count reads, and there is one per wave
    (plus the lazy rescue's epilogue check)."""
    problem = _stats_problem(kind)
    raw, n_chunks, grouped, pinned, spread, uniform = pad_problem_for_waves(
        problem, BENCH_CHUNK_SIZE)
    args = [torch.from_numpy(a).to(cuda) for a in raw]
    extra = {k: torch.from_numpy(v).to(cuda)
             for k, v in dedup_extra_args(raw[4], raw[5], n_chunks, pinned).items()}
    reads = []
    _no_sync_but_reads(monkeypatch)
    read = packing._host_int
    monkeypatch.setattr(packing, "_host_int", lambda t: reads.append(t) or read(t))
    try:
        out = packing.solve_waves_device(
            *args, **extra, n_chunks=n_chunks, max_waves=BENCH_MAX_WAVES, grouped=grouped,
            pinned=pinned, spread=spread, uniform=uniform, lazy_rescue=uniform,
            level_widths=level_widths_of(problem))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(reads) == out["waves"] + (1 if uniform else 0)
    assert out["waves"] >= 2 and int(out["admitted"].sum()) > 0


@pytest.mark.gpu
def test_cuda_exact_kernel_never_syncs(cuda, monkeypatch):
    """solve_packing is branch-free on the card: not one device sync."""
    problem = _stats_problem("spread")
    raw, *_ = pad_problem_for_waves(problem, 1)
    args = [torch.from_numpy(a).to(cuda) for a in raw]
    _no_sync_but_reads(monkeypatch)
    try:
        out = packing.solve_packing(*args[:16], with_alloc=False, spread=True,
                                    level_widths=level_widths_of(problem))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out["admitted"].sum()) > 0


# -- the DRF fair-share order (csrc/drf.cu) -------------------------------------


def _drf_check(inputs, steps, device):
    from grove_tpu_torch.quota.ordering import (
        fair_order_ref,
        fair_order_scan,
        merge_cuda,
        share_table_cuda,
    )

    cuda = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in inputs]
    launches = share_table_cuda.launches, merge_cuda.launches
    got = fair_order_scan(*cuda, steps).cpu()
    assert (share_table_cuda.launches, merge_cuda.launches) == (launches[0] + 1, launches[1] + 1)
    want = fair_order_ref(*[torch.from_numpy(np.ascontiguousarray(a)) for a in inputs], steps)
    assert torch.equal(got, want)
    return got


@pytest.mark.gpu
def test_cuda_drf_kernel_matches_twin_on_random_trees(cuda):
    """Every scan step (drained tails included) of tests/test_quota.py's
    200 random trees, bit for bit."""
    from chip_smoke import random_queue_tree

    rng = np.random.default_rng(7)
    for _ in range(200):
        tree = random_queue_tree(rng)
        _drf_check(tree, tree[2].shape[0] * tree[2].shape[1], cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dim", [1, 32, 33, 64, 1024, 1025, 2048, 4096])
def test_cuda_drf_kernel_matches_twin_at_warp_and_block_edges(cuda, q_dim):
    from chip_smoke import wide_queue_tree

    tree = wide_queue_tree(q_dim, q_dim)
    out = _drf_check(tree, q_dim * tree[2].shape[1], cuda)
    assert (out[: int(tree[3].sum()), 0] >= 0).all()


@pytest.mark.gpu
def test_cuda_drf_kernel_edge_inputs(cuda):
    """chip_smoke.drf_edge_trees against the twin: ties, a -0.0 against a
    +0.0 share, NaN usage, overflow of usage*BIG to +inf (the argmin then
    falls on the lowest index, drained or not), zero counts, every queue
    drained before the last step, counts above G."""
    from chip_smoke import drf_edge_trees
    from grove_tpu_torch.quota.ordering import fair_order

    for name, (*tree, steps) in drf_edge_trees().items():
        out = _drf_check(tree, steps, cuda)
        if name == "tie":
            assert out[:, 0].tolist() == [0, 1, 0, 1, 0, 1, 0, 1]
        if name == "signed_zero_tie":
            assert out[:, 0].tolist() == [0, 0, 0, 1, 1, 1]
    tie = drf_edge_trees()["tie"][:4]
    np.testing.assert_array_equal(fair_order(*tie, device=cuda), fair_order(*tie, device="cpu"))


@pytest.mark.gpu
def test_cuda_drf_share_table_matches_plain_keys(cuda):
    """Phase 1 alone: every table entry a merge can read (k < min(count, G))
    is the key of the plain share table's entry, and the tail of a queue
    with more pending gangs than G is the plain usage after G charges."""
    from chip_smoke import drf_edge_trees, random_queue_tree
    from grove_tpu_torch.quota.ordering import order_keys, share_table_cuda, share_table_ref

    rng = np.random.default_rng(7)
    trees = [random_queue_tree(rng) for _ in range(20)]
    trees += [drf_edge_trees()[name][:4] for name in ("counts_above_g", "forty_resources",
                                                      "nan_usage", "signed_zero_tie")]
    for deserved, usage, demand, counts in trees:
        arrays = [np.ascontiguousarray(a) for a in (deserved, usage, demand, counts)]
        table, tail = share_table_cuda(*[torch.from_numpy(a).to(cuda) for a in arrays])
        want, want_tail = share_table_ref(*[torch.from_numpy(a) for a in arrays[:3]])
        keys = table.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        want_keys = order_keys(want).numpy()
        for q, count in enumerate(counts):
            n = min(int(count), demand.shape[1])
            np.testing.assert_array_equal(keys[q, :n], want_keys[q, :n])
            if count > demand.shape[1]:
                assert torch.equal(tail[q].cpu(), want_tail[q])


@pytest.mark.gpu
@pytest.mark.parametrize("q_dim", [1025, 2048, 4096])
def test_cuda_drf_kernel_above_1024_queues(cuda, q_dim):
    """More than 1,024 queues (a thread owns several) with every share 0:
    every step a tie, which the lowest queue takes, against the twin."""
    zeros = [np.zeros((q_dim, 1), np.float32)] * 2 + [np.zeros((q_dim, 1, 1), np.float32),
                                                     np.ones((q_dim,), np.int32)]
    out = _drf_check(zeros, q_dim + 4, cuda)
    assert out[:q_dim, 0].tolist() == list(range(q_dim))


@pytest.mark.gpu
def test_cuda_drf_kernel_unstaged_table(cuda):
    """Q=8, G=8,192: the 256 KB table does not fit in shared memory, so the
    merge reads its heads from global memory."""
    from chip_smoke import wide_queue_tree

    tree = wide_queue_tree(8, 8, g_dim=8192, r_dim=2)
    assert tree[2].shape[0] * tree[2].shape[1] * 4 > 225 * 1024
    _drf_check(tree, int(tree[3].sum()) + 4, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dim", [64, 1025])
def test_cuda_drf_kernel_past_g_above_one_warp(cuda, q_dim):
    """Counts above G with more than one warp of queues: the owner charges
    the tail past the table row."""
    from chip_smoke import past_g_tree

    tree = past_g_tree(q_dim)
    assert (tree[3] > tree[2].shape[1]).any()
    _drf_check(tree, int(tree[3].sum()) + 4, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dim", [57601, 65536])
def test_cuda_drf_merge_past_shared_memory_queues(cuda, q_dim):
    """Past 57,600 queues the merge keeps its taken counts in a global
    buffer instead of shared memory: every step against the twin."""
    from chip_smoke import many_queue_tree
    from grove_tpu_torch.quota.ordering import _kernel

    assert q_dim > _kernel().grove_drf_merge_shared_queues()
    tree = many_queue_tree(q_dim)
    out = _drf_check(tree, int(tree[3].sum()) + 4, cuda)
    assert (out[: int(tree[3].sum()), 0] >= 0).all()


@pytest.mark.gpu
def test_cuda_scheduler_rounds_match_the_cpu_twins(cuda):
    """A cut of world (r) through the port's scheduler on the card (fill
    and DRF kernels) and on the CPU (their plain twins): every round's
    summary, PodGang status and binding equal."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import EventCapture, round_summary, scheduler_world
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster
    from grove_tpu_torch.solver.scheduler import GangScheduler

    world = scheduler_world("r", 128, 256)
    sides = []
    for device in (cuda, "cpu"):
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*world["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                              device=device)
        for doc in world["queues"]:
            store.create(decode_object(doc), consume=True)
        summaries = []
        for docs in world["rounds"]:
            for doc in docs:
                store.create(decode_object(doc), consume=True)
            fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
            with EventCapture(EVENTS) as cap:
                sched.schedule_pending()
            summaries.append((round_summary(store, cluster, cap.events), cap.events,
                              fill_batch.launches,
                              (share_table_cuda.launches, merge_cuda.launches)))
        statuses = {(g.metadata.namespace, g.metadata.name): g.status for g in store.scan("PodGang")}
        sides.append((summaries, statuses, dict(cluster.bindings)))
    (card, card_status, card_bind), (cpu, cpu_status, cpu_bind) = sides
    for (a, ev_a, fills, drfs), (b, ev_b, _, _) in zip(card, cpu):
        assert fills > 0 and drfs[0] == drfs[1] > 0
        assert a == b and ev_a == ev_b
    assert card_status == cpu_status and card_bind == cpu_bind
    assert card[1][0]["evicted"] > 0


@pytest.mark.gpu
def test_cuda_delta_churn_rounds_match_the_cpu_twins(cuda):
    """The churn world cut to 64 nodes and 96 gangs through the port's delta
    round (self-check on) on the card and on the CPU: every round's
    summary, events, delta counters and state fingerprint equal, and the
    card's rounds launched the fill and both DRF kernels."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import (
        EventCapture,
        apply_tick,
        delta_counters,
        round_summary,
        scheduler_world,
    )
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster
    from grove_tpu_torch.solver.scheduler import GangScheduler

    world = scheduler_world("delta", 64, 96)
    sides = []
    for device in (cuda, "cpu"):
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*world["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                              device=device)
        assert sched.enable_delta()
        sched.delta_selfcheck = True
        for doc in world["queues"] + world["rounds"][0]:
            store.create(decode_object(doc), consume=True)
        rounds = []
        launches = [0, 0, 0]
        for tick in [None] + world["ticks"]:
            if tick:
                apply_tick(store, cluster, tick, decode_object)
            fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
            with EventCapture(EVENTS) as cap:
                sched.schedule_pending()
            for i, n in enumerate((fill_batch.launches, share_table_cuda.launches,
                                   merge_cuda.launches)):
                launches[i] += n
            rounds.append((round_summary(store, cluster, cap.events), cap.events,
                           delta_counters(sched.delta), sched.delta.state_fingerprint()))
        sides.append((rounds, launches, list(cluster.bindings.items())))
    (card, card_launches, card_bind), (cpu, cpu_launches, cpu_bind) = sides
    assert card == cpu and card_bind == cpu_bind
    assert min(card_launches) > 0 and cpu_launches == [0, 0, 0]
    assert sum(r[2]["solve_reuses"] > 0 for r in card) > 0


def _frontier_stacks(kind, n_nodes=256):
    """The partitioned frontier's stacks of gangs of one kind (stress;
    disaggregated, with per-group packs; recovery, with pins) over the four
    slices of a 256-node cluster. Returns [(lanes, stack)]."""
    from chip_smoke import disagg_specs, frontier_stacks, spread_recovery_specs
    from grove_tpu_torch.models.scenarios import stress_gang_specs

    specs = {"stress": lambda: stress_gang_specs(192, seed=3),
             "grouped": lambda: disagg_specs(96, seed=4),
             "pinned": lambda: spread_recovery_specs(96, seed=5, n_nodes=n_nodes,
                                                     kinds=("recovery",))}[kind]()
    out = frontier_stacks(make_nodes(n_nodes, dict(STRESS_CAPACITY), 8, 8), specs,
                          ClusterTopology())
    assert any(len(lanes) >= 2 for lanes, _ in out)
    return out


STACK_FIELDS = ("free_after", "admitted", "retry", "new_cap", "placed", "score",
                "chosen_level", "alloc")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stress", "grouped", "pinned"])
def test_cuda_stacked_chunk_matches_plain_fill(cuda, kind):
    """One stacked chunk-wave on the card (the fill's vmap rule folds the
    lanes into one kernel launch per fill) against the same call with the
    plain fill, every output bit for bit."""
    from grove_tpu_torch.solver.kernel import _GANG_FIELDS

    lanes, stack = max(_frontier_stacks(kind), key=lambda ls: len(ls[0]))
    b, g = stack["demand"].shape[:2]
    chunk = min(32, g)
    gang = [torch.from_numpy(np.ascontiguousarray(stack[name][:, :chunk])).to(cuda)
            for name in _GANG_FIELDS]
    node = [torch.from_numpy(stack[name]).to(cuda)
            for name in ("capacity", "topo", "seg_starts", "seg_ends")]
    pending = torch.ones((b, chunk), dtype=torch.bool, device=cuda)
    narrow_cap = torch.full((b, chunk), stack["topo"].shape[2] - 1, dtype=torch.int32, device=cuda)
    seeds = torch.arange(chunk, dtype=torch.int32, device=cuda).expand(b, chunk).contiguous()
    flags = dict(grouped=bool((stack["group_req"] >= 0).any()),
                 pinned=bool((stack["gang_pin"] >= 0).any()),
                 spread=bool((stack["spread_level"] >= 0).any()),
                 uniform=bool((stack["min_count"] == stack["count"]).all()))
    args = node + gang[:5] + [pending, narrow_cap, seeds] + gang[5:]
    fill_batch.launches = fill_batch.rows = 0
    got = packing.solve_wave_chunk_stack(*args, **flags)
    torch.cuda.synchronize()
    launches, rows = fill_batch.launches, fill_batch.rows
    want = packing.solve_wave_chunk_stack(*args, **flags, fill=fill_batch_ref)
    for name, a, w in zip(STACK_FIELDS, got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), name
    assert got[1].any()
    assert launches > 0 and rows == launches * b * chunk


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stress", "grouped", "pinned"])
def test_cuda_stacked_lanes_match_solo_solves(cuda, kind):
    """solve_waves_stacked on the card: every lane equal to the solo
    solve_waves of its subproblem on the card, bit for bit (the frontier
    self-check's contract), and every stacked fill launch took all the
    stacked lanes' chunk rows."""
    from grove_tpu_torch.solver.kernel import solve_waves_stacked

    for lanes, stack in _frontier_stacks(kind):
        out = solve_waves_stacked(stack, chunk_size=32, max_waves=16, device=cuda)
        b, g = stack["demand"].shape[:2]
        assert out["fill_launches"] > 0
        assert out["fill_rows"] == out["fill_launches"] * b * min(32, g)
        for li, lane in enumerate(lanes):
            solo = solve_waves(lane, chunk_size=32, max_waves=16, device=cuda)
            for name in ("admitted", "placed", "score", "chosen_level", "alloc"):
                assert np.array_equal(out[name][li], getattr(solo, name)), (li, name)


@pytest.mark.gpu
def test_cuda_frontier_rounds_match_the_cpu_twins(cuda):
    """A four-slice cut of (phi) through the port's frontier (delta and
    frontier self-checks on every round) on the card and on the CPU: every
    round's summary, events, delta counters, state fingerprint and frontier
    counters equal; the card's stacked dispatches launched the fill."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import (
        EventCapture,
        apply_tick,
        delta_counters,
        frontier_counters,
        round_summary,
        scheduler_world,
    )
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster
    from grove_tpu_torch.solver.scheduler import GangScheduler

    world = scheduler_world("frontier", 256, 128)
    sides = []
    for device in (cuda, "cpu"):
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*world["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                              device=device)
        assert sched.enable_frontier()
        sched.delta_selfcheck = sched.frontier_selfcheck = True
        for doc in world["queues"] + world["rounds"][0]:
            store.create(decode_object(doc), consume=True)
        rounds = []
        for tick in [None] + world["ticks"]:
            if tick:
                apply_tick(store, cluster, tick, decode_object)
            with EventCapture(EVENTS) as cap:
                sched.schedule_pending()
            rounds.append((round_summary(store, cluster, cap.events), cap.events,
                           delta_counters(sched.delta), sched.delta.state_fingerprint(),
                           frontier_counters(sched.frontier)))
        sides.append((rounds, sched.frontier.stacked_fill_launches,
                      list(cluster.bindings.items())))
    (card, card_stacked, card_bind), (cpu, cpu_stacked, cpu_bind) = sides
    assert card == cpu and card_bind == cpu_bind
    assert card_stacked > 0 and cpu_stacked == 0
    assert card[-1][4]["solves"] > 0 and card[-1][4]["residual_gangs_total"] > 0


# -- the multi-GPU tier: gloo ranks sharing the one card ---------------------


def _merged(parts, key):
    return np.concatenate([p[key] for p in parts], axis=-2 if key == "free_after" else -1)


@pytest.mark.gpu
def test_cuda_sharded_fill_identity_over_two_gloo_ranks(cuda):
    """The fill kernel on each rank's node slab with count' = max(count −
    B_s, 0), two gloo ranks on cuda:0, equals the whole-axis kernel and
    the plain fill bit for bit (−0.0s, a count met on rank 0's nodes, one
    met inside rank 1's, slabs straddling the ranks)."""
    from grove_tpu_torch.ops import _build
    from grove_tpu_torch.parallel.multihost import run_ranks
    from grove_tpu_torch.ops.nodeaxis import WHOLE
    from grove_tpu_torch.parallel.sharded import fill_cases, run_fill_case

    _build.load("fill")  # the ranks load this build
    ranks = run_ranks([("fill", {})], 2, device="cuda:0", timeout=300)
    for name, case in fill_cases().items():
        whole = run_fill_case(case, WHOLE, cuda)
        plain = run_fill_case(case, WHOLE, "cpu")
        parts = [{k.split("/", 1)[1]: v for k, v in out["fill"].items()
                  if k.startswith(name + "/")} for out in ranks]
        for key in whole:
            got = parts[0][key] if key == "placed" else _merged(parts, key)
            assert got.tobytes() == whole[key].tobytes() == plain[key].tobytes(), (name, key)


@pytest.mark.gpu
def test_cuda_two_rank_gloo_solve_equals_single_device(cuda):
    """solve_stress_sharded over two gloo ranks sharing cuda:0 equals the
    single-device solve on the card bit for bit; every rank launched the
    fill kernel and loaded the build it found."""
    from grove_tpu_torch.ops import _build
    from grove_tpu_torch.parallel.multihost import run_ranks
    from grove_tpu_torch.parallel.sharded import solve_stress_single

    cfg = {"n_nodes": 1024, "n_gangs": 1536, "chunk_size": 32, "max_waves": 8}
    _build.load("fill")
    single = solve_stress_single(build_stress_problem(cfg["n_nodes"], cfg["n_gangs"]),
                                 cfg["chunk_size"], cfg["max_waves"], device=cuda)
    for out in run_ranks([("stress", cfg)], 2, device="cuda:0", timeout=300):
        got = out["stress"]
        for key in ("admitted", "placed", "score", "chosen_level", "free_after", "pending"):
            assert got[key].tobytes() == single[key].tobytes(), key
        assert int(got["waves"]) == single["waves"]
        assert int(got["fill_launches"]) > 0 and int(got["compiled_kernels"]) == 0
        assert str(got["backend"]) == "gloo"


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [1, 2])
def test_cuda_spawn_local_cluster(cuda, ranks):
    """The launcher's check on the card by default: NCCL at one rank (its
    gather must come from a tensor on the card), gloo when two ranks share
    cuda:0."""
    from grove_tpu_torch.ops import _build
    from grove_tpu_torch.parallel.multihost import spawn_local_cluster

    _build.load("fill")
    assert spawn_local_cluster(num_processes=ranks, timeout=300.0)


@pytest.mark.gpu
def test_cuda_explain_matches_the_cpu_twin(cuda):
    """A cut of world (q) after its round, on the card and on the CPU: the
    explain burst (every pending gang, a scheduled one, an unknown name,
    capacity, a drain and a queue what-if) gives equal documents less their
    timing fields; on the card its trial solves launch the fill kernel and
    its order views both DRF kernels, and the read-only pin holds."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.models.scenarios import explain_burst, scheduler_world
    from grove_tpu_torch.observability.explain import ExplainEngine
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster
    from grove_tpu_torch.solver.scheduler import GangScheduler

    world = scheduler_world("q", 64, 192)
    bursts = []
    for device in (cuda, "cpu"):
        store = Store(VirtualClock(0.0))
        cluster = SimCluster(store, make_nodes(*world["nodes"]))
        sched = GangScheduler(store, cluster, ClusterTopology(), world["priority_map"],
                              device=device)
        for doc in world["queues"] + world["rounds"][0]:
            store.create(decode_object(doc), consume=True)
        sched.schedule_pending()
        rv = store.resource_version_vector()
        fill_batch.launches = share_table_cuda.launches = merge_cuda.launches = 0
        bursts.append(explain_burst(ExplainEngine(sched), store, cluster))
        launches = (fill_batch.launches, share_table_cuda.launches, merge_cuda.launches)
        assert store.resource_version_vector() == rv
        if device is cuda:
            assert all(n > 0 for n in launches), launches
    card, cpu = bursts
    assert list(card) == list(cpu)
    for key in cpu:
        assert card[key] == cpu[key], key
    assert sum(1 for k in cpu if k.startswith("explain")) > 3


@pytest.mark.gpu
def test_cuda_execute_span_covers_the_device_work(cuda):
    """On a stats solve on the card, the ``solver.execute`` span lasts at
    least as long as the CUDA-event time of the device work inside it: the
    span closes after the read that waits for the device. Events bracket
    the wave program (recorded just before it is called and just after it
    returns); the span's µs are truncated, hence one µs of slack."""
    from grove_tpu_torch.observability.tracing import TRACER
    from grove_tpu_torch.solver import kernel

    problem = build_stress_problem(1024, 2048, seed=0)
    solve_waves_stats(problem, device=cuda)  # warm-up
    events = []
    inner = kernel.solve_waves_device

    def bracketed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    TRACER.reset()
    TRACER.enable()
    kernel.solve_waves_device = bracketed
    try:
        solve_waves_stats(problem, device=cuda)
    finally:
        kernel.solve_waves_device = inner
        TRACER.disable()
    torch.cuda.synchronize()
    spans = [sp for sp in TRACER.spans() if sp.name == "solver.execute"
             and sp.attrs["kernel"] == "solve_waves_device"]
    TRACER.reset()
    assert len(spans) == 1 and len(events) == 1
    device_us = events[0][0].elapsed_time(events[0][1]) * 1e3
    assert device_us > 0.0
    assert spans[0].dur_us + 1 >= device_us, (spans[0].dur_us, device_us)


def _sidecar_request(n_nodes=1024, n_gangs=2048):
    from grove_tpu_torch.cluster.grpcsolver import build_request
    from grove_tpu_torch.models.scenarios import stress_gang_specs

    nodes = make_nodes(n_nodes, dict(STRESS_CAPACITY), 8, 8)
    return build_request(nodes, stress_gang_specs(n_gangs, seed=4), ClusterTopology())


def _plain(response):
    """A response's bytes less solve_seconds."""
    response.solve_seconds = 0.0
    return response.SerializeToString()


@pytest.mark.gpu
def test_cuda_solve_request_equals_the_cpu_path(cuda):
    """The sidecar's solve of a 1,024-node request on the card equals the
    plain path on the CPU byte for byte (the same code; the fill kernel
    equals its plain version bit for bit)."""
    pytest.importorskip("google.protobuf", reason="the wire layer needs protobuf")
    from grove_tpu_torch.cluster import grpcsolver
    from grove_tpu_torch.solver.encode import StickyGroupPad

    request = _sidecar_request()
    answers = []
    for device in ("cpu", "cuda"):
        grpcsolver._PAD_GROUPS = StickyGroupPad()
        fill_batch.launches = 0
        answers.append(grpcsolver.solve_request(request, device=device))
        assert (fill_batch.launches > 0) == (device == "cuda")
    assert sum(p.admitted for p in answers[0].placements) > 0
    assert _plain(answers[1]) == _plain(answers[0])


@pytest.mark.gpu
def test_cuda_sidecar_round_trip(cuda):
    """One request through the port's SolverServer on the card and its
    SolverClient: the same answer as the in-process solve."""
    pytest.importorskip("grpc", reason="the sidecar needs grpcio")
    pytest.importorskip("google.protobuf", reason="the wire layer needs protobuf")
    from grove_tpu_torch.cluster import grpcsolver
    from grove_tpu_torch.solver.encode import StickyGroupPad

    request = _sidecar_request(n_gangs=512)
    grpcsolver._PAD_GROUPS = StickyGroupPad()
    server = grpcsolver.SolverServer(device="cuda").start()
    try:
        client = grpcsolver.SolverClient(server.address)
        assert client.healthy(timeout=30.0)
        got = client.solve(request, timeout=300.0)
        client.close()
    finally:
        server.stop(grace=1.0)
    grpcsolver._PAD_GROUPS = StickyGroupPad()
    assert _plain(got) == _plain(grpcsolver.solve_request(request, device="cuda"))


def _port_pkg():
    import types

    from grove_tpu_torch.api.wire import decode_object
    from grove_tpu_torch.autoscale.hpa import HorizontalAutoscaler, StaticMetricsProvider
    from grove_tpu_torch.controller.nodehealth import NodeHealthMonitor
    from grove_tpu_torch.controller.remediate import RemediationController
    from grove_tpu_torch.disruption import DisruptionBroker, NodeDrainController
    from grove_tpu_torch.observability.events import EVENTS
    from grove_tpu_torch.observability.explain import ExplainEngine
    from grove_tpu_torch.observability.ledger import LEDGER
    from grove_tpu_torch.observability.metrics import METRICS
    from grove_tpu_torch.runtime.clock import VirtualClock
    from grove_tpu_torch.runtime.store import Store
    from grove_tpu_torch.sim.cluster import SimCluster
    from grove_tpu_torch.solver.scheduler import GangScheduler

    return types.SimpleNamespace(
        Store=Store, VirtualClock=VirtualClock, SimCluster=SimCluster, make_nodes=make_nodes,
        GangScheduler=GangScheduler, ClusterTopology=ClusterTopology,
        decode_object=decode_object, EVENTS=EVENTS, METRICS=METRICS, LEDGER=LEDGER,
        DisruptionBroker=DisruptionBroker, NodeDrainController=NodeDrainController,
        NodeHealthMonitor=NodeHealthMonitor, RemediationController=RemediationController,
        HorizontalAutoscaler=HorizontalAutoscaler, StaticMetricsProvider=StaticMetricsProvider,
        ExplainEngine=ExplainEngine)


@pytest.mark.gpu
def test_cuda_disruption_world_equals_the_cpu_run(cuda):
    """The disruption world cut to 256 nodes and 160 gangs on the card
    equals the same cut on the CPU round by round (which the CPU tests hold
    against the JAX package), and shows every scripted event."""
    from grove_tpu_torch.models.scenarios import disruption_missing, run_disruption_world

    runs = [run_disruption_world(_port_pkg(), 256, 160, scheduler_kwargs={"device": device})
            for device in ("cpu", "cuda")]
    assert not disruption_missing(runs[1])
    assert runs[1]["names"] == runs[0]["names"]
    assert len(runs[1]["rounds"]) == len(runs[0]["rounds"])
    for got, want in zip(runs[1]["rounds"], runs[0]["rounds"]):
        got, want = dict(got), dict(want)
        assert np.isclose(got.pop("score_sum"), want.pop("score_sum"), rtol=1e-6, atol=0)
        assert got == want


@pytest.mark.gpu
def test_cuda_drain_trial_and_whatif_launch_the_fill_kernel(cuda):
    """A drain's trial pre-placement and a what-if drain on a scheduler on
    the card launch the fill kernel (its launch counter moves)."""
    from grove_tpu_torch.models.scenarios import gang_world_docs, stress_gang_specs

    pkg = _port_pkg()
    store = pkg.Store(pkg.VirtualClock(0.0))
    cluster = pkg.SimCluster(store, make_nodes(64, dict(STRESS_CAPACITY), 8, 8))
    sched = pkg.GangScheduler(store, cluster, ClusterTopology(), {}, device="cuda")
    broker = pkg.DisruptionBroker(store)
    monitor = pkg.NodeHealthMonitor(store, cluster)
    sched.broker, sched.monitor = broker, monitor
    drainer = pkg.NodeDrainController(store, cluster, sched, monitor, broker)
    for doc in gang_world_docs(stress_gang_specs(32, seed=3),
                               budget_of=lambda i, spec: {"maxUnavailableGangs": 1}):
        store.create(pkg.decode_object(doc))
    sched.schedule_pending()
    node = next(n for (_ns, _pod), n in sorted(cluster.bindings.items()))
    gang = next(g for g in sorted(store.scan("PodGang"), key=lambda g: g.metadata.name)
                if cluster.bindings.get((g.spec.pod_groups[0].pod_references[0].namespace,
                                         g.spec.pod_groups[0].pod_references[0].name)) == node)
    fill_batch.launches = 0
    report = pkg.ExplainEngine(sched).whatif(
        {"gang": {"namespace": gang.metadata.namespace, "name": gang.metadata.name},
         "actions": [{"action": "drain-node", "node": node}]})
    assert report["after"]["fits_now"]
    assert fill_batch.launches > 0
    fill_batch.launches = 0
    drainer.request_drain(node)
    assert drainer.tick() > 0
    assert fill_batch.launches > 0
    assert drainer.drained_gangs and all(d["pre_placed"] for d in drainer.drained_gangs)


@pytest.mark.gpu
def test_cuda_operator_world_equals_the_cpu_run(cuda):
    """The operator world (iota) cut to 128 sets on 256 nodes through the
    port's SimHarness on the card equals the same cut on the CPU (which the
    CPU tests hold against the JAX package) tick by tick, the placement
    score sum at rtol 1e-6; the converge launches the fill kernel."""
    from grove_tpu_torch.models.scenarios import (
        operator_missing, port_names, run_operator_world)

    runs = []
    for device in ("cpu", "cuda"):
        fill_batch.launches = 0
        runs.append(run_operator_world(port_names(), 128, 256, device=device))
        runs[-1].pop("walls")
    assert fill_batch.launches > 0
    assert not operator_missing(runs[1])
    for got, want in zip(runs[1]["converges"], runs[0]["converges"]):
        assert len(got["ticks"]) == len(want["ticks"])
        for g, w in zip(got["ticks"], want["ticks"]):
            g, w = dict(g), dict(w)
            g_round, w_round = dict(g.pop("round")), dict(w.pop("round"))
            assert np.isclose(g_round.pop("score_sum"), w_round.pop("score_sum"), rtol=1e-6)
            assert (g, g_round) == (w, w_round)
        g_sum, w_sum = dict(got["summary"]), dict(want["summary"])
        assert np.isclose(g_sum.pop("score_sum"), w_sum.pop("score_sum"), rtol=1e-6)
        assert g_sum == w_sum
        assert got["events"] == want["events"]


@pytest.mark.gpu
def test_cuda_queue_sample_launches_both_drf_kernels(cuda):
    """The Queue sample through the port's harness on the card: its two
    Queues bring the DRF order onto the converge, both kernels launch, and
    the store equals the CPU run's."""
    from grove_tpu_torch.models.scenarios import SAMPLES_DIR, port_names, store_digest
    from grove_tpu_torch.quota.ordering import merge_cuda, share_table_cuda

    pkg = port_names()
    text = (SAMPLES_DIR / "multitenant-queues.yaml").read_text()
    digests = []
    for device in ("cpu", "cuda"):
        pkg.reset_uid_namespace()
        share_table_cuda.launches = merge_cuda.launches = 0
        h = pkg.SimHarness(device=device)
        for obj in pkg.load_manifest_objects(text):
            h.apply(obj)
        h.converge()
        assert all(pkg.is_ready(p) for p in h.store.list("Pod"))
        digests.append((h.tree(), store_digest(h.store, pkg.export_object)))
    assert share_table_cuda.launches > 0 and merge_cuda.launches > 0
    assert digests[1] == digests[0]


@pytest.mark.gpu
def test_cuda_process_drain_forks_after_the_fill(cuda, monkeypatch):
    """The process drain's workers fork while this process holds the card:
    a drain generation forks after the scheduler launched the fill on
    cuda:0, with a garbage cycle holding a card tensor alive at the fork
    and every child collecting right after its setup (the child's
    ``gc.freeze`` must keep inherited objects out of its collector). The
    drain completes with no repatriation, the store equals a serial twin's
    on the card, and the coordinator's next fill launches and equals the
    plain fill."""
    import gc

    from grove_tpu_torch.api.pod import is_ready
    from grove_tpu_torch.runtime import procworkers
    from grove_tpu_torch.sim import parallel

    setup = procworkers.ProcessDrain._child_setup

    def setup_and_collect(self, me):
        setup(self, me)
        gc.collect()

    monkeypatch.setattr(procworkers.ProcessDrain, "_child_setup", setup_and_collect)
    tenants = parallel.tenant_namespaces(6)
    dumps = []
    for workers in (1, 2):
        h = parallel._make_harness(16, 3, workers, backend="process", device="cuda")
        fill_batch.launches = 0
        parallel._populate(h, 6, tenants)
        h.converge(max_ticks=60)
        first = fill_batch.launches
        assert first > 0
        gc.disable()
        try:
            cycle = [torch.ones(1024, device="cuda")]
            cycle.append(cycle)
            del cycle
            # more sets: this converge's drains fork after the fills above
            for i in range(6, 12):
                pcs = parallel.deep_copy(parallel._BASE)
                pcs.metadata.name = f"svc-{i:06d}"
                pcs.metadata.namespace = tenants[i % len(tenants)]
                h.apply(pcs)
            h.converge(max_ticks=60)
        finally:
            gc.enable()
            gc.collect()
        assert fill_batch.launches > first
        if workers > 1:
            stats = h.engine.workers.stats()
            assert stats["worker_crashes"] == 0 and sum(stats["reconciles_by_worker"][1:]) > 0
        assert all(is_ready(p) for p in h.store.list("Pod"))
        dumps.append(parallel._dump(h))
        h.engine.close()
    assert dumps[1] == dumps[0]
    free, mask, demand, count = (torch.from_numpy(a).to(cuda) for a in _fill_inputs(3, True, 0.5))
    launches = fill_batch.launches
    out = fill_batch(free, mask, demand, count)
    assert fill_batch.launches == launches + 1
    ref = fill_batch_ref(free, mask, demand, count)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
