"""The port's multi-GPU tier (``grove_tpu_torch.parallel``) on the CPU.

Local ranks over gloo (``parallel.multihost.run_ranks``: one process a
rank, one torch thread each, a FileStore under a fresh temporary
directory, a time limit per spawn and per collective) run the node-sharded
stress solve at world sizes 1, 2 and 4, ``domain_aggregates_ring`` at 2
and 4, ``batch_solve_sharded`` at (dp=2, tp=2) and the sharded fill's
identity cases. Each is held to the port's single-device solve bit for
bit, and to the JAX package: ``solve_waves_device``, ``solve_stress_sharded``
on the conftest's 8 CPU devices, ``batch_solve_sharded``, ``solve_packing``
and ``domain_aggregates_ring``, on the same inputs — bit for bit but the
PlacementScore, which is held to JAX at rtol=1e-6, atol=0, because XLA's
CPU backend fuses the score's multiply-add (see tests/test_torch_packing.py).
"""

import numpy as np
import pytest
import torch

from chip_smoke import disagg_specs, nonuniform_specs, spread_recovery_specs
from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.models.scenarios import STRESS_CAPACITY
from grove_tpu_torch.models.scenarios import build_stress_problem as port_stress_problem
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.ops.nodeaxis import WHOLE, shard_bounds
from grove_tpu_torch.ops.packing import solve_packing
from grove_tpu_torch.parallel import multihost
from grove_tpu_torch.parallel.multihost import choose_backend, run_ranks, spawn_local_cluster
from grove_tpu_torch.parallel.ring import domain_aggregates
from grove_tpu_torch.parallel.sharded import (
    _as_node_mesh,
    fill_cases,
    make_example_batch,
    make_node_mesh,
    node_axis_of,
    run_fill_case,
    solve_stress_sharded,
    solve_stress_single,
)
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.dedup import level_widths_of
from grove_tpu_torch.solver.encode import build_problem
from grove_tpu_torch.solver.kernel import _flags, _problem_arrays, solve, solve_waves_stats
from grove_tpu_torch.solver.types import PackingProblem

STRESS = {"n_nodes": 1024, "n_gangs": 256, "chunk_size": 32, "max_waves": 8}
# a contended cut: more pods than the cluster holds, so gangs retry over
# several waves and defer cluster rescues
CONTENDED = {"n_nodes": 256, "n_gangs": 640, "chunk_size": 32, "max_waves": 8}
RING = {"n_nodes": 1024, "n_gangs": 64, "gang": 0}
BATCH = {"n_scenarios": 8, "n_nodes": 16, "n_gangs": 16}
KEYS = ("admitted", "placed", "score", "chosen_level", "free_after", "pending", "waves")
WORLDS = (1, 2, 4)
# problems with every static flag, on 128 nodes (two slices): (c)'s
# non-uniform packs (eager rescue, floors then extras), (d)'s per-group
# packs (grouped) and (e)'s spreads with recovery pins (spread, pinned)
FLAGGED = ("nonuniform", "disagg", "spread")


def _flagged_problem(kind):
    nodes = make_nodes(128, dict(STRESS_CAPACITY), 8, 8)
    specs = {
        "nonuniform": lambda: nonuniform_specs(48, seed=2),
        "disagg": lambda: disagg_specs(32, seed=5),
        "spread": lambda: spread_recovery_specs(32, seed=6, n_nodes=128),
    }[kind]()
    return build_problem(nodes, specs, ClusterTopology())


def job_flagged(device, path, chunk_size=32, max_waves=8):
    """A rank's job (``run_ranks`` imports it from this module): the
    problem saved at `path` through ``solve_stress_sharded`` and through
    the exact sequential solve (``solve_packing`` with the problem's static
    flags) with the node axis sharded over every rank; the exact results
    under ``exact_<key>``, ``free_after`` at full width."""
    with np.load(path) as data:
        problem = PackingProblem(**{k: data[k] for k in data.files})
    mesh = make_node_mesh()
    out = solve_stress_sharded(mesh, problem, chunk_size=chunk_size, max_waves=max_waves,
                               device=device)
    axis = node_axis_of(problem.num_nodes, _as_node_mesh(mesh))
    host = _problem_arrays(problem)
    rows = slice(axis.lo, axis.lo + axis.n_local)
    host = (host[0][rows], host[1][rows]) + tuple(host[2:])
    grouped, pinned, spread, uniform = _flags(host)
    exact = solve_packing(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host), with_alloc=False,
        grouped=grouped, pinned=pinned, spread=spread, uniform=uniform,
        level_widths=level_widths_of(problem), axis=axis,
    )
    exact["free_after"] = axis.full(exact["free_after"], 0)
    for key in ("admitted", "placed", "score", "chosen_level", "free_after"):
        out[f"exact_{key}"] = exact[key].cpu().numpy()
    return out


@pytest.fixture(scope="module")
def flagged(tmp_path_factory):
    """The flagged problems, and the files the ranks read them from (a
    PackingProblem's arrays; its names and keys are left out)."""
    root = tmp_path_factory.mktemp("flagged")
    out = {}
    for kind in FLAGGED:
        problem = _flagged_problem(kind)
        np.savez(root / f"{kind}.npz",
                 **{k: v for k, v in vars(problem).items() if isinstance(v, np.ndarray)})
        out[kind] = (problem, str(root / f"{kind}.npz"))
    return out


def _same_bits(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert got.tobytes() == want.tobytes(), what


@pytest.fixture(scope="module")
def ranks(flagged):
    """One spawn per world size, every job of that size in it."""
    out = {}
    for world in WORLDS:
        jobs = [("stress", STRESS), ("contended", "stress", CONTENDED)]
        if world > 1:
            jobs += [("ring", RING), ("fill", {})]
            jobs += [(kind, "tests.test_torch_sharded:job_flagged", {"path": flagged[kind][1]})
                     for kind in FLAGGED]
        if world == 4:
            jobs += [("batch", BATCH)]
        out[world] = run_ranks(jobs, world, device="cpu", timeout=300, pg_timeout=120)
    return out


@pytest.fixture(scope="module")
def single():
    return {
        label: solve_stress_single(port_stress_problem(cfg["n_nodes"], cfg["n_gangs"]),
                                   cfg["chunk_size"], cfg["max_waves"], device="cpu")
        for label, cfg in (("stress", STRESS), ("contended", CONTENDED))
    }


def _jax_wave_solve(cfg):
    import jax.numpy as jnp

    from grove_tpu.models import build_stress_problem
    from grove_tpu.ops.packing import solve_waves_device
    from grove_tpu.solver.kernel import dedup_extra_args, level_widths_of, pad_problem_for_waves

    problem = build_stress_problem(cfg["n_nodes"], cfg["n_gangs"])
    g = problem.num_gangs
    raw, n_chunks, grouped, pinned, spread, uniform = pad_problem_for_waves(
        problem, cfg["chunk_size"])
    out = solve_waves_device(
        *[jnp.asarray(a) for a in raw], **dedup_extra_args(raw[4], raw[5], n_chunks, pinned),
        n_chunks=n_chunks, max_waves=cfg["max_waves"], grouped=grouped, pinned=pinned,
        spread=spread, uniform=uniform, lazy_rescue=uniform, level_widths=level_widths_of(problem),
    )
    res = {k: np.asarray(out[k])[:g] for k in KEYS if k not in ("free_after", "waves")}
    res["free_after"] = np.asarray(out["free_after"])
    res["waves"] = int(np.asarray(out["waves"]))
    return res


@pytest.fixture(scope="module")
def jax_single():
    return {"stress": _jax_wave_solve(STRESS), "contended": _jax_wave_solve(CONTENDED)}


def _same_score(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=what)


def _assert_solve_equal(got, want, what, jax=False):
    """Every field bit for bit; against JAX (`jax`) the score at rtol 1e-6."""
    for key in KEYS:
        if key == "waves":
            assert int(got[key]) == int(want[key]), (what, key)
        elif key == "score" and jax:
            _same_score(got[key], want[key], f"{what}: {key}")
        else:
            _same_bits(got[key], want[key], f"{what}: {key}")


@pytest.mark.parametrize("label", ["stress", "contended"])
def test_single_device_solve_matches_jax(single, jax_single, label):
    _assert_solve_equal(single[label], jax_single[label], f"{label} single vs JAX", jax=True)
    if label == "contended":
        assert single[label]["waves"] > 1 and single[label]["pending"].any()
        assert not single[label]["admitted"].all()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("label", ["stress", "contended"])
def test_sharded_stress_equals_single_device_and_jax(ranks, single, jax_single, world, label):
    for rank, out in enumerate(ranks[world]):
        got = out[label]
        _assert_solve_equal(got, single[label], f"{label} world {world} rank {rank} vs single")
        _assert_solve_equal(got, jax_single[label], f"{label} world {world} rank {rank} vs JAX",
                            jax=True)
        assert int(got["collectives"]) > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", FLAGGED)
def test_sharded_flagged_solves_equal_single_device(ranks, flagged, world, kind):
    """Grouped, pinned, spread and non-uniform problems through the sharded
    wave solve and the sharded exact solve: each rank equals the port's
    one-device solve bit for bit (the JAX tests of the flags hold the
    one-device solves to the JAX package)."""
    problem = flagged[kind][0]
    wave = solve_stress_single(problem, 32, 8, device="cpu")
    exact = solve(problem, with_alloc=False, device="cpu")
    for rank, out in enumerate(ranks[world]):
        got = out[kind]
        _assert_solve_equal(got, wave, f"{kind} world {world} rank {rank} wave solve")
        for key in ("admitted", "placed", "score", "chosen_level", "free_after"):
            _same_bits(got[f"exact_{key}"], getattr(exact, key), f"{kind} exact {key}")
    assert wave["admitted"].any() and exact.admitted.any()


def test_sharded_stress_equals_jax_gspmd_on_eight_devices(ranks):
    import jax

    from grove_tpu.models import build_stress_problem
    from grove_tpu.parallel.sharded import make_node_mesh, solve_stress_sharded

    assert len(jax.devices()) >= 8
    want = solve_stress_sharded(make_node_mesh(8), build_stress_problem(1024, 256),
                                chunk_size=STRESS["chunk_size"], max_waves=STRESS["max_waves"])
    for world in WORLDS:
        for out in ranks[world]:
            _assert_solve_equal(out["stress"], want, f"world {world} vs JAX GSPMD", jax=True)


def test_sharded_ranks_call_the_same_collectives(ranks):
    """Lockstep: every rank of a world called the same number of
    collectives (fills are counted on the card only), over gloo, in a
    process that imported neither JAX nor the JAX package."""
    for world in WORLDS:
        counts = {int(out["stress"]["collectives"]) for out in ranks[world]}
        assert len(counts) == 1, (world, counts)
        for out in ranks[world]:
            assert int(out["stress"]["fill_launches"]) == 0
            assert str(out["stress"]["backend"]) == "gloo"
            assert out["worker"]["blocked_modules"].size == 0, out["worker"]["blocked_modules"]


@pytest.mark.parametrize("world", [2, 4])
def test_ring_aggregates_equal_jax_exactly(ranks, world):
    import jax
    from jax.sharding import Mesh

    from grove_tpu.models import build_stress_problem
    from grove_tpu.parallel.ring import domain_aggregates_ring

    p = build_stress_problem(RING["n_nodes"], RING["n_gangs"])
    gi = RING["gang"]
    K, free_agg = domain_aggregates_ring(
        Mesh(np.array(jax.devices()[:world]), ("tp",)), p.capacity, p.topo, p.seg_starts,
        p.seg_ends, p.demand[gi], p.count[gi],
    )
    plain = domain_aggregates(p.capacity, p.topo, p.seg_starts, p.seg_ends, p.demand[gi],
                              p.count[gi], device="cpu")
    for rank, out in enumerate(ranks[world]):
        _same_bits(out["ring"]["K"], np.asarray(K), f"K rank {rank}")
        _same_bits(out["ring"]["free_agg"], np.asarray(free_agg), f"free_agg rank {rank}")
        _same_bits(out["ring"]["K"], plain[0], f"K rank {rank} vs one device")
        _same_bits(out["ring"]["free_agg"], plain[1], f"free_agg rank {rank} vs one device")


def test_batch_solve_sharded_equals_jax(ranks):
    import jax.numpy as jnp

    from grove_tpu.ops.packing import solve_packing
    from grove_tpu.parallel import sharded as jax_sharded

    batch = jax_sharded.make_example_batch(BATCH["n_scenarios"], BATCH["n_nodes"],
                                           BATCH["n_gangs"])
    for ours, theirs in zip(make_example_batch(BATCH["n_scenarios"], BATCH["n_nodes"],
                                               BATCH["n_gangs"]), batch):
        _same_bits(ours, theirs, "make_example_batch")
    mesh = jax_sharded.make_solver_mesh(4)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {"dp": 2, "tp": 2}
    want = jax_sharded.batch_solve_sharded(mesh, *batch)
    for rank, out in enumerate(ranks[4]):
        got = out["batch"]
        assert tuple(got["mesh"]) == (2, 2)
        assert set(want) == {"admitted", "placed", "score", "chosen_level", "free_after"}
        for key in want:
            same = _same_score if key == "score" else _same_bits
            same(got[key], want[key], f"batch rank {rank}: {key}")
    for s in range(BATCH["n_scenarios"]):
        ref = solve_packing(*[jnp.asarray(b[s]) for b in batch], with_alloc=False)
        for key in want:
            same = _same_score if key == "score" else _same_bits
            same(ranks[4][0]["batch"][key][s], np.asarray(ref[key]), f"scenario {s}: {key}")
    assert ranks[4][0]["batch"]["admitted"].any()


def _merge(parts, key):
    """A node-sharded result of every rank at full width."""
    axis = -2 if key == "free_after" else -1
    return np.concatenate([p[key] for p in parts], axis=axis)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_fill_identity(ranks, world):
    """The fill on node shards with count' = max(count − B_s, 0) equals the
    whole-axis fill bit for bit (−0.0 capacities and demands; a count met
    on the first rank's nodes, one met inside a later rank's; slab fills
    whose slab straddles ranks), and each rank reports the global placed."""
    cases = fill_cases()
    for name, case in cases.items():
        whole = run_fill_case(case, WHOLE, "cpu")
        parts = []
        for out in ranks[world]:
            part = {k.split("/", 1)[1]: v for k, v in out["fill"].items()
                    if k.startswith(name + "/")}
            _same_bits(part["placed"], whole["placed"], f"{name} placed")
            parts.append(part)
        for key in whole:
            if key != "placed":
                _same_bits(_merge(parts, key), whole[key], f"{name} {key} world {world}")
    # the cases reach what they claim: gang 0 fits on rank 0's nodes, gang 1
    # group 0 runs out inside a later rank's
    alloc = run_fill_case(cases["fill"], WHOLE, "cpu")["alloc"]
    n_local = cases["fill"]["n"] // world
    assert alloc[0, 0].sum() == 1 and alloc[0, 0, n_local:].sum() == 0
    last = np.flatnonzero(alloc[1, 0]).max()
    assert alloc[1, 0].sum() == 100 and n_local <= last < cases["fill"]["n"] - 1
    slab = cases["slab"]
    assert any(lo < b < hi for lo, hi in zip(slab["sl_start"], slab["sl_end"])
               for b in range(n_local, slab["n"], n_local))


@pytest.mark.parametrize(
    "n, size",
    [(1030, 4), (288, 3), (256, 128), (96, 64)],
)
def test_node_axis_that_does_not_split_into_whole_segments_raises(n, size):
    with pytest.raises(ValueError):
        shard_bounds(n, size, 0)


@pytest.mark.parametrize("n, size", [(1024, 4), (5120, 4), (16, 2), (33, 1)])
def test_node_axis_bounds(n, size):
    spans = [shard_bounds(n, size, r) for r in range(size)]
    assert spans[0][0] == 0 and all(lo + k == nxt for (lo, k), (nxt, _) in zip(spans, spans[1:]))
    assert sum(k for _, k in spans) == n


@pytest.mark.parametrize("job, params, message", [
    ("stress", {"n_nodes": 96, "n_gangs": 8, "chunk_size": 8, "max_waves": 1}, "scan segments"),
    ("ring", {"n_nodes": 1024, "n_gangs": 8}, "not divisible by mesh size 3"),
])
def test_three_ranks_raise(job, params, message):
    """At 3 ranks no stress cluster splits into whole scan segments, and
    1,024 nodes do not divide for the ring: every rank raises before its
    first collective of the solve, and the spawn reports it."""
    with pytest.raises(RuntimeError, match=message):
        run_ranks([(job, params)], 3, device="cpu", timeout=120, pg_timeout=60)


def test_spawn_local_cluster():
    assert spawn_local_cluster(num_processes=2, timeout=120.0, device="cpu")


def test_cluster_check_gathers_on_the_rank_device(monkeypatch):
    """The launcher's cross-process check gathers a tensor on the rank's
    device: NCCL takes no CPU tensor, so on a card per rank nothing may be
    made on the host (gloo's tensors are staged through it)."""
    seen = []

    def all_gather(parts, t, group=None):
        seen.append((t.device, {p.device for p in parts}))
        for r, part in enumerate(parts):
            part.fill_(r + 1)

    monkeypatch.setattr(multihost.dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(multihost.dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(multihost.dist, "all_gather", all_gather)
    monkeypatch.setattr(multihost.dist, "get_backend", lambda group=None: "nccl")
    # a "meta" tensor stands for the card's: it holds no values to read back
    with pytest.raises(NotImplementedError):
        multihost._gather_ranks(torch.device("meta"))
    assert seen == [(torch.device("meta"), {torch.device("meta")})]
    seen.clear()
    monkeypatch.setattr(multihost.dist, "get_backend", lambda group=None: "gloo")
    parts = multihost._gather_ranks(torch.device("cpu"))
    assert parts[:, 0].tolist() == [1, 2, 3]
    assert seen == [(torch.device("cpu"), {torch.device("cpu")})]


def test_backend_choice():
    assert choose_backend(torch.device("cpu"), 4) == "gloo"
    assert choose_backend(torch.device("cuda", 0), 1) == "nccl"
    assert choose_backend(torch.device("cuda", 0), 2) == "gloo"


@pytest.mark.parametrize("entry", [
    "solve_stress_single", "solve_stress_sharded", "batch_solve_sharded",
    "domain_aggregates_ring", "domain_aggregates", "initialize", "run_ranks",
    "spawn_local_cluster",
])
def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch, entry):
    """Without CUDA every entry point of the tier raises before it starts
    a rank, joins a group or solves, unless the caller asks for the CPU."""
    from grove_tpu_torch.parallel import ring, sharded

    problem = port_stress_problem(64, 8)
    batch = make_example_batch(2, 16, 4)
    calls = {
        "solve_stress_single": lambda: sharded.solve_stress_single(problem, 8, 1),
        "solve_stress_sharded": lambda: sharded.solve_stress_sharded(None, problem, 8, 1),
        "batch_solve_sharded": lambda: sharded.batch_solve_sharded(None, *batch),
        "domain_aggregates_ring": lambda: ring.domain_aggregates_ring(
            None, problem.capacity, problem.topo, problem.seg_starts, problem.seg_ends,
            problem.demand[0], problem.count[0]),
        "domain_aggregates": lambda: ring.domain_aggregates(
            problem.capacity, problem.topo, problem.seg_starts, problem.seg_ends,
            problem.demand[0], problem.count[0]),
        "initialize": lambda: multihost.initialize("file:///nonexistent", 1, 0),
        "run_ranks": lambda: run_ranks([("fill", {})], 2, timeout=1),
        "spawn_local_cluster": lambda: spawn_local_cluster(2, timeout=1),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_default_axis_keeps_the_fill_calls():
    """The single-device path makes the same fill calls as before the node axis
    was threaded through it: one (a)-cut stats solve and an exact solve,
    counted by a ``fill=`` that records every call (each is one kernel
    launch on the card). The counts were taken before the node axis existed."""
    calls = []

    def counting(free, mask, demand, count, with_free_after=True):
        calls.append(tuple(demand.shape))
        return fill_batch(free, mask, demand, count, with_free_after=with_free_after)

    res = solve_waves_stats(port_stress_problem(1024, 1024), device="cpu", fill=counting)
    assert res.admitted.all()
    assert (len(calls), sum(c for c, _, _ in calls), sum(p for _, p, _ in calls)) == (23, 1104, 46)
    calls.clear()
    solve(port_stress_problem(1024, 16), with_alloc=False, device="cpu", fill=counting)
    assert (len(calls), sum(c for c, _, _ in calls), sum(p for _, p, _ in calls)) == (64, 224, 192)


# non-view torch ops of one-device solves before the node axis was threaded
# through the solver: (total, then the counts of the ops below)
_PARENT_OPS_KEYS = ("aten.index", "aten.gather", "aten.index_select", "aten.sub", "aten.zeros",
                    "aten.cumsum", "grove_tpu_torch.fill_batch")
_PARENT_OPS = {
    "stats": (10281, 759, 69, 32, 667, 108, 230, 23),
    "binding": (3792, 248, 8, 0, 200, 32, 72, 16),
    "exact": (11142, 1024, 0, 0, 928, 192, 160, 64),
}


@pytest.mark.parametrize("path", sorted(_PARENT_OPS))
def test_default_axis_keeps_the_torch_ops(path):
    """The one-device path issues the same torch ops as before the node
    axis existed (views aside, which launch nothing): the stats and binding
    wave solves of an (a) cut and an exact solve, every op counted at the
    dispatcher on a second run (the first warms the solver's caches)."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    from grove_tpu_torch.solver.kernel import solve_waves

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    run = {
        "stats": lambda: solve_waves_stats(port_stress_problem(1024, 1024), device="cpu"),
        "binding": lambda: solve_waves(port_stress_problem(1024, 256), device="cpu"),
        "exact": lambda: solve(port_stress_problem(1024, 16), with_alloc=False, device="cpu"),
    }[path]
    run()
    with Count() as count:
        run()
    got = (sum(count.ops.values()),) + tuple(count.ops[k] for k in _PARENT_OPS_KEYS)
    assert got == _PARENT_OPS[path]
