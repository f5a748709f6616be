"""Problems for the exact kernel's tests, built by the port's encoder alone.

Imports neither JAX nor the JAX package, so the card-only tests
(``tests/test_torch_gpu.py``) use them too; the CPU tests
(``tests/test_torch_exact_scan.py``) hand the same arrays to the JAX
package. ``EXACT_CASES`` have no per-group pack, recovery pin or spread;
``FLAGGED_CASES`` carry them, on 96 nodes (two slices, the second short)
with the group axis padded to 4, so that the cases of one flag set share
their shapes.
"""

import numpy as np

from grove_tpu_torch.api.topology import ClusterTopology
from grove_tpu_torch.models.scenarios import STRESS_CAPACITY, stress_gang_specs
from grove_tpu_torch.sim.cluster import make_nodes
from grove_tpu_torch.solver.encode import build_problem

HOST_KEY = "kubernetes.io/hostname"
BLOCK_KEY = "cloud.google.com/gke-tpu-ici-block"
SLICE_KEY = "cloud.google.com/gke-tpu-slice"
MEM_CAPACITY = {"cpu": 16.0, "memory": 64 * 2**30, "tpu": 4.0}


def _group(name, cpu, count):
    return {"name": name, "demand": {"cpu": cpu}, "count": count, "min_count": count}


def random_problem(seed):
    """``tests/test_torch_exact.py``'s random problem (the oracle test's) with
    the same draws, less its per-group packs (the host loop's flag): 16
    nodes in ici-blocks of 4, 12 gangs of 1–3 groups, a third of the gangs
    with a required ici-block."""
    rng = np.random.default_rng(seed)
    nodes = make_nodes(16, capacity={"cpu": float(rng.integers(4, 12))}, hosts_per_ici_block=4)
    gangs = []
    for i in range(12):
        groups = [
            _group(f"g{i}-{p}", float(rng.integers(1, 5)), int(rng.integers(1, 6)))
            for p in range(int(rng.integers(1, 4)))
        ]
        req = BLOCK_KEY if rng.random() < 0.3 else None
        for _ in groups:
            rng.random()  # the group-level pack draw
        gangs.append({"name": f"g{i}", "groups": groups, "required_key": req,
                      "preferred_key": None, "priority": 0})
    return build_problem(nodes, gangs, ClusterTopology())


def mixed_specs(n_gangs, seed):
    """Non-uniform multi-group gangs with required/preferred keys and a
    byte-scale memory resource (``tests/test_torch_encode.py``'s)."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_gangs):
        groups = []
        for q in range(int(rng.integers(1, 4))):
            count = int(rng.integers(1, 6))
            groups.append({
                "name": f"m{i}-{q}",
                "demand": {"cpu": float(rng.integers(1, 5)),
                           "memory": float(rng.integers(1, 9)) * 2**30 + 12345.0,
                           "tpu": float(rng.integers(0, 2))},
                "count": count,
                "min_count": int(rng.integers(0, count + 1)),
            })
        specs.append({"name": f"m{i}", "groups": groups, "priority": int(i % 3),
                      "required_key": [SLICE_KEY, None, None][i % 3],
                      "preferred_key": [None, BLOCK_KEY, HOST_KEY][i % 3]})
    return specs


def byte_scale_problem():
    """``test_solve_packing_matches_on_byte_scale_memory``'s problem: 24
    nodes, 40 non-uniform gangs, R=3 with memory in bytes."""
    return build_problem(make_nodes(24, MEM_CAPACITY), mixed_specs(40, 5), ClusterTopology())


def signed_zero_problem():
    """``test_free_after_keeps_the_jax_signed_zeros``'s problem: every third
    node's capacity -0.0, single-group gangs (padded gangs carry -0.0
    demands)."""
    gangs = [{"name": f"g{i}", "groups": [_group(f"g{i}-a", 2.0, 1 + i % 3)],
              "required_key": None, "preferred_key": None, "priority": 0} for i in range(10)]
    problem = build_problem(make_nodes(16, capacity={"cpu": 8.0}, hosts_per_ici_block=4),
                            gangs, ClusterTopology())
    problem.capacity[::3] = -0.0
    return problem


def stress_problem(n_nodes, n_gangs, seed=0):
    """Stress gangs (``stress_gang_specs``) on ``n_nodes`` nodes in blocks of
    8 and slices of 8 blocks: with ``n_nodes`` not a multiple of 8 or 64
    the last block and slice are short (ragged domains), and the levels
    hold 1, 1, ⌈n/64⌉, ⌈n/8⌉ and n domains (ragged widths)."""
    nodes = make_nodes(n_nodes, dict(STRESS_CAPACITY), 8, 8)
    return build_problem(nodes, stress_gang_specs(n_gangs, seed=seed), ClusterTopology())


def nonuniform_problem():
    """``chip_smoke.nonuniform_specs`` (floors below counts, pack keys) on a
    contended 128-node cut."""
    from chip_smoke import nonuniform_specs

    nodes = make_nodes(128, dict(STRESS_CAPACITY), 8, 8)
    return build_problem(nodes, nonuniform_specs(160, seed=2), ClusterTopology())


def shuffled(problem, seed=0):
    """The problem with its nodes' rows (capacity, topology) permuted and the
    domain boundary tables left as they were: the domains are no longer the
    contiguous node slabs the tables describe, so a level fill's mask
    (``topo == best``) is not the boundary range."""
    order = np.random.default_rng(seed).permutation(problem.capacity.shape[0])
    problem.capacity = np.ascontiguousarray(problem.capacity[order])
    problem.topo = np.ascontiguousarray(problem.topo[order])
    return problem


FLAGGED_NODES = 96
FLAGGED_GANGS = 40


def _flagged_nodes():
    return make_nodes(FLAGGED_NODES, dict(STRESS_CAPACITY), 8, 8)


def flagged_specs(kind, seed):
    """Gang specs of one flag set, drawn as the smoke's requests draw them:
    ``grouped`` (d)'s disaggregated gangs (an ici-block pack per group,
    half of them also a slice pack); ``pinned`` (e)'s recovery gangs (gang
    pins at the slice level, group pins at the ici-block level);
    ``spread`` (e)'s hard spreads over ici-blocks (survivor seeds on one
    in four) and soft spreads over hosts; ``mixed`` all of (e)'s kinds
    beside (d)'s gangs."""
    from chip_smoke import disagg_specs, spread_recovery_specs

    n, g = FLAGGED_NODES, FLAGGED_GANGS
    if kind == "grouped":
        return disagg_specs(g, seed)
    if kind == "pinned":
        return spread_recovery_specs(g, seed, n, kinds=("recovery",))
    if kind == "spread":
        return spread_recovery_specs(g, seed, n, kinds=("spread", "soft"))
    return spread_recovery_specs(g - g // 4, seed, n) + disagg_specs(g // 4, seed + 1)


def flagged_problem(kind, seed, capacity_cut=0):
    """``flagged_specs(kind, seed)`` on the 96 nodes, the first
    ``capacity_cut`` of them with no capacity left (contention)."""
    problem = build_problem(_flagged_nodes(), flagged_specs(kind, seed), ClusterTopology(),
                            pad_groups=4)
    problem.capacity[:capacity_cut] = 0.0
    return problem


def flagged_signed_zero_problem():
    """The mixed flag set with signed zeros: groups of one resource (their
    other demand -0.0) in grouped and spread gangs, and every fifth node's
    cpu -0.0; the first 40 nodes with no capacity left."""
    specs = flagged_specs("mixed", 5)
    for i, spec in enumerate(specs):
        for q, grp in enumerate(spec["groups"]):
            if (i + q) % 3 == 0:
                grp["demand"] = {"tpu": grp["demand"]["tpu"]}
    problem = build_problem(_flagged_nodes(), specs, ClusterTopology(), pad_groups=4)
    real = problem.count > 0
    zero = (problem.demand == 0) & real[..., None]
    problem.demand[zero] = -0.0
    problem.capacity[:40] = 0.0
    problem.capacity[::5, problem.resource_names.index("cpu")] = -0.0
    assert np.signbit(problem.demand[zero]).all() and zero.any()
    return problem


GANG_ARRAYS = ("capacity", "topo", "seg_starts", "seg_ends", "demand", "count", "min_count",
               "req_level", "pref_level")
CONSTRAINT_ARRAYS = ("group_req", "group_pin", "gang_pin", "spread_level", "spread_min",
                     "spread_required", "spread_seed")


def batch_arrays(problems, constraints=False):
    """The nine positional arrays of ``ops.exact.exact_scan`` stacked over
    problems of one shape; with `constraints`, the seven constraint arrays
    after them (the solver's sentinels where a problem leaves one unset)."""
    from grove_tpu_torch.solver.kernel import _problem_arrays

    n = len(GANG_ARRAYS) + (len(CONSTRAINT_ARRAYS) if constraints else 0)
    return tuple(np.stack(arrays) for arrays in zip(*(_problem_arrays(p)[:n] for p in problems)))


def flags_of(problem):
    """The solver's static flags of a problem, as keywords of ``exact_scan``
    and ``solve_packing``: grouped, pinned, spread, uniform."""
    from grove_tpu_torch.solver.kernel import _flags, _problem_arrays

    return dict(zip(("grouped", "pinned", "spread", "uniform"), _flags(_problem_arrays(problem))))


def scenario_batch(n_scenarios=3, n_nodes=64, n_gangs=96):
    """Stress scenarios of one shape that differ in their gangs and in the
    capacity left on their nodes, a quarter less for each (a batch of
    independent problems; the first admits all, the others fewer)."""
    problems = []
    for s in range(n_scenarios):
        problem = stress_problem(n_nodes, n_gangs, seed=11 + s)
        problem.capacity[: n_nodes // 4 * s] = 0.0
        problems.append(problem)
    return problems


EXACT_CASES = {
    **{f"random{seed}": (lambda seed=seed: random_problem(seed)) for seed in range(4)},
    "byte_scale": byte_scale_problem,
    "nonuniform": nonuniform_problem,
    "signed_zero": signed_zero_problem,
    "ragged": lambda: stress_problem(100, 96, seed=4),
    "n_999": lambda: stress_problem(999, 64, seed=5),
    "shuffled": lambda: shuffled(stress_problem(128, 96, seed=6)),
}
"""Every case the kernel is held to, by id: a function that builds it (so a
test file that only names the ids builds nothing while it is imported)."""

FLAGGED_CASES = {
    "grouped": lambda: flagged_problem("grouped", 1, capacity_cut=32),
    "pinned": lambda: flagged_problem("pinned", 2, capacity_cut=40),
    "spread": lambda: flagged_problem("spread", 3, capacity_cut=40),
    "mixed": lambda: flagged_problem("mixed", 4, capacity_cut=48),
    "mixed_signed_zero": flagged_signed_zero_problem,
    "mixed_shuffled": lambda: shuffled(flagged_problem("mixed", 6, capacity_cut=48), seed=3),
}
"""The cases with per-group packs, recovery pins and spreads, by id."""
