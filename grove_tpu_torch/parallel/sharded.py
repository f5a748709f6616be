"""Multi-GPU sharded solve: the node axis of the packing solver over ranks.

Counterpart of ``grove_tpu/parallel/sharded.py``. The solver's two
parallel axes map onto a 2-D ``DeviceMesh`` (``torch.distributed``):

- ``dp``: independent placement problems (scenarios), no communication;
- ``tp``: the NODE axis, each rank holding a slab of the cluster's
  capacity and topology.

The JAX package lets GSPMD partition the jitted wave loop. The port's wave
loop runs on the host and its fill is a hand-written kernel, so the node
axis' collectives are written out by hand: the solver core takes a
``ops.nodeaxis.NodeAxis`` over the ``tp`` group, which turns the
node-axis prefix sums, boundary gathers and all-ofs into collectives and
runs the fill on each rank's slab. Gang tensors are replicated; every
rank calls the entry points with the same arguments (SPMD), and the wave
loop reads only replicated values, so every rank calls the same
collectives in the same order. The results are bit-identical to the
single-device solve at a matched wave budget (``solve_stress_single``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from grove_tpu_torch.ops.exact import check_inputs, exact_scan
from grove_tpu_torch.ops.fill import _pods_fit_per_node, fill_batch
from grove_tpu_torch.ops.packing import (
    GangInputs,
    _fill_slab_pair,
    solve_packing,
    solve_waves_device,
)
from grove_tpu_torch.ops.nodeaxis import WHOLE, NodeAxis, all_gather_stack
from grove_tpu_torch.solver.dedup import dedup_extra_args, level_widths_of
from grove_tpu_torch.solver.kernel import pad_problem_for_waves
from grove_tpu_torch.utils.platform import resolve_device, strict_fp32


def mesh_device_type() -> str:
    """``cuda`` for an NCCL process group, else ``cpu`` (a gloo group, its
    CUDA tensors staged through host memory)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_solver_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """2-D ``(dp, tp)`` mesh over the process group's ranks: dp is 4 when
    the ranks divide by 4 and number at least 8, else 2 when they divide by
    2 and number at least 4, else 1 (the JAX module's choice)."""
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a process group of {dist.get_world_size()}")
    dp = 1
    for cand in (4, 2):
        if n % cand == 0 and n >= cand * 2:
            dp = cand
            break
    return init_device_mesh(mesh_device_type(), (dp, n // dp), mesh_dim_names=("dp", "tp"))


def make_node_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """1-axis ``("tp",)`` node mesh over every rank: the single-problem
    stress solve has one shardable axis, so every rank goes on it."""
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a process group of {dist.get_world_size()}")
    return init_device_mesh(mesh_device_type(), (n,), mesh_dim_names=("tp",))


def _as_node_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """Any mesh flattened to the 1-axis node mesh over the same ranks, in
    the same order (every rank must call it: it may build a group)."""
    if mesh.mesh_dim_names == ("tp",):
        return mesh
    return DeviceMesh(mesh.device_type, mesh.mesh.flatten(), mesh_dim_names=("tp",))


def node_axis_of(n: int, mesh: Optional[DeviceMesh] = None) -> NodeAxis:
    """The node axis of ``n`` nodes over the mesh's ``tp`` ranks (default:
    every rank of the process group)."""
    group = mesh.get_group("tp") if mesh is not None else dist.group.WORLD
    return NodeAxis(n, group)


def _upload(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _solve_stress(problem, chunk_size, max_waves, device, axis: NodeAxis):
    """``solve_waves_device`` of the stress pipeline (the stats path's wave
    solve: padding, demand dedup, lazy rescue for uniform problems, the
    ragged level scan) on ``axis``' node slab, as the JAX module calls it;
    numpy results with ``free_after`` at full width."""
    device = resolve_device(device)
    strict_fp32()
    g = problem.num_gangs
    raw, n_chunks, grouped, pinned, spread, uniform = pad_problem_for_waves(problem, chunk_size)
    if axis.sharded:
        rows = slice(axis.lo, axis.lo + axis.n_local)
        raw = (raw[0][rows], raw[1][rows]) + tuple(raw[2:])
    args = [_upload(a, device) for a in raw]
    extra = {k: _upload(v, device)
             for k, v in dedup_extra_args(raw[4], raw[5], n_chunks, pinned).items()}
    out = solve_waves_device(
        *args, **extra, n_chunks=n_chunks, max_waves=max_waves, grouped=grouped,
        pinned=pinned, spread=spread, uniform=uniform, lazy_rescue=uniform,
        level_widths=level_widths_of(problem), axis=axis,
    )
    fetch = lambda t: t.cpu().numpy()  # noqa: E731
    return {
        "admitted": fetch(out["admitted"])[:g],
        "placed": fetch(out["placed"])[:g],
        "score": fetch(out["score"])[:g],
        "chosen_level": fetch(out["chosen_level"])[:g],
        "free_after": fetch(axis.full(out["free_after"], 0)),
        "pending": fetch(out["pending"])[:g],
        "waves": int(out["waves"]),
    }


def solve_stress_single(problem, chunk_size: int = 128, max_waves: int = 32, device=None) -> dict:
    """The single-device solve that :func:`solve_stress_sharded` equals bit
    for bit: the same pipeline on the whole node axis, no process group."""
    return _solve_stress(problem, chunk_size, max_waves, device, WHOLE)


def solve_stress_sharded(mesh: DeviceMesh, problem, chunk_size: int = 128, max_waves: int = 32,
                         device=None) -> dict:
    """ONE placement problem with the NODE axis sharded over every rank of
    the mesh (flattened to the 1-axis node mesh): each rank holds a slab of
    the cluster's capacity and topology, and runs the whole wave loop with
    the node axis' prefix sums, boundary gathers and all-ofs as collectives
    and the fill kernel on its own slab. Every rank calls it with the same
    problem. Runs on ``device`` (default: the card; raises without one).

    Every rank returns the same numpy dict: admitted, placed, score,
    chosen_level, free_after (full width), pending and waves, bit-identical
    to :func:`solve_stress_single` at the same budget; and ``collectives``,
    the collectives this rank called."""
    device = resolve_device(device)
    axis = node_axis_of(problem.num_nodes, _as_node_mesh(mesh))
    out = _solve_stress(problem, chunk_size, max_waves, device, axis)
    out["collectives"] = axis.collectives
    return out


def batch_solve_sharded(
    mesh: DeviceMesh,
    capacity: np.ndarray,  # [S, N, R] — S scenarios
    topo: np.ndarray,  # [S, N, L]
    seg_starts: np.ndarray,  # [S, L, D]
    seg_ends: np.ndarray,  # [S, L, D]
    demand: np.ndarray,  # [S, G, P, R]
    count: np.ndarray,  # [S, G, P]
    min_count: np.ndarray,  # [S, G, P]
    req_level: np.ndarray,  # [S, G]
    pref_level: np.ndarray,  # [S, G]
    device=None,
) -> dict:
    """Solve S independent placement scenarios with the exact solve (no
    allocations): scenarios over the mesh's ``dp`` ranks, each scenario's
    node axis over its ``tp`` ranks. On a card with the whole node axis on
    each rank (tp = 1), a rank's scenarios go to the exact kernel in one
    launch, one block a scenario (``ops.exact.exact_scan``); else each
    scenario runs ``solve_packing``'s host loop on the rank's node slab:
    the kernel walks a scenario's gangs in one block, which cannot wait on
    the node axis' collectives every phase of a gang step needs. Like the
    JAX function, it takes no per-group packs, pins or spreads.
    Every rank calls it with the whole batch and returns the whole result
    (numpy admitted, placed, score, chosen_level ``[S, ...]`` and
    free_after ``[S, N, R]``), gathered over ``dp``. S must divide by dp."""
    device = resolve_device(device)
    strict_fp32()
    dp_group = mesh.get_group("dp")
    dp, dp_rank = dist.get_world_size(dp_group), dist.get_rank(dp_group)
    s_total = capacity.shape[0]
    if s_total % dp:
        raise ValueError(f"{s_total} scenarios do not divide over dp={dp}")
    axis = node_axis_of(capacity.shape[1], mesh)
    per = s_total // dp
    mine_rows = slice(dp_rank * per, (dp_rank + 1) * per)
    batch = (capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
             pref_level)
    if axis.size == 1 and device.type == "cuda":
        check_inputs(count[mine_rows], min_count[mine_rows], pref_level[mine_rows],
                     demand[mine_rows], topo.shape[2])
        mine = exact_scan(*(_upload(a[mine_rows], device) for a in batch), with_alloc=False)
    else:
        rows = slice(axis.lo, axis.lo + axis.n_local)
        outs = []
        for s in range(dp_rank * per, (dp_rank + 1) * per):
            args = (capacity[s][rows], topo[s][rows]) + tuple(a[s] for a in batch[2:])
            out = solve_packing(*(_upload(a, device) for a in args), with_alloc=False, axis=axis)
            out["free_after"] = axis.full(out["free_after"], 0)
            outs.append(out)
        mine = {key: torch.stack([o[key] for o in outs])
                for key in ("admitted", "placed", "score", "chosen_level", "free_after")}
    stage = dist.get_backend(dp_group) == "gloo"
    result = {}
    for key in ("admitted", "placed", "score", "chosen_level", "free_after"):
        gathered = all_gather_stack(mine[key], dp_group, stage)  # [dp, per, ...]
        result[key] = gathered.flatten(0, 1).cpu().numpy()
    return result


def make_example_batch(
    n_scenarios: int, n_nodes: int = 32, n_gangs: int = 16
) -> Tuple[np.ndarray, ...]:
    """Tiny stacked scenario batch for dry runs and tests (the JAX module's
    generator: the same seed gives the same arrays)."""
    from grove_tpu_torch.api.topology import ClusterTopology
    from grove_tpu_torch.sim.cluster import make_nodes
    from grove_tpu_torch.solver.encode import build_problem

    rng = np.random.default_rng(0)
    problems = []
    for s in range(n_scenarios):
        nodes = make_nodes(n_nodes, capacity={"cpu": 8.0, "tpu": 4.0})
        gangs = []
        for i in range(n_gangs):
            gangs.append(
                {
                    "name": f"s{s}-g{i}",
                    "groups": [
                        {
                            "name": f"s{s}-g{i}-a",
                            "demand": {"tpu": float(rng.integers(1, 3))},
                            "count": int(rng.integers(1, 4)),
                            "min_count": int(rng.integers(1, 2)),
                        }
                    ],
                    "required_key": None,
                    "preferred_key": None,
                    "priority": 0,
                }
            )
        problems.append(build_problem(nodes, gangs, ClusterTopology()))
    stack = lambda attr: np.stack([getattr(p, attr) for p in problems])  # noqa: E731
    return (
        stack("capacity"),
        stack("topo"),
        stack("seg_starts"),
        stack("seg_ends"),
        stack("demand"),
        stack("count"),
        stack("min_count"),
        stack("req_level"),
        stack("pref_level"),
    )


# -- the sharded fill's identity cases ---------------------------------------


def fill_cases(seed: int = 3) -> dict:
    """Inputs (numpy, seeded) that exercise the sharded fill's identity on
    N = 128 nodes, whole segments for 2 and 4 ranks:

    - ``fill``: C = 6 gangs of P = 3 groups on a shared capacity, −0.0s
      in the capacity and the demands, half-dense masks, and counts that run out on the
      first rank's nodes (so ``count'`` is 0 on every later rank), inside
      a later rank's nodes, or never;
    - ``fill_per_gang``: the same on a per-gang capacity ``[C, N, R]``
      without ``free_after``;
    - ``slab``: the slab fill (``ops.packing._fill_slab_pair``) from a
      dedup table, P = 3, with slabs that straddle the ranks' boundaries
      (N/4 and N/2), one empty slab and one over every node."""
    rng = np.random.default_rng(seed)
    n, r, c, p = 128, 2, 6, 3
    free = rng.integers(0, 5, size=(n, r)).astype(np.float32)
    free[[7, 40, 100], [0, 1, 0]] = -0.0
    demand = rng.integers(0, 3, size=(c, p, r)).astype(np.float32)
    demand[0, 1, 0] = -0.0
    demand[2, 0, 1] = -0.0
    mask = rng.random((c, n)) < 0.5
    mask[1] = True
    # gang 0: satisfied on the first 16 nodes; 1: runs out mid-axis; the
    # rest draw random counts (some larger than the whole axis can hold)
    count = rng.integers(0, 40, size=(c, p)).astype(np.int32)
    count[0] = 1
    count[1] = (100, 1, 0)
    fill = {"n": n, "kind": "fill", "free": free, "mask": mask, "demand": demand,
            "count": count, "with_free_after": True}
    per_gang = dict(fill, free=np.broadcast_to(free, (c, n, r)).copy(), with_free_after=False)
    per_gang["free"][3, ::3] = 0.0
    # the slab case: pairs (demand, count), row 0 all-zero as dedup keeps it
    pair_dem = np.array([[0, 0], [1, 2], [2, 1], [1, -0.0]], dtype=np.float32)
    pair_cnt = np.array([0, 5, 3, 40], dtype=np.int32)
    eff = rng.integers(1, 4, size=(c, p)).astype(np.int64)
    eff[4] = 0  # a masked-out gang reads the all-zero row
    sl_start = np.array([20, 32, 60, 0, 0, 96], dtype=np.int64)
    sl_end = np.array([44, 96, 70, 128, 0, 128], dtype=np.int64)
    slab = {"n": n, "kind": "slab", "free": free, "pair_dem": pair_dem, "pair_cnt": pair_cnt,
            "eff": eff, "sl_start": sl_start, "sl_end": sl_end}
    return {"fill": fill, "fill_per_gang": per_gang, "slab": slab}


def run_fill_case(case: dict, axis: NodeAxis, device) -> dict:
    """One case of :func:`fill_cases` on ``axis``' node slab with the fill
    on ``device`` (the kernel on a card): alloc ``[C,P,n]`` and free_after
    ``[C,n,R]`` over this rank's nodes, placed ``[C,P]`` (global)."""
    device = torch.device(device)
    rows = slice(axis.lo, axis.lo + axis.n_local) if axis.sharded else slice(None)
    free = case["free"][..., rows, :]
    up = lambda a: _upload(a, device)  # noqa: E731
    if case["kind"] == "fill":
        alloc, placed, free_after = axis.fill(fill_batch)(
            up(free), up(case["mask"][:, rows]), up(case["demand"]), up(case["count"]),
            with_free_after=case["with_free_after"],
        )
        out = {"alloc": alloc, "placed": placed}
        if free_after is not None:
            out["free_after"] = free_after
    else:
        free_t = up(free)
        pair_dem, pair_cnt, eff = up(case["pair_dem"]), up(case["pair_cnt"]), up(case["eff"])
        fit = torch.minimum(_pods_fit_per_node(free_t, pair_dem), pair_cnt.unsqueeze(-1))
        cs_pair = axis.table(fit, -1)
        gang = GangInputs(pair_dem[eff].contiguous(), pair_cnt[eff].contiguous(), None, None, None)
        alloc, placed = _fill_slab_pair(free_t, up(case["sl_start"]), up(case["sl_end"]), gang,
                                        cs_pair, eff, axis.fill(fill_batch), axis)
        out = {"alloc": alloc, "placed": placed}
    return {k: v.cpu().numpy() for k, v in out.items()}
