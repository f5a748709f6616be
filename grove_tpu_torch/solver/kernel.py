"""Wave solver host loop: PackingProblem → PackingResult on a torch device.

Counterpart of ``grove_tpu/solver/kernel.py::solve_waves`` (the binding
path): the host loop walks waves and chunks, each chunk decided on the
device by ``ops.packing.solve_wave_chunk``. Grouped, pinned and spread
problems take the same loop with the static flags derived from the
problem as the JAX package derives them. The JAX loop's metrics and
tracing spans are not ported yet.
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from grove_tpu_torch.convert import problem_to_device
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.ops.packing import solve_wave_chunk
from grove_tpu_torch.solver.dedup import (
    _spread_arrays,
    dedup_extra_args,
    level_widths_of,
)
from grove_tpu_torch.solver.types import PackingProblem, PackingResult
from grove_tpu_torch.utils.platform import resolve_device, strict_fp32


def _or_full(a, shape) -> np.ndarray:
    """A constraint array, or all -1 (no constraint) where it is unset."""
    return a if a is not None else np.full(shape, -1, dtype=np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_waves(
    problem: PackingProblem,
    chunk_size: int = 32,
    max_waves: int = 16,
    with_alloc: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    fill=fill_batch,
) -> PackingResult:
    """Wave-parallel solve WITH per-pod allocations (the binding path).

    Each wave decides every pending chunk of gangs in parallel against the
    current capacity snapshot (single level fill + spill/rescue fill,
    strided domain pick, prefix-acceptance commit), then retries the gangs
    that lost a commit race or walk their narrow cap. Gangs still pending
    when the wave budget ends stay pending. Runs on ``device`` (default:
    the card; raises without one). `fill` selects the fill implementation
    (tests pass ``fill_batch_ref`` to compare the kernel inside the path).
    """
    device = resolve_device(device)
    strict_fp32()
    g = problem.num_gangs
    chunk_size = min(chunk_size, max(g, 1))
    n_chunks = max(1, (g + chunk_size - 1) // chunk_size)
    g_pad = n_chunks * chunk_size

    def pad(a, value=0):
        if a.shape[0] == g_pad:
            return a
        width = [(0, g_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=value)

    spread_level_a, spread_min_a, spread_required_a, spread_seed_a = (
        _spread_arrays(problem)
    )
    demand = pad(problem.demand)
    count = pad(problem.count)
    min_count = pad(problem.min_count)
    req_level = pad(problem.req_level, -1)
    pref_level = pad(problem.pref_level, -1)
    group_req = pad(_or_full(problem.group_req, problem.count.shape), -1)
    group_pin = pad(_or_full(problem.group_pin, problem.count.shape), -1)
    gang_pin = pad(_or_full(problem.gang_pin, problem.req_level.shape), -1)
    spread_level = pad(spread_level_a, -1)
    spread_min = pad(spread_min_a)
    spread_required = pad(spread_required_a)
    spread_seed = pad(spread_seed_a)

    node = problem_to_device(problem, device)
    free = node["capacity"]
    topo, seg_starts, seg_ends = node["topo"], node["seg_starts"], node["seg_ends"]
    n_levels = problem.num_levels
    pending = np.ones((g_pad,), dtype=bool)
    pending[g:] = False
    narrow_cap = np.full((g_pad,), n_levels - 1, dtype=np.int32)

    admitted = np.zeros((g_pad,), dtype=bool)
    placed = np.zeros_like(count)
    score = np.zeros((g_pad,), dtype=np.float32)
    chosen_level = np.full((g_pad,), -1, dtype=np.int32)
    alloc = (
        np.zeros((g_pad, problem.max_groups, problem.num_nodes), dtype=np.int32)
        if with_alloc
        else None
    )

    grouped = bool((group_req >= 0).any())
    pinned = bool((gang_pin >= 0).any())
    spread = bool((spread_level >= 0).any())
    # padded gangs have min_count == count == 0, preserving uniformity
    uniform = bool((problem.min_count == problem.count).all())
    level_widths = level_widths_of(problem)

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    dedup = dedup_extra_args(demand, count, n_chunks, pinned)
    pair_demand = upload(dedup["pair_demand"]) if dedup else None
    pair_count = upload(dedup["pair_count"]) if dedup else None
    # immutable chunk tensors go to the device ONCE (only mask/cap/seeds
    # change between waves)
    chunk_const = []
    for c in range(n_chunks):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        tensors = tuple(
            upload(a[sl])
            for a in (
                demand, count, min_count, req_level, pref_level,
                group_req, group_pin, gang_pin,
                spread_level, spread_min, spread_required, spread_seed,
            )
        )
        pidx = upload(dedup["pair_idx"][sl]) if dedup else None
        chunk_const.append(tensors + (pidx,))

    _sync(device)
    t0 = time.perf_counter()
    for wave in range(max_waves):
        if not pending.any():
            break
        progress = False
        seeds = np.arange(g_pad, dtype=np.int32) + np.int32(wave * 7919)
        for c in range(n_chunks):
            sl = slice(c * chunk_size, (c + 1) * chunk_size)
            mask = pending[sl]
            if not mask.any():
                continue
            (
                dem_c, cnt_c, mn_c, rq_c, pf_c, grq_c, gpin_c, gangpin_c,
                slvl_c, smin_c, sreq_c, sseed_c, pidx_c,
            ) = chunk_const[c]
            out = solve_wave_chunk(
                free, topo, seg_starts, seg_ends,
                dem_c, cnt_c, mn_c, rq_c, pf_c,
                upload(mask), upload(narrow_cap[sl]), upload(seeds[sl]),
                group_req=grq_c,
                group_pin=gpin_c,
                gang_pin=gangpin_c,
                spread_level=slvl_c,
                spread_min=smin_c,
                spread_required=sreq_c,
                spread_seed=sseed_c,
                pair_demand=pair_demand,
                pair_count=pair_count,
                pair_idx=pidx_c,
                grouped=grouped,
                pinned=pinned,
                spread=spread,
                uniform=uniform,
                level_widths=level_widths,
                fill=fill,
            )
            committed = out["admitted"].cpu().numpy()
            retry = out["retry"].cpu().numpy()
            free = out["free_after"]
            admitted[sl] |= committed
            placed[sl] = np.where(
                committed[:, None], out["placed"].cpu().numpy(), placed[sl]
            )
            score[sl] = np.where(committed, out["score"].cpu().numpy(), score[sl])
            chosen_level[sl] = np.where(
                committed, out["chosen_level"].cpu().numpy(), chosen_level[sl]
            )
            narrow_cap[sl] = out["new_cap"].cpu().numpy()
            if with_alloc:
                alloc[sl] = np.where(
                    committed[:, None, None], out["alloc"].cpu().numpy(), alloc[sl]
                )
            pending[sl] = mask & retry
            # retry counts as progress: the narrow-cap fallback walk admits
            # gangs in LATER waves even when this one committed nothing
            progress |= bool(committed.any() or retry.any())
        if not progress:
            break
    free_after = free.cpu().numpy()
    _sync(device)
    elapsed = time.perf_counter() - t0

    return PackingResult(
        admitted=admitted[:g],
        placed=placed[:g],
        score=score[:g],
        chosen_level=chosen_level[:g],
        alloc=None if alloc is None else alloc[:g],
        free_after=free_after,
        solve_seconds=elapsed,
    )
