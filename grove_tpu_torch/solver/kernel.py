"""Solver entry points: PackingProblem → PackingResult on a torch device.

Counterpart of ``grove_tpu/solver/kernel.py``:

- ``solve_waves``: the binding path's host loop over waves and chunks,
  each chunk decided by ``ops.packing.solve_wave_chunk`` (per-pod
  allocations, eager rescue);
- ``solve_waves_stats``: the stats path, ``ops.packing.solve_waves_device``
  (one read per wave), then the exact sequential greedy over the gangs
  still pending (the hybrid tail);
- ``solve``: the exact sequential greedy, ``ops.packing.solve_packing``;
- ``solve_waves_stacked``: ``solve_waves`` over a stack of same-shape
  subproblems, each (wave, chunk) one ``ops.packing.solve_wave_chunk_stack``
  dispatch over every lane (the partitioned frontier, ``solver/frontier.py``).

Grouped, pinned and spread problems take the same paths with the static
flags derived from the problem as the JAX package derives them.

Spans and metrics as in the JAX module: a ``solver.wave`` span per wave of
``solve_waves`` and the ``gang_solve_waves`` gauge; a ``solver.execute``
span around the exact solve, the stats program and each stacked dispatch,
each closed after the first host read of the device's answer (the read
that waits for the device, so the span covers the device work without a
synchronize of its own); ``gang_solve_tail`` when the stats path runs its
tail. The JAX module's ``solver.compile`` span and
``gang_solve_compile_seconds`` time an XLA compile per program signature;
the port compiles no program, and its counterpart is the one build and
load of each CUDA library (``ops/_build.load_all``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from grove_tpu_torch.convert import problem_to_device
from grove_tpu_torch.observability.metrics import METRICS
from grove_tpu_torch.observability.tracing import TRACER
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.ops.packing import (
    solve_packing,
    solve_wave_chunk,
    solve_wave_chunk_stack,
    solve_waves_device,
)
from grove_tpu_torch.solver.dedup import (
    _spread_arrays,
    dedup_extra_args,
    level_widths_of,
)
from grove_tpu_torch.solver.types import PackingProblem, PackingResult
from grove_tpu_torch.utils.platform import resolve_device, strict_fp32

# The BASELINE stress configuration of the stats path (the JAX package's
# bench defaults).
BENCH_CHUNK_SIZE = 48
BENCH_MAX_WAVES = 32


def _or_full(a, shape) -> np.ndarray:
    """A constraint array, or all -1 (no constraint) where it is unset."""
    return a if a is not None else np.full(shape, -1, dtype=np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _flags(args):
    """The static flags (grouped, pinned, spread, uniform) of the solvers'
    positional arrays (``_problem_arrays``), derived as the JAX package
    derives them."""
    count, min_count, group_req, gang_pin, spread_level = (args[i] for i in (5, 6, 9, 11, 12))
    return (
        bool((group_req >= 0).any()),
        bool((gang_pin >= 0).any()),
        bool((spread_level >= 0).any()),
        # all-or-nothing population (padded gangs are 0 == 0): one fill per
        # dispatch instead of floors then extras
        bool((min_count == count).all()),
    )


# PackingProblem's per-gang fields, in the order of _problem_arrays, and the
# value each pads its gang axis with (the -1 sentinels: no constraint)
_GANG_FIELDS = (
    "demand", "count", "min_count", "req_level", "pref_level", "group_req",
    "group_pin", "gang_pin", "spread_level", "spread_min", "spread_required",
    "spread_seed",
)
_GANG_PADS = (0, 0, 0, -1, -1, -1, -1, -1, -1, 0, 0, 0)


def _problem_arrays(problem: PackingProblem, rows=None, g_pad=None):
    """The positional array arguments of the solvers, ``(capacity, topo,
    seg_starts, seg_ends, demand, count, min_count, req_level, pref_level,
    group_req, group_pin, gang_pin, spread_level, spread_min,
    spread_required, spread_seed)``, with unset constraints at their
    sentinels. `rows` selects gangs; `g_pad` pads the gang axis (sentinel
    -1 for the level and pin fields, 0 elsewhere)."""
    shape = problem.count.shape
    sl, sm, sr, ss = _spread_arrays(problem)
    per_gang = zip((
        problem.demand, problem.count, problem.min_count, problem.req_level,
        problem.pref_level, _or_full(problem.group_req, shape),
        _or_full(problem.group_pin, shape), _or_full(problem.gang_pin, shape[:1]),
        sl, sm, sr, ss,
    ), _GANG_PADS)

    def pick(a, value):
        if rows is not None:
            a = a[rows]
        if g_pad is None or a.shape[0] == g_pad:
            return a
        width = [(0, g_pad - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=value)

    node = (problem.capacity, problem.topo, problem.seg_starts, problem.seg_ends)
    return node + tuple(pick(a, v) for a, v in per_gang)


def pad_problem_for_waves(
    problem: PackingProblem, chunk_size: int
) -> Tuple[Tuple[np.ndarray, ...], int, bool, bool, bool, bool]:
    """The wave solvers' input contract: clamp the chunk size, pad the gang
    axis to a chunk multiple (sentinel -1 for the level and pin fields, 0
    elsewhere), and decide the static flags. Returns (args, n_chunks,
    grouped, pinned, spread, uniform), args the positional numpy arrays of
    ``solve_waves_device``."""
    g = problem.num_gangs
    chunk_size = min(chunk_size, max(g, 1))
    n_chunks = max(1, (g + chunk_size - 1) // chunk_size)
    args = _problem_arrays(problem, g_pad=n_chunks * chunk_size)
    return (args, n_chunks) + _flags(args)


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
    args, n_chunks, grouped, pinned, spread, uniform = pad_problem_for_waves(
        problem, chunk_size
    )
    (
        demand, count, min_count, req_level, pref_level, group_req, group_pin,
        gang_pin, spread_level, spread_min, spread_required, spread_seed,
    ) = args[4:]
    g_pad = demand.shape[0]
    chunk_size = g_pad // n_chunks

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

    level_widths = level_widths_of(problem)

    dedup = dedup_extra_args(demand, count, n_chunks, pinned)
    pair_demand = _upload(dedup["pair_demand"], device) if dedup else None
    pair_count = _upload(dedup["pair_count"], device) if dedup else None
    # immutable chunk tensors go to the device ONCE (only mask/cap/seeds
    # change between waves)
    chunk_const = []
    for c in range(n_chunks):
        sl = slice(c * chunk_size, (c + 1) * chunk_size)
        tensors = tuple(
            _upload(a[sl], device)
            for a in (
                demand, count, min_count, req_level, pref_level,
                group_req, group_pin, gang_pin,
                spread_level, spread_min, spread_required, spread_seed,
            )
        )
        pidx = _upload(dedup["pair_idx"][sl], device) if dedup else None
        chunk_const.append(tensors + (pidx,))

    _sync(device)
    t0 = time.perf_counter()
    waves_used = 0
    for wave in range(max_waves):
        if not pending.any():
            break
        # one span a wave (host values only); the chunk dispatches nest
        # inside it by time
        wave_span = (
            TRACER.span("solver.wave", wave=wave, pending=int(pending.sum()))
            if TRACER.enabled
            else None
        )
        progress = False
        waves_used += 1
        seeds = np.arange(g_pad, dtype=np.int32) + np.int32(wave * 7919)
        try:
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
                    _upload(mask, device), _upload(narrow_cap[sl], device),
                    _upload(seeds[sl], device),
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
        finally:
            # end even on an error: a leaked span mis-parents every later
            # span on this thread
            if wave_span is not None:
                wave_span.set("admitted", int(admitted.sum()))
                wave_span.end()
        if not progress:
            break
    free_after = free.cpu().numpy()
    _sync(device)
    elapsed = time.perf_counter() - t0
    METRICS.set("gang_solve_waves", waves_used)

    return PackingResult(
        admitted=admitted[:g],
        placed=placed[:g],
        score=score[:g],
        chosen_level=chosen_level[:g],
        alloc=None if alloc is None else alloc[:g],
        free_after=free_after,
        solve_seconds=elapsed,
    )


def solve(
    problem: PackingProblem,
    with_alloc: bool = True,
    device: Optional[Union[str, torch.device]] = None,
    fill=fill_batch,
) -> PackingResult:
    """The exact sequential greedy (``ops.packing.solve_packing``): gangs in
    order, each against the capacity the earlier ones left, every level and
    cluster-wide tried. Runs on ``device`` (default: the card; raises
    without one); `fill` as in ``solve_waves``. ``solve_seconds`` is the
    solve after the upload, ending when `admitted` is on the host."""
    device = resolve_device(device)
    strict_fp32()
    host = _problem_arrays(problem)
    args = tuple(_upload(a, device) for a in host)
    grouped, pinned, spread, uniform = _flags(host)
    _sync(device)
    t0 = time.perf_counter()
    with TRACER.span("solver.execute", kernel="solve_packing", gangs=problem.num_gangs):
        out = solve_packing(
            *args, with_alloc=with_alloc, grouped=grouped, pinned=pinned, spread=spread,
            uniform=uniform, level_widths=level_widths_of(problem), fill=fill,
        )
        admitted = out["admitted"].cpu().numpy()  # waits for the device
    elapsed = time.perf_counter() - t0
    return PackingResult(
        admitted=admitted,
        placed=out["placed"].cpu().numpy(),
        score=out["score"].cpu().numpy(),
        chosen_level=out["chosen_level"].cpu().numpy(),
        alloc=None if out["alloc"] is None else out["alloc"].cpu().numpy(),
        free_after=out["free_after"].cpu().numpy(),
        solve_seconds=elapsed,
    )


def solve_waves_stats(
    problem: PackingProblem,
    chunk_size: int = BENCH_CHUNK_SIZE,
    max_waves: int = BENCH_MAX_WAVES,
    device: Optional[Union[str, torch.device]] = None,
    fill=fill_batch,
) -> PackingResult:
    """The stats path (the stress bench's solve): the whole wave loop in
    ``ops.packing.solve_waves_device`` (compaction, settled chunks skipped,
    lazy rescue for uniform problems, demand dedup), then the gangs still
    pending, or whose single fill ever missed, solved by the exact
    sequential greedy against the capacity left (the hybrid tail, padded
    to a power of two of at least 32 gangs). No per-pod allocations.
    ``solve_seconds`` is the wave solve plus the tail's solve, uploads
    excluded. Runs on ``device`` (default: the card; raises without one);
    `fill` as in ``solve_waves``."""
    device = resolve_device(device)
    strict_fp32()
    g = problem.num_gangs
    host, n_chunks, grouped, pinned, spread, uniform = pad_problem_for_waves(
        problem, chunk_size
    )
    args = tuple(_upload(a, device) for a in host)
    extra = {
        name: _upload(a, device)
        for name, a in dedup_extra_args(host[4], host[5], n_chunks, pinned).items()
    }
    _sync(device)
    t0 = time.perf_counter()
    with TRACER.span("solver.execute", kernel="solve_waves_device", gangs=g):
        out = solve_waves_device(
            *args, **extra, n_chunks=n_chunks, max_waves=max_waves, grouped=grouped,
            pinned=pinned, spread=spread, uniform=uniform,
            # all-or-nothing populations defer cluster rescues to the next
            # compacted wave instead of paying an in-wave second fill
            lazy_rescue=uniform, level_widths=level_widths_of(problem), fill=fill,
        )
        admitted = out["admitted"][:g].cpu().numpy()  # waits for the device
    elapsed = time.perf_counter() - t0
    placed = out["placed"][:g].cpu().numpy()
    score = out["score"][:g].cpu().numpy()
    chosen_level = out["chosen_level"][:g].cpu().numpy()
    free_after = out["free_after"].cpu().numpy()
    pending = out["pending"][:g].cpu().numpy()

    # hybrid tail: gangs that kept colliding past the wave budget (or whose
    # seed-picked domain missed) finish under the exact kernel
    idx = np.flatnonzero(pending)
    n_pending = idx.size
    if n_pending:
        t_pad = 32
        while t_pad < n_pending:
            t_pad *= 2
        arrays = _problem_arrays(problem, rows=idx, g_pad=t_pad)
        tail = PackingProblem(
            capacity=free_after,
            topo=problem.topo,
            seg_starts=problem.seg_starts,
            seg_ends=problem.seg_ends,
            **dict(zip(_GANG_FIELDS, arrays[4:])),
            priority=np.pad(problem.priority[idx], (0, t_pad - n_pending)),
        )
        tail_res = solve(tail, with_alloc=False, device=device, fill=fill)
        elapsed += tail_res.solve_seconds
        tail_admit = tail_res.admitted[:n_pending]
        admitted[idx] = tail_admit
        placed[idx] = np.where(tail_admit[:, None], tail_res.placed[:n_pending], placed[idx])
        score[idx] = np.where(tail_admit, tail_res.score[:n_pending], score[idx])
        chosen_level[idx] = np.where(
            tail_admit, tail_res.chosen_level[:n_pending], chosen_level[idx]
        )
        free_after = tail_res.free_after
        METRICS.set("gang_solve_tail", n_pending)
    METRICS.set("gang_solve_waves", int(out["waves"]))
    return PackingResult(
        admitted=admitted,
        placed=placed,
        score=score,
        chosen_level=chosen_level,
        alloc=None,
        free_after=free_after,
        solve_seconds=elapsed,
    )



def solve_waves_stacked(
    stack: Dict[str, np.ndarray],
    chunk_size: int = 32,
    max_waves: int = 16,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, object]:
    """Wave-parallel solve of a STACK of same-shape subproblems: the
    partitioned frontier's batched execution (``solver/frontier.py``).

    ``stack`` holds the lanes' problem arrays with a leading lane axis
    (``capacity [B,N,R]``, ``topo [B,N,L]``, ``seg_starts``/``seg_ends
    [B,L,D]``, gang arrays ``[B,G,...]``). The host loop is
    :func:`solve_waves`' for every lane at once: the same chunk clamp to
    ``min(chunk_size, G)`` and padding (the -1 sentinels), the same
    lane-local seeds ``arange(G) + wave*7919`` and commit, but each (wave,
    chunk) is ONE ``solve_wave_chunk_stack`` dispatch over all B lanes, in a
    ``solver.execute`` span. A lane's results equal :func:`solve_waves` on
    that lane alone, bit for bit (the frontier self-check's contract).

    Per dispatch the loop reads seven tensors back, as the JAX package
    does: accept, retry, new_cap and the masked placed, score,
    chosen_level and alloc. Runs on ``device`` (default: the card; raises
    without one), with that card current, so a worker thread may call it.
    Returns per-lane ``admitted [B,G]``, ``placed``, ``score``,
    ``chosen_level``, ``alloc [B,G,P,N]``, ``free_after [B,N,R]``,
    ``dispatches``, ``fill_launches`` and ``fill_rows`` (fill kernel
    launches during the dispatches and the gang rows they took; 0 on the
    CPU) and ``solve_seconds``."""
    device = resolve_device(device)
    strict_fp32()
    b, g, p_max, _r = stack["demand"].shape
    n = stack["capacity"].shape[1]
    chunk_size = min(chunk_size, max(g, 1))
    n_chunks = max(1, (g + chunk_size - 1) // chunk_size)
    g_pad = n_chunks * chunk_size

    def pad(a, value):
        if a.shape[1] == g_pad:
            return a
        width = [(0, 0), (0, g_pad - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, width, constant_values=value)

    # the per-gang arrays, in solve_wave_chunk_stack's argument order
    gang = [pad(stack[name], value) for name, value in zip(_GANG_FIELDS, _GANG_PADS)]
    count, min_count, group_req, gang_pin, spread_level = (gang[i] for i in (1, 2, 5, 7, 8))
    grouped = bool((group_req >= 0).any())
    pinned = bool((gang_pin >= 0).any())
    spread = bool((spread_level >= 0).any())
    # the AND over lanes: min == count for every gang (padded gangs 0 == 0)
    uniform = bool((min_count == count).all())
    n_levels = stack["topo"].shape[2]
    pending = np.zeros((b, g_pad), dtype=bool)
    pending[:, :g] = True
    narrow_cap = np.full((b, g_pad), n_levels - 1, dtype=np.int32)
    admitted = np.zeros((b, g_pad), dtype=bool)
    placed = np.zeros_like(count)
    score = np.zeros((b, g_pad), dtype=np.float32)
    chosen_level = np.full((b, g_pad), -1, dtype=np.int32)
    alloc = np.zeros((b, g_pad, p_max, n), dtype=np.int32)

    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        free = _upload(stack["capacity"], device)
        node = tuple(_upload(stack[k], device) for k in ("topo", "seg_starts", "seg_ends"))
        # immutable chunk tensors go to the device once
        chunk_const = [
            tuple(_upload(a[:, c * chunk_size : (c + 1) * chunk_size], device) for a in gang)
            for c in range(n_chunks)
        ]
        _sync(device)
        launches0, rows0 = fill_batch.launches, fill_batch.rows
        t0 = time.perf_counter()
        dispatches = 0
        for wave in range(max_waves):
            if not pending.any():
                break
            # lane-LOCAL seeds: a lane's gang keeps the seed it has solving alone
            seeds = np.repeat(
                np.arange(g_pad, dtype=np.int32)[None] + np.int32(wave * 7919), b, axis=0
            )
            for c in range(n_chunks):
                sl = slice(c * chunk_size, (c + 1) * chunk_size)
                mask = pending[:, sl]
                if not mask.any():
                    continue
                dem, cnt, mn, rq, pf, grq, gpin, gangpin, slvl, smin, sreq, sseed = chunk_const[c]
                with TRACER.span("solver.execute", kernel="solve_wave_chunk_stack", gangs=g):
                    out = solve_wave_chunk_stack(
                        free, *node, dem, cnt, mn, rq, pf,
                        _upload(mask, device), _upload(narrow_cap[:, sl], device),
                        _upload(seeds[:, sl], device),
                        grq, gpin, gangpin, slvl, smin, sreq, sseed,
                        grouped=grouped, pinned=pinned, spread=spread, uniform=uniform,
                    )
                    free, accept_d, retry_d, new_cap_d, placed_d, score_d, chosen_d, alloc_d = out
                    committed = accept_d.cpu().numpy()  # waits for the device
                dispatches += 1
                retry = retry_d.cpu().numpy()
                admitted[:, sl] |= committed
                placed[:, sl] = np.where(committed[:, :, None], placed_d.cpu().numpy(), placed[:, sl])
                score[:, sl] = np.where(committed, score_d.cpu().numpy(), score[:, sl])
                chosen_level[:, sl] = np.where(committed, chosen_d.cpu().numpy(), chosen_level[:, sl])
                narrow_cap[:, sl] = new_cap_d.cpu().numpy()
                alloc[:, sl] = np.where(
                    committed[:, :, None, None], alloc_d.cpu().numpy(), alloc[:, sl]
                )
                pending[:, sl] = mask & retry
        free_after = free.cpu().numpy()
        elapsed = time.perf_counter() - t0
    return {
        "admitted": admitted[:, :g],
        "placed": placed[:, :g],
        "score": score[:, :g],
        "chosen_level": chosen_level[:, :g],
        "alloc": alloc[:, :g],
        "free_after": free_after,
        "dispatches": dispatches,
        "fill_launches": fill_batch.launches - launches0,
        "fill_rows": fill_batch.rows - rows0,
        "solve_seconds": elapsed,
    }
