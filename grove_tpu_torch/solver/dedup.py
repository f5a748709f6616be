"""Host-side (numpy) preparation for the wave solver.

Counterpart of the numpy helpers in ``grove_tpu/solver/kernel.py``
(``_spread_arrays``, ``dedup_demand``, ``dedup_extra_args``,
``level_widths_of``), which the port keeps as its own copy because that
module imports JAX.
"""

from __future__ import annotations

import numpy as np

from grove_tpu_torch.solver.types import PackingProblem


def _spread_arrays(problem: PackingProblem):
    """Spread tensors with sentinel defaults (problems built by hand may
    leave them None)."""
    g = problem.num_gangs
    sl = (
        problem.spread_level
        if problem.spread_level is not None
        else np.full((g,), -1, dtype=np.int32)
    )
    sm = (
        problem.spread_min
        if problem.spread_min is not None
        else np.zeros((g,), dtype=np.int32)
    )
    sr = (
        problem.spread_required
        if problem.spread_required is not None
        else np.zeros((g,), dtype=bool)
    )
    ss = (
        problem.spread_seed
        if problem.spread_seed is not None
        else np.zeros((g, 0), dtype=np.int32)
    )
    return sl, sm, sr, ss


def dedup_demand(demand: np.ndarray, count: np.ndarray, chunk_size: int):
    """Encode-time (demand, count)-pair dedup for the wave solver.

    Template-stamped gang populations repeat identical (demand row, count)
    pairs: the wave kernel computes the candidate scan's capped-fit prefix
    sums once per UNIQUE pair per chunk and turns each gang's level loop
    into boundary gathers of the SAME integer values — bit-exact. Returns
    `(pair_demand [U,R], pair_count [U], pair_idx [G,P])` with row 0
    reserved all-zero (gangs masked out by the pending filter redirect
    there on device), or `(None, None, None)` when dedup cannot pay: the
    shared table is recomputed per chunk, so it only wins when U is well
    below the chunk's own C*P row count.
    """
    g, p, r = demand.shape
    key = np.concatenate(
        [
            np.ascontiguousarray(demand.reshape(g * p, r)),
            count.reshape(g * p, 1).astype(demand.dtype),
        ],
        axis=1,
    )
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    if (uniq[0] != 0).any():
        # demands/counts are non-negative, so an all-zero row sorts first
        # when present; otherwise reserve index 0 explicitly
        uniq = np.vstack([np.zeros((1, r + 1), dtype=uniq.dtype), uniq])
        inv = inv + 1
    if uniq.shape[0] * 2 > chunk_size * p:
        return None, None, None
    return (
        uniq[:, :r].astype(demand.dtype, copy=False),
        uniq[:, r].astype(np.int32),
        inv.reshape(g, p).astype(np.int32),
    )


def dedup_extra_args(
    demand: np.ndarray, count: np.ndarray, n_chunks: int, pinned: bool
) -> dict:
    """The dedup guard + decline heuristic + packaging: numpy arrays for the
    wave solver's `pair_*` arguments ({} when dedup is off). `pinned`
    problems skip dedup (per-gang capacity views break the shared-snapshot
    premise). The caller uploads the arrays."""
    if pinned:
        return {}
    pdem, pcnt, pidx = dedup_demand(demand, count, demand.shape[0] // n_chunks)
    if pdem is None:
        return {}
    return {"pair_demand": pdem, "pair_count": pcnt, "pair_idx": pidx}


def level_widths_of(problem: PackingProblem) -> tuple:
    """Per-level REAL domain counts (dense ids ⇒ max id + 1), the
    `level_widths` for the wave solver's ragged candidate scan."""
    topo = np.asarray(problem.topo)
    if topo.size == 0:
        return tuple(1 for _ in range(topo.shape[1]))
    return tuple(int(topo[:, l].max()) + 1 for l in range(topo.shape[1]))
