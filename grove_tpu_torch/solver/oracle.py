"""Reference oracle: a plain-NumPy greedy packer with the solver's semantics.

Counterpart of ``grove_tpu/solver/oracle.py`` (``solve_oracle``, the same
arithmetic step for step, so both packages' oracles agree bit for bit). The
quality gate of BASELINE.md holds the solver within 0.5% of this oracle's
placement quality. Written for clarity, not speed: it loops over gangs,
groups and domains exactly as the solver's math does, so small cases can be
compared assignment by assignment and large cases score by score. It reads
NumPy arrays only and runs on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from grove_tpu_torch.solver.types import PackingProblem, PackingResult


def _pods_fit(free: np.ndarray, demand_p: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.floor(free / np.where(demand_p > 0, demand_p, 1.0))
    ratio = np.where(demand_p > 0, ratio, np.inf)
    k = ratio.min(axis=1)
    return np.clip(k, 0, 1 << 20).astype(np.int64)


def _fill(free, mask, demand, count):
    P, _ = demand.shape
    N = free.shape[0]
    alloc = np.zeros((P, N), dtype=np.int64)
    placed = np.zeros((P,), dtype=np.int64)
    free = free.copy()
    for p in range(P):
        k = _pods_fit(free, demand[p])
        k[~mask] = 0
        k = np.minimum(k, count[p])
        cum = np.cumsum(k) - k
        take = np.clip(count[p] - cum, 0, k)
        alloc[p] = take
        placed[p] = take.sum()
        free -= take[:, None] * demand[p][None, :]
    return alloc, placed, free


def _fill_grouped(
    free, mask, demand, count, min_count, group_req, group_pin,
    topo, seg_starts, seg_ends,
):
    """Mirror of the kernel's grouped fill (seed 0): per-group domain choice
    at each group's required level inside `mask`; floors of all groups before
    any extras; a constrained group's extras stay in its domain."""
    p_dim = demand.shape[0]
    floors = np.minimum(min_count, count)
    extras = np.maximum(count - min_count, 0)

    def group_mask(free_c, p):
        k = _pods_fit(free_c, demand[p])
        k = np.minimum(np.where(mask, k, 0), max(int(floors[p]), 1))
        if group_req[p] < 0:
            return mask
        lvl = int(group_req[p])
        cs = np.concatenate([[0], np.cumsum(k)])
        starts, ends = seg_starts[lvl], seg_ends[lvl]
        K = cs[ends] - cs[starts]
        feas = (K >= floors[p]) & (ends > starts)
        w = np.where(feas, K, 0).astype(np.float32)
        cum_w = np.cumsum(w, dtype=np.float32)
        # seed 0 → u = 0 → first feasible domain (kernel parity)
        best = int(np.argmax(cum_w > 0)) if cum_w[-1] > 0 else int(np.argmax(feas))
        ok_any = bool(feas.any())
        if group_pin[p] >= 0:  # recovery pin (kernel parity)
            best = int(group_pin[p])
            ok_any = True
        return (topo[:, lvl] == best) & mask & ok_any

    free_c = free.copy()
    masks = []
    alloc_rows = []
    floor_placed = []
    extra_placed = []
    for p in range(p_dim):
        mask_p = group_mask(free_c, p)
        masks.append(mask_p)
        a, pl, free_c = _fill(free_c, mask_p, demand[p : p + 1], floors[p : p + 1])
        alloc_rows.append(a[0])
        floor_placed.append(pl[0])
    for p in range(p_dim):
        a, pl, free_c = _fill(free_c, masks[p], demand[p : p + 1], extras[p : p + 1])
        alloc_rows[p] = alloc_rows[p] + a[0]
        extra_placed.append(pl[0])
    alloc = np.stack(alloc_rows)
    placed_min = np.array(floor_placed)
    placed = placed_min + np.array(extra_placed)
    return alloc, placed, placed_min, free_c


def _level_weights(L: int) -> np.ndarray:
    w = np.arange(1, L + 1, dtype=np.float64)
    return w / w.sum()


def solve_oracle(problem: PackingProblem) -> PackingResult:
    cap = problem.capacity.astype(np.float64).copy()
    topo = problem.topo
    N, L = topo.shape
    G, P, R = problem.demand.shape
    weights = _level_weights(L)

    admitted = np.zeros((G,), dtype=bool)
    placed_out = np.zeros((G, P), dtype=np.int32)
    score_out = np.zeros((G,), dtype=np.float32)
    chosen_out = np.full((G,), -1, dtype=np.int32)
    alloc_out = np.zeros((G, P, N), dtype=np.int32)

    for g in range(G):
        demand = problem.demand[g].astype(np.float64)
        count = problem.count[g].astype(np.int64)
        min_count = problem.min_count[g].astype(np.int64)
        group_req = problem.group_req[g].astype(np.int64)
        group_pin = problem.group_pin[g].astype(np.int64)
        active = count > 0
        if not active.any():
            continue
        req = int(problem.req_level[g])
        gang_pin = int(problem.gang_pin[g]) if problem.gang_pin is not None else -1

        # gang-level recovery pin (kernel parity): confine aggregates and
        # fills to the survivors' domain at the required level
        if gang_pin >= 0 and req >= 0:
            pin_mask = topo[:, req] == gang_pin
        else:
            pin_mask = np.ones((N,), dtype=bool)
        cap_vis = np.where(pin_mask[:, None], cap, 0.0)

        # per-level candidate domain (joint-aware aggregate feasibility,
        # best-fit tie-break), attempted in preference order; the fill is the
        # ground truth - first level whose fill meets the floor wins.
        # Aggregates mirror the kernel: per-node fits capped at the group
        # count, contiguous-domain boundary gathers on prefix sums, float32
        # capacity prefix sums with the same tolerance slack.
        k_all = np.stack(
            [np.minimum(_pods_fit(cap_vis, demand[p]), count[p]) for p in range(P)]
        )
        cs_k = np.concatenate(
            [np.zeros((P, 1), dtype=np.int64), np.cumsum(k_all, axis=1)], axis=1
        )
        cs_free = np.concatenate(
            [
                np.zeros((1, R), dtype=np.float32),
                np.cumsum(cap_vis.astype(np.float32), axis=0, dtype=np.float32),
            ],
            axis=0,
        )
        free_tol = 1e-5 * cs_free[-1]
        min_demand = (min_count[:, None] * demand).sum(axis=0)  # [R]
        min_allowed = req if req >= 0 else 0
        pref = int(problem.pref_level[g])
        pref_eff = pref if pref >= 0 else L - 1
        # same preference order as the kernel: closest to preferred level,
        # narrower wins ties, required floor respected
        level_order = sorted(
            range(min_allowed, L),
            key=lambda l: (abs(l - pref_eff), l <= pref_eff),
        )
        chosen_level = None
        alloc = placed = free_after = None
        for l in level_order:
            starts = problem.seg_starts[l]
            ends = problem.seg_ends[l]
            K = cs_k[:, ends] - cs_k[:, starts]  # [P, D]
            free_agg = cs_free[ends] - cs_free[starts]  # [D, R]
            feas = np.all(free_agg >= (min_demand - free_tol)[None, :], axis=1)
            feas &= ends > starts
            spare = np.zeros((len(starts),))
            for p in range(P):
                if active[p]:
                    feas &= K[p] >= min_count[p]
                    spare += K[p] - count[p]
            if not feas.any():
                continue
            # mirror the kernel's best-fit key: spare, tie-broken toward the
            # least total free capacity (float32 arithmetic for parity)
            free_total = free_agg.sum(axis=1)
            tie = (free_total / (free_total.max() + 1.0)).astype(np.float32)
            key = spare.astype(np.float32) + tie
            key[~feas] = np.inf
            mask = (topo[:, l] == int(np.argmin(key))) & pin_mask
            a, pl, pl_min, fa = _fill_grouped(
                cap, mask, demand, count, min_count, group_req, group_pin,
                topo, problem.seg_starts, problem.seg_ends,
            )
            if all(pl_min[p] >= min_count[p] for p in range(P) if active[p]):
                chosen_level, alloc, placed, free_after = l, a, pl, fa
                break

        if chosen_level is None:
            if req >= 0:
                continue  # required pack unsatisfiable → unplaced
            mask = np.ones((N,), dtype=bool)  # cluster-wide fallback
            alloc, placed, pl_min, free_after = _fill_grouped(
                cap, mask, demand, count, min_count, group_req, group_pin,
                topo, problem.seg_starts, problem.seg_ends,
            )
            if not all(pl_min[p] >= min_count[p] for p in range(P) if active[p]):
                continue  # all-or-nothing: no capacity consumed
        elif req < 0:
            # best-effort extras spill cluster-wide (unconstrained groups only)
            spill_counts = np.where(group_req < 0, count - placed, 0)
            alloc2, placed2, free_after = _fill(
                free_after, np.ones((N,), dtype=bool), demand, spill_counts
            )
            alloc += alloc2
            placed += placed2

        cap = free_after
        admitted[g] = True
        placed_out[g] = placed
        alloc_out[g] = alloc
        chosen_out[g] = -1 if chosen_level is None else chosen_level

        pods_per_node = alloc.sum(axis=0)
        total = max(int(placed.sum()), 1)
        score = 0.0
        for l in range(L):
            agg = np.bincount(
                topo[:, l], weights=pods_per_node, minlength=topo[:, l].max() + 1
            )
            score += weights[l] * (agg.max() / total)
        score_out[g] = min(score, 1.0)

    return PackingResult(
        admitted=admitted,
        placed=placed_out,
        score=score_out,
        chosen_level=chosen_out,
        alloc=alloc_out,
        free_after=cap.astype(np.float32),
    )
