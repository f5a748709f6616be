"""Wave-solver packing core in PyTorch, batched over a chunk of gangs.

Counterpart of ``grove_tpu/ops/packing.py`` for the sidecar's solve path:
``solve_wave_chunk`` → ``wave_chunk_core`` → ``gang_select_single`` → the
fill. Where the JAX package vmaps one gang's decision over the chunk, the
port writes the chunk axis C out as the leading dimension of every tensor:
the fill kernel's grid IS the chunk axis, and ``torch.func.vmap`` has no
batching rule for it.

This slice covers the flagless problems: no per-group packs (``grouped``),
no recovery pins (``pinned``), no spread constraints (``spread``), and the
eager spill/rescue second fill (``lazy_rescue=False``). Solving a problem
that sets one of those flags raises ``NotImplementedError`` in
``solver.kernel.solve_waves``.

Semantics (the PodGang contract):
- a gang is ADMITTED iff every group places >= min_count pods; extra pods up
  to `count` are placed best-effort with the gang.
- `req_level`: the gang must fit inside ONE domain at that level or
  narrower; no cluster-wide fallback.
- `pref_level`: that level is tried first, then the closest levels
  (narrower wins ties), then cluster-wide scatter. -1 → narrowest.
- PlacementScore: level-weighted share of the gang's pods inside its
  dominant domain per level; 1.0 = everything in one narrowest domain.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from grove_tpu_torch.ops.fill import (  # noqa: F401  (re-exported primitives)
    _INT_CAP,
    _pods_fit_per_node,
    _seg_cumsum,
    fill_batch,
)

# narrow-cap sentinel of the lazy-rescue path ("retry with the cluster-wide
# fill only"); the eager path never produces it
_CLUSTER_RETRY = -2


class GangInputs(NamedTuple):
    """One chunk of gangs, chunk axis first."""

    demand: torch.Tensor  # [C, P, R] f32
    count: torch.Tensor  # [C, P] i32
    min_count: torch.Tensor  # [C, P] i32
    req_level: torch.Tensor  # [C] i32
    pref_level: torch.Tensor  # [C] i32
    # demand-dedup PAIR index ([C, P] i32, None = dedup off): row of the
    # chunk's shared `cs_pair [U, N+1]` capped-fit prefix table for this
    # group's (demand, count) pair; row 0 is the all-zero pair
    uidx: Optional[torch.Tensor] = None


def _fill_floors_first(
    free, mask, demand, count, min_count, uniform, fill, with_free_after=True
):
    """Two-phase fill: every group's admission FLOOR first, then the
    best-effort extras (an early group's extras must never starve a later
    group's floor). Floors are clamped to the count and extras to >= 0.
    `uniform` (min_count == count for every gang of the problem): extras
    are zero everywhere, so one fill does. Returns (alloc [C,P,N],
    placed [C,P], placed_min [C,P], free_after [C,N,R]); free_after is None
    with ``with_free_after=False`` (only the chain's last fill drops it:
    the floors fill's capacity feeds the extras fill)."""
    if uniform:
        alloc, placed, free_after = fill(
            free, mask, demand, torch.minimum(min_count, count),
            with_free_after=with_free_after,
        )
        return alloc, placed, placed, free_after
    floors = torch.minimum(min_count, count)
    extras = torch.clamp(count - min_count, min=0)
    alloc_min, placed_min, free1 = fill(free, mask, demand, floors)
    alloc_ext, placed_ext, free2 = fill(
        free1, mask, demand, extras, with_free_after=with_free_after
    )
    return alloc_min + alloc_ext, placed_min + placed_ext, placed_min, free2


def _dispatch_with_spread(free, mask, gang: GangInputs, uniform, fill, with_free_after=True):
    """The ``spread=False`` (and ``grouped=False``) form of the JAX
    dispatch: the floors-first fill, no spread-level domains used.
    Returns (alloc, placed, placed_min, free_after)."""
    return _fill_floors_first(
        free, mask, gang.demand, gang.count, gang.min_count, uniform, fill,
        with_free_after,
    )


def _spread_admit(gang: GangInputs) -> bool:
    """``spread=False`` form: no gang carries a hard spread, every
    placement passes."""
    return True


def _spread_score(coloc: torch.Tensor) -> torch.Tensor:
    """``spread=False`` form: the PlacementScore is the co-location score."""
    return coloc


def _strided_hash(seed: torch.Tensor) -> torch.Tensor:
    """Per-gang draw in [0, 1) for the strided domain pick:
    (seed * 40503 mod 2^16) / 2^16. `seed` must be int32 so the product
    wraps as in the JAX package; `remainder` is the sign-of-divisor mod of
    ``jnp.mod`` (``fmod`` is not)."""
    if seed.dtype != torch.int32:
        raise TypeError(f"seeds must be int32, got {seed.dtype}")
    return torch.remainder(seed * 40503, 1 << 16).to(torch.float32) / (1 << 16)


def _level_weights(num_levels: int, device) -> torch.Tensor:
    w = torch.arange(1, num_levels + 1, dtype=torch.float32, device=device)
    return w / w.sum()


def _gang_pin_mask(free: torch.Tensor, n_nodes: int):
    """``pinned=False`` form: every node is visible and the capacity view is
    the shared snapshot. Returns (pin_mask [N] bool, free_vis)."""
    return torch.ones((n_nodes,), dtype=torch.bool, device=free.device), free


def _aggregate_tables(free: torch.Tensor, gang: GangInputs, cs_pair=None):
    """Shared prelude of the selector: capped per-node fit counts and their
    prefix sums ``cs_k [C,P,N+1]`` (None on the dedup path, where the level
    loop gathers from ``cs_pair`` instead), the free-capacity prefix
    ``cs_free [N+1,R]`` (one snapshot for the whole chunk), its float
    tolerance, and the admission floor's joint demand ``[C,R]``."""
    active = gang.count > 0
    if cs_pair is not None and gang.uidx is not None:
        cs_k = None
    else:
        # free [N,R] against demand [C,P,R] → [C,P,N]; cap per-node fits at
        # the group count (keeps the int32 prefix sums exact)
        k_all = _pods_fit_per_node(free, gang.demand)
        k_all = torch.minimum(k_all, gang.count.unsqueeze(-1))
        zero_col = torch.zeros(k_all.shape[:2] + (1,), dtype=k_all.dtype, device=k_all.device)
        cs_k = torch.cat([zero_col, _seg_cumsum(k_all, -1)], -1)
    min_demand = (gang.min_count.unsqueeze(-1).to(free.dtype) * gang.demand).sum(1)
    cs_free = torch.cat(
        [
            torch.zeros((1, free.shape[1]), dtype=free.dtype, device=free.device),
            _seg_cumsum(free, 0),
        ],
        0,
    )
    # float32 prefix sums of byte-scale capacity accumulate rounding error;
    # slack the joint check so it can only false-KEEP (the fill is exact)
    free_tol = 1e-5 * cs_free[-1]
    return active, cs_k, cs_free, free_tol, min_demand


def _coloc_score(alloc, placed_total, seg_starts, seg_ends, weights, ok, seg_list=None):
    """Level-weighted dominant-domain co-location score per gang ``[C]``.
    `seg_list`: per-level ragged (starts, ends) views (the padded rows pad
    every level to the broadest level's domain count)."""
    n_levels = seg_starts.shape[0] if seg_list is None else len(seg_list)
    pods_per_node = alloc.sum(1, dtype=torch.int32)  # [C, N]
    total = torch.clamp(placed_total.sum(1, dtype=torch.int32), min=1)
    zero = torch.zeros((alloc.shape[0], 1), dtype=torch.int32, device=alloc.device)
    cs_pods = torch.cat([zero, _seg_cumsum(pods_per_node, -1)], -1)
    score = torch.zeros(alloc.shape[:1], dtype=torch.float32, device=alloc.device)
    for l in range(n_levels):
        starts, ends = seg_list[l] if seg_list is not None else (seg_starts[l], seg_ends[l])
        dominant = (cs_pods[:, ends] - cs_pods[:, starts]).amax(1)
        score = score + weights[l] * (
            dominant.to(torch.float32) / total.to(torch.float32)
        )
    return torch.clamp(torch.where(ok, score, 0.0), 0.0, 1.0)


def gang_select_single(
    free, topo, seg_starts, seg_ends, gang: GangInputs, narrow_cap, seed,
    cs_pair=None, seg_list=None, uniform: bool = False, fill=fill_batch,
):
    """Decide a chunk of gangs against one capacity snapshot ``free [N,R]``.

    Candidate levels are ranked by aggregate feasibility (prefix-sum
    boundary gathers); ONE fill is attempted at the best allowed level (or
    cluster-wide when none), then a second fill either spills the
    best-effort extras cluster-wide or, when the level fill missed the
    floor and no broader feasible level remains, rescues the gang
    cluster-wide. A fill that misses the floor lowers `narrow_cap` for the
    next wave (fallback_cap).

    Returns (alloc [C,P,N], placed [C,P], ok [C], chosen [C] (level index,
    n_levels for cluster-wide, -1 when nothing allowed), score [C],
    had_candidate [C], fallback_cap [C]).
    """
    n_nodes, n_levels = topo.shape
    c = gang.demand.shape[0]
    device = free.device
    weights = _level_weights(n_levels, device)

    pin_mask, free_vis = _gang_pin_mask(free, n_nodes)
    active, cs_k, cs_free, free_tol, min_demand = _aggregate_tables(
        free_vis, gang, cs_pair
    )
    any_active = active.any(1)
    if cs_k is None:
        # dedup path: masked-out gangs (count zeroed by the pending filter)
        # read the reserved all-zero row 0
        eff = torch.where(active, gang.uidx, 0).long()

    h = _strided_hash(seed)
    oks, bests = [], []
    for l in range(n_levels):
        starts, ends = seg_list[l] if seg_list is not None else (seg_starts[l], seg_ends[l])
        if cs_k is None:
            row = eff.unsqueeze(-1)
            K = cs_pair[row, ends] - cs_pair[row, starts]  # [C, P, D]
        else:
            K = cs_k[:, :, ends] - cs_k[:, :, starts]
        free_agg = cs_free[ends] - cs_free[starts]  # [D, R]
        act = active.unsqueeze(-1)
        feas = torch.where(act, K >= gang.min_count.unsqueeze(-1), True).all(1)
        feas = feas & (
            free_agg.unsqueeze(0) >= (min_demand - free_tol).unsqueeze(1)
        ).all(-1)
        feas = feas & (ends > starts).unsqueeze(0)
        feas = feas & any_active.unsqueeze(-1)
        # STRIDED choice: gangs deciding in parallel must not all pick the
        # same domain; prefer domains that hold the FULL count, weight the
        # pick by how many copies of the gang each domain can host
        feas_full = feas & torch.where(act, K >= gang.count.unsqueeze(-1), True).all(1)
        pool = torch.where(feas_full.any(1, keepdim=True), feas_full, feas)
        w = torch.where(pool, K.sum(1, dtype=torch.int32), 0).to(torch.float32)
        cum_w = _seg_cumsum(w, -1)
        total_w = cum_w[:, -1]
        u = h * total_w
        best = (cum_w > u.unsqueeze(-1)).to(torch.int32).argmax(1)
        # degenerate fallback (all weights zero): first pool domain
        best = torch.where(total_w > 0, best, pool.to(torch.int32).argmax(1))
        oks.append(feas.any(1))
        bests.append(best)
    oks = torch.stack(oks, 1)  # [C, L]
    bests = torch.stack(bests, 1)  # [C, L]

    lv = torch.arange(n_levels, device=device)
    req = gang.req_level
    min_allowed = torch.where(req >= 0, req, 0)
    allowed = (
        oks
        & (lv >= min_allowed.unsqueeze(-1))
        & (lv <= narrow_cap.unsqueeze(-1))
    )
    pref_eff = torch.where(gang.pref_level >= 0, gang.pref_level, n_levels - 1)
    dist = (lv - pref_eff.unsqueeze(-1)).abs()
    level_rank = 2 * (n_levels - dist) + (lv > pref_eff.unsqueeze(-1)).long()
    has_level = allowed.any(1)
    chosen_level = torch.where(allowed, level_rank + 1, 0).argmax(1)  # [C]
    use_cluster = (~has_level) & (req < 0) & any_active
    had_candidate = has_level | use_cluster

    all_nodes = torch.ones((c, n_nodes), dtype=torch.bool, device=device)
    best_sel = bests.gather(1, chosen_level.unsqueeze(-1))  # [C, 1]
    packed_mask = (topo.t()[chosen_level] == best_sel) & pin_mask
    mask = torch.where(has_level.unsqueeze(-1), packed_mask, use_cluster.unsqueeze(-1))

    alloc, placed, placed_min, free_after = _dispatch_with_spread(
        free, mask.contiguous(), gang, uniform, fill
    )
    level_fill_ok = (
        had_candidate
        & any_active
        & torch.where(active, placed_min >= gang.min_count, True).all(1)
        & _spread_admit(gang)
    )

    # when the level fill fails, the retry cap jumps straight to the next
    # BROADER level whose aggregates looked feasible (skip hopeless levels)
    lower_feasible = torch.where(allowed & (lv < chosen_level.unsqueeze(-1)), lv, -1)
    fallback_cap = lower_feasible.amax(1)

    # Second fill doubles as both paths:
    # - level fill met the floor → best-effort extras spill cluster-wide
    # - level fill missed the floor AND no broader feasible level remains
    #   (and no required pack) → cluster-wide scatter as a last resort
    no_req = req < 0
    cluster_rescue = has_level & ~level_fill_ok & no_req & (fallback_cap < 0) & any_active
    spill = level_fill_ok & has_level & no_req
    base_free = torch.where(cluster_rescue[:, None, None], free, free_after)
    remaining = torch.where(
        cluster_rescue.unsqueeze(-1),
        gang.count,
        torch.where(spill.unsqueeze(-1), gang.count - placed, 0),
    )
    rescue_min = torch.where(cluster_rescue.unsqueeze(-1), gang.min_count, 0)
    # the capacity this fill leaves is not used: it is not written
    alloc2, placed2, placed2_min, _ = _dispatch_with_spread(
        base_free.contiguous(), all_nodes,
        gang._replace(count=remaining, min_count=rescue_min), uniform, fill,
        with_free_after=False,
    )
    rescue_ok = (
        cluster_rescue
        & torch.where(active, placed2_min >= gang.min_count, True).all(1)
        & _spread_admit(gang)
    )
    r3, s3 = rescue_ok[:, None, None], spill[:, None, None]
    alloc = torch.where(r3, alloc2, torch.where(s3, alloc + alloc2, alloc))
    r2, s2 = rescue_ok.unsqueeze(-1), spill.unsqueeze(-1)
    placed = torch.where(r2, placed2, torch.where(s2, placed + placed2, placed))
    fill_ok = level_fill_ok | rescue_ok
    chosen_level = torch.where(rescue_ok, n_levels, chosen_level)
    has_level = has_level & ~rescue_ok
    use_cluster = use_cluster | rescue_ok

    # epilogue: mask out failed fills, score, pick the reported level
    alloc = torch.where(fill_ok[:, None, None], alloc, 0)
    placed = torch.where(fill_ok.unsqueeze(-1), placed, 0)
    score = _coloc_score(alloc, placed, seg_starts, seg_ends, weights, fill_ok, seg_list)
    score = torch.where(fill_ok, _spread_score(score), 0.0)
    chosen = torch.where(
        has_level, chosen_level, torch.where(use_cluster, n_levels, -1)
    )
    return (
        alloc,
        placed,
        fill_ok,
        chosen.to(torch.int32),
        score,
        had_candidate,
        fallback_cap.to(torch.int32),
    )


def wave_chunk_core(
    free, topo, seg_starts, seg_ends,
    dem, cnt, mn, rq, pf, pend, ncap, seeds, commit_iters,
    pair_dem=None, pair_cap=None, uidx=None, uniform=False, seg_list=None,
    fill=fill_batch,
):
    """Decide one chunk of gangs in parallel against one capacity snapshot,
    commit by iterative prefix-acceptance with a final joint-feasibility
    guarantee, and produce the retry/narrow-cap bookkeeping for the next
    wave.

    `pair_dem [U,R]` + `pair_cap [U]` + `uidx [C,P]` (optional demand
    dedup): the capped-fit prefix sums are computed once per UNIQUE
    (demand, count) pair; each gang's level loop gathers the SAME integer
    values (bit-exact).
    Returns (free, accept, placed, score, chosen, retry, new_cap,
    fill_failed, alloc)."""
    cnt = cnt * pend.unsqueeze(-1)
    use_dedup = pair_dem is not None and uidx is not None
    cs_pair = None
    if use_dedup:
        fit_pair = torch.minimum(
            _pods_fit_per_node(free, pair_dem), pair_cap.unsqueeze(-1)
        )  # [U, N]
        zero = torch.zeros((fit_pair.shape[0], 1), dtype=fit_pair.dtype, device=free.device)
        cs_pair = torch.cat([zero, _seg_cumsum(fit_pair, -1)], -1)  # [U, N+1]
    gang = GangInputs(dem, cnt, mn, rq, pf, uidx if use_dedup else None)
    alloc, placed, ok, chosen, score, had_cand, fallback_cap = gang_select_single(
        free, topo, seg_starts, seg_ends, gang, ncap, seeds, cs_pair, seg_list,
        uniform=uniform, fill=fill,
    )

    # integer-valued products: exact in float32 (TF32 must be off on CUDA)
    usage = torch.einsum("cpn,cpr->cnr", alloc.to(free.dtype), dem)  # [C,N,R]
    limit = free.unsqueeze(0) + 1e-6

    def prefix_fits(acc):
        cum = _seg_cumsum(torch.where(acc[:, None, None], usage, 0.0), 0)
        return (cum <= limit).flatten(1).all(1)

    accept = ok
    for _ in range(commit_iters):
        accept = ok & prefix_fits(accept)
    # final guarantee: with this accept set, every accepted prefix fits
    accept = accept & prefix_fits(accept)
    free = free - torch.where(accept[:, None, None], usage, 0.0).sum(0)

    # retry bookkeeping: a failed fill jumps the cap straight to the next
    # broader aggregate-feasible level; cluster fallback was already
    # attempted in-wave, so a -1 cap means the gang is done for good
    fill_failed = pend & had_cand & ~ok
    new_cap = torch.where(fill_failed, fallback_cap, ncap)
    min_allowed = torch.where(rq >= 0, rq, 0)
    retry = pend & ((ok & ~accept) | (fill_failed & (new_cap >= min_allowed)))
    return (
        free,
        accept & pend,
        placed,
        score,
        chosen,
        retry,
        new_cap,
        fill_failed,
        alloc,
    )


def solve_wave_chunk(
    free,  # [N, R] f32
    topo,  # [N, L] i32
    seg_starts,  # [L, D] i32
    seg_ends,  # [L, D] i32
    demand,  # [C, P, R] f32 — one CHUNK of gangs
    count,  # [C, P] i32
    min_count,  # [C, P] i32
    req_level,  # [C] i32
    pref_level,  # [C] i32
    pending,  # [C] bool
    narrow_cap,  # [C] i32
    seeds,  # [C] i32
    pair_demand=None,  # [U, R] f32
    pair_count=None,  # [U] i32
    pair_idx=None,  # [C, P] i32
    commit_iters: int = 2,
    uniform: bool = False,
    level_widths: tuple = None,
    fill=fill_batch,
):
    """One wave over one chunk, with per-pod allocations (the binding path).
    `level_widths`: per-level real domain counts for the ragged candidate
    scan. `fill`: the fill implementation — the kernel wrapper by default;
    tests pass ``fill_batch_ref`` to hold the kernel against its plain
    version inside the path. Returns a dict of the chunk's results."""
    seg_starts = seg_starts.long()
    seg_ends = seg_ends.long()
    seg_list = None
    if level_widths is not None:
        seg_list = tuple(
            (seg_starts[l, :w], seg_ends[l, :w]) for l, w in enumerate(level_widths)
        )
    free_after, accept, placed, score, chosen, retry, new_cap, _, alloc = (
        wave_chunk_core(
            free, topo, seg_starts, seg_ends,
            demand, count, min_count, req_level, pref_level,
            pending, narrow_cap, seeds, commit_iters,
            pair_dem=pair_demand, pair_cap=pair_count, uidx=pair_idx,
            uniform=uniform, seg_list=seg_list, fill=fill,
        )
    )
    n_levels = topo.shape[1]
    return {
        "admitted": accept,
        "retry": retry,
        "new_cap": new_cap,
        "placed": torch.where(accept.unsqueeze(-1), placed, 0),
        "score": torch.where(accept, score, 0.0),
        "chosen_level": torch.where(
            accept, torch.where(chosen >= n_levels, -1, chosen), -1
        ).to(torch.int32),
        "alloc": torch.where(accept[:, None, None], alloc, 0),
        "free_after": free_after,
    }
