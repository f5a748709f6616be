"""Wave-solver packing core in PyTorch, batched over a chunk of gangs.

Counterpart of ``grove_tpu/ops/packing.py``. Three solvers share the
per-gang selection and the fill:

- ``solve_wave_chunk``: one wave over one chunk with per-pod allocations
  (the binding path's host loop, ``solver.kernel.solve_waves``);
- ``solve_waves_device``: the whole multi-wave loop of the stats path
  (compaction of pending gangs, settled chunks skipped, lazy rescue, the
  slab fill from shared prefix tables), reading one number per wave;
- ``solve_packing``: the exact sequential greedy (``gang_select_and_fill``
  per gang, its L+1 candidate fills stacked into one fill call).

Where the JAX package vmaps one gang's decision over the chunk, the port
writes the chunk axis C out as the leading dimension of every tensor: the
fill kernel's grid IS the chunk axis, and ``torch.func.vmap`` has no
batching rule for it.

The three static flags of the JAX package are ported: per-group pack
constraints (``grouped``: ``_fill_grouped``, each inner fill a P=1 call
of ``fill``), recovery pins (``pinned``: per-gang capacity views) and
topology spread constraints (``spread``: the balanced water-filling fill,
plain torch, computed beside the plain dispatch and selected per gang).

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
from grove_tpu_torch.ops.nodeaxis import WHOLE, NodeAxis

# narrow-cap sentinel of the lazy-rescue path: "retry with the cluster-wide
# fill only", distinct from -1 ("no broader level; done for good")
_CLUSTER_RETRY = -2


class GangInputs(NamedTuple):
    """One chunk of gangs, chunk axis first. The constraint fields stay None
    where a problem has no such constraint; ``solve_wave_chunk`` fills them
    with the JAX package's sentinels."""

    demand: torch.Tensor  # [C, P, R] f32
    count: torch.Tensor  # [C, P] i32
    min_count: torch.Tensor  # [C, P] i32
    req_level: torch.Tensor  # [C] i32
    pref_level: torch.Tensor  # [C] i32
    # demand-dedup PAIR index ([C, P] i32, None = dedup off): row of the
    # chunk's shared `cs_pair [U, N+1]` capped-fit prefix table for this
    # group's (demand, count) pair; row 0 is the all-zero pair
    uidx: Optional[torch.Tensor] = None
    # per-GROUP required pack level (-1 none): such a group must land inside
    # ONE domain at that level, chosen per group inside the gang's mask
    group_req: Optional[torch.Tensor] = None  # [C, P] i32
    # pinned domain id per group at its required level (-1 none): recovery
    # replacements rejoin the domain where the group's survivors live
    group_pin: Optional[torch.Tensor] = None  # [C, P] i32
    # pinned domain id of the WHOLE gang at req_level (-1 none)
    gang_pin: Optional[torch.Tensor] = None  # [C] i32
    # topology SPREAD: the level whose domains the gang's pods are balanced
    # across (-1 none), the distinct domains it must span (effective floor
    # min(spread_min, live pods)), hard (rejects) or soft (scores only)
    spread_level: Optional[torch.Tensor] = None  # [C] i32
    spread_min: Optional[torch.Tensor] = None  # [C] i32
    spread_required: Optional[torch.Tensor] = None  # [C] bool
    # recovery seed: SURVIVOR pods per spread-level domain; the zero-width
    # [C, 0] placeholder means "no seeds" (a static decision)
    spread_seed: Optional[torch.Tensor] = None  # [C, D] i32


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


def _fill_grouped(
    free, mask, demand, count, min_count, group_req, group_pin,
    topo, seg_starts, seg_ends, seed, fill, with_free_after=True, axis: NodeAxis = WHOLE,
):
    """Floors-first fill honoring per-GROUP pack constraints: a group with
    group_req >= 0 lands inside ONE domain at that level (chosen inside
    `mask`, or its recovery pin); other groups use `mask` itself. Floors of
    ALL groups place before any group's extras, and a constrained group's
    extras stay inside its own mask. Every fill is a P=1 call of `fill`:
    2P calls, free shared for the first and per gang after it.
    `seg_starts`/`seg_ends` are the padded ``[L, D]`` int64 tables.
    Returns (alloc [C,P,N], placed [C,P], placed_min [C,P], free_after)."""
    p_dim = demand.shape[1]
    floors = torch.minimum(min_count, count)
    extras = torch.clamp(count - min_count, min=0)
    h = _strided_hash(seed)
    topo_t = topo.t()

    def group_mask(free_c, p):
        """Group p's domain at its required level (inside mask), [C,N]."""
        k = _pods_fit_per_node(free_c, demand[:, p])  # [C, N]
        k = torch.minimum(torch.where(mask, k, 0), torch.clamp(floors[:, p : p + 1], min=1))
        cs = axis.table(k, -1)
        any_req = group_req[:, p] >= 0
        lvl = torch.where(any_req, group_req[:, p], 0).long()
        starts, ends = seg_starts[lvl], seg_ends[lvl]  # [C, D]
        at_starts, at_ends = axis.gather(cs, 1, (starts, ends))
        K = at_ends - at_starts  # pods fitting per domain
        feas = (K >= floors[:, p : p + 1]) & (ends > starts)
        # capacity-weighted strided pick; argmax of a bool needs a cast
        w = torch.where(feas, K, 0).to(torch.float32)
        cum_w = _seg_cumsum(w, -1)
        total_w = cum_w[:, -1]
        best = (cum_w > (h * total_w).unsqueeze(-1)).to(torch.int32).argmax(1)
        best = torch.where(total_w > 0, best, feas.to(torch.int32).argmax(1))
        ok_any = feas.any(1)
        # recovery pin: rejoin the survivors' domain unconditionally (the
        # fill decides whether the floor still fits there)
        pinned = group_pin[:, p] >= 0
        best = torch.where(pinned, group_pin[:, p].long(), best)
        ok_any = ok_any | pinned
        slab = topo_t[lvl] == best.unsqueeze(-1)
        return torch.where(
            any_req.unsqueeze(-1), slab & mask & ok_any.unsqueeze(-1), mask
        )

    free_c = free
    masks, allocs, floor_placed, extra_placed = [], [], [], []
    for p in range(p_dim):  # floors first
        mask_p = group_mask(free_c, p)
        masks.append(mask_p)
        a, pl, free_c = fill(
            free_c, mask_p, demand[:, p : p + 1].contiguous(),
            floors[:, p : p + 1].contiguous(),
        )
        allocs.append(a[:, 0])
        floor_placed.append(pl[:, 0])
    for p in range(p_dim):  # then extras, inside each group's own mask
        a, pl, free_c = fill(
            free_c, masks[p], demand[:, p : p + 1].contiguous(),
            extras[:, p : p + 1].contiguous(),
            with_free_after=with_free_after or p < p_dim - 1,
        )
        allocs[p] = allocs[p] + a[:, 0]
        extra_placed.append(pl[:, 0])
    placed_min = torch.stack(floor_placed, 1)
    placed = placed_min + torch.stack(extra_placed, 1)
    return torch.stack(allocs, 1), placed, placed_min, free_c


def _fill_dispatch(
    grouped, free, mask, gang: GangInputs, topo, seg_starts, seg_ends, seed,
    uniform, fill, with_free_after=True, axis: NodeAxis = WHOLE,
):
    """Static dispatch: problems with no group-level constraints take the
    two-phase fill; the grouped fill is only paid when used.
    Returns (alloc, placed, placed_min, free_after)."""
    if grouped:
        return _fill_grouped(
            free, mask, gang.demand, gang.count, gang.min_count,
            gang.group_req, gang.group_pin, topo, seg_starts, seg_ends, seed,
            fill, with_free_after, axis,
        )
    return _fill_floors_first(
        free, mask, gang.demand, gang.count, gang.min_count, uniform, fill,
        with_free_after,
    )


def _fill_slab_pair(free, sl_start, sl_end, gang: GangInputs, cs_pair, eff, fill, axis=WHOLE):
    """Uniform fill of each gang over its contiguous node slab
    ``[sl_start, sl_end)`` (``[C]`` int64) from the chunk's shared
    capped-fit prefix table ``cs_pair [U, N+1]``; ``eff [C,P]`` (int64)
    names each group's row.

    Group 0 fills against the shared snapshot ``free [N,R]``, so its
    per-node take is boundary arithmetic on its pair's prefix row: no
    division and no prefix sum (bit-exact: the row is the capped-fit
    prefix sum the generic fill computes). Groups 1..P-1 see free debited
    by group 0's take, per gang: one call of `fill` on ``[C,N,R]`` without
    ``free_after``, which nothing reads.

    Caller guarantees: uniform (floors == counts), no group constraints, no
    spread, no recovery pins, lazy rescue. Sharded (`axis`), ``free`` and
    the table rows are this rank's and the slab bounds global; a slab may
    straddle ranks. Returns (alloc [C,P,N], placed [C,P])."""
    p_dim = gang.count.shape[1]
    cs0 = cs_pair[eff[:, 0]]  # [C, N+1] row gather
    k0 = cs0[:, 1:] - cs0[:, :-1]  # capped per-node fits
    n_idx = axis.index(free.shape[0], free.device)
    in_slab = (n_idx >= sl_start.unsqueeze(-1)) & (n_idx < sl_end.unsqueeze(-1))
    cnt0 = gang.count[:, :1]
    at_start, at_end = axis.gather(cs0, 1, (sl_start.unsqueeze(-1), sl_end.unsqueeze(-1)))
    # exclusive prefix inside the slab; positions outside it are masked
    cumex = cs0[:, :-1] - at_start
    take0 = torch.where(in_slab, torch.minimum(torch.clamp(cnt0 - cumex, min=0), k0), 0)
    placed0 = torch.minimum(cnt0, at_end - at_start)
    if p_dim == 1:
        return take0.unsqueeze(1), placed0
    free1 = free - take0.unsqueeze(-1).to(free.dtype) * gang.demand[:, 0].unsqueeze(1)
    alloc_rest, placed_rest, _ = fill(
        free1, in_slab, gang.demand[:, 1:].contiguous(), gang.count[:, 1:].contiguous(),
        with_free_after=False,
    )
    return torch.cat([take0.unsqueeze(1), alloc_rest], 1), torch.cat([placed0, placed_rest], 1)


def _spread_defaults(c, device, spread_level, spread_min, spread_required, spread_seed):
    """Unset spread tensors get their sentinels (no constraint). The seed
    defaults to the zero-width [C, 0] placeholder, not [C, D]."""
    if spread_level is None:
        spread_level = torch.full((c,), -1, dtype=torch.int32, device=device)
    if spread_min is None:
        spread_min = torch.zeros((c,), dtype=torch.int32, device=device)
    if spread_required is None:
        spread_required = torch.zeros((c,), dtype=torch.bool, device=device)
    if spread_seed is None:
        spread_seed = torch.zeros((c, 0), dtype=torch.int32, device=device)
    return spread_level, spread_min, spread_required, spread_seed


def _seed_or_none(spread_seed):
    """The [.., 0] placeholder means "no seed" (a static shape check)."""
    if spread_seed is None or spread_seed.shape[-1] == 0:
        return None
    return spread_seed


def _water_level(K: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Per row, the smallest integer t in [0, 2*_INT_CAP] with
    sum(min(K, t)) >= cnt (2*_INT_CAP when there is none): the value the
    JAX package's 22-step bisection converges to, found exactly from the
    sorted K. f(t) = sum(min(K, t)) at the sorted breakpoints k_j is
    (sum of k_i, i < j) + (D - j) * k_j; the first breakpoint j that
    reaches cnt bounds t from above, and on that linear piece
    t = ceil((cnt - sum_{i<j} k_i) / (D - j)). int64 inside, int32 out."""
    d = K.shape[-1]
    ks = torch.sort(K, -1).values.long()
    below = torch.cumsum(ks, -1) - ks
    j = torch.arange(d, device=K.device)
    c64 = cnt.long().unsqueeze(-1)
    reach = (below + (d - j) * ks) >= c64
    first = reach.to(torch.int32).argmax(-1, keepdim=True)
    need = c64 - below.gather(-1, first)
    t = -torch.div(-need, d - first, rounding_mode="floor")  # ceil
    t = torch.clamp(t.squeeze(-1), 0, 2 * _INT_CAP)
    return torch.where(reach.any(-1), t, 2 * _INT_CAP).to(torch.int32)


def _spread_quota(K: torch.Tensor, cnt: torch.Tensor, load: torch.Tensor) -> torch.Tensor:
    """Balanced (water-filling) per-domain quota ``[C, D]``: q <= K,
    sum(q) = min(cnt, sum(K)), max(q) minimized. The overshoot of the water
    level t is shaved off the MOST-LOADED water-level domains (`load`: pods
    this gang already placed per domain), ties toward the highest index —
    ``jnp.lexsort((-arange(d), -load_eff))`` as two stable sorts."""
    d = K.shape[-1]
    t = _water_level(K, cnt).unsqueeze(-1)
    q0 = torch.minimum(K, t)
    excess = q0.sum(-1, dtype=torch.int32) - torch.minimum(
        cnt, K.sum(-1, dtype=torch.int32)
    )
    at_level = K >= t
    load_eff = torch.where(at_level, load, -1)
    # stable ascending sort of -load over the reversed domains = load
    # descending, then index descending
    order = torch.sort(-load_eff.flip(-1), dim=-1, stable=True).indices
    perm = (d - 1) - order
    # each domain's place in that order: the inverse permutation (an argsort
    # of a permutation has no ties, and vmap has a batching rule for it)
    rank = torch.argsort(perm, dim=-1)
    shave = at_level & (rank < excess.unsqueeze(-1))
    return q0 - shave.to(torch.int32)


def _fill_spread(free, mask, demand, count, topo_col, starts_l, ends_l, load0=None, axis=WHOLE):
    """Fill each group inside `mask`, BALANCING its pods across the domains
    of one level per gang (`topo_col [C,N]`, `starts_l`/`ends_l [C,D]`,
    int64): per-group water-filled quotas (load-aware, so the groups
    jointly span the most domains), then an in-domain exclusive prefix
    take against each domain's quota. Plain torch (an XLA program in the
    JAX package, not a Pallas kernel).
    Returns (alloc [C,P,N], placed [C,P], free_after [C,N,R], load [C,D])."""
    p_dim = count.shape[1]
    device = count.device
    if load0 is None:
        load0 = torch.zeros(starts_l.shape, dtype=torch.int32, device=device)
    free_c, load = free, load0
    allocs, placed = [], []
    for p in range(p_dim):
        demand_p = demand[:, p]
        k = _pods_fit_per_node(free_c, demand_p)
        k = torch.minimum(torch.where(mask, k, 0), count[:, p : p + 1])
        cs = axis.table(k, -1)
        at_starts, at_ends = axis.gather(cs, 1, (starts_l, ends_l))
        K = at_ends - at_starts  # [C, D]
        q = _spread_quota(K, count[:, p], load)
        # prefix inside n's domain: the table at the domain's first node
        in_dom = cs[:, :-1] - at_starts.gather(1, topo_col)
        take = torch.minimum(torch.clamp(q.gather(1, topo_col) - in_dom, min=0), k)
        free_c = free_c - take.unsqueeze(-1).to(free_c.dtype) * demand_p.unsqueeze(1)
        cs_t, total = axis.table(take, -1, total=True)
        t_starts, t_ends = axis.gather(cs_t, 1, (starts_l, ends_l))
        load = load + (t_ends - t_starts)
        allocs.append(take)
        placed.append(total)
    return torch.stack(allocs, 1), torch.stack(placed, 1), free_c, load


def _fill_spread_floors_first(
    free, mask, demand, count, min_count, topo_col, starts_l, ends_l, load0=None, axis=WHOLE
):
    """Floors-first two-phase spread fill plus the count of distinct domains
    the placement spans at the spread level (survivor domains of `load0`
    included). Returns (alloc, placed, placed_min, free_after, used [C])."""
    floors = torch.minimum(min_count, count)
    extras = torch.clamp(count - min_count, min=0)
    alloc_min, placed_min, free1, load1 = _fill_spread(
        free, mask, demand, floors, topo_col, starts_l, ends_l, load0, axis
    )
    alloc_ext, placed_ext, free2, load2 = _fill_spread(
        free1, mask, demand, extras, topo_col, starts_l, ends_l, load1, axis
    )
    used = (load2 > 0).sum(-1, dtype=torch.int32)
    return alloc_min + alloc_ext, placed_min + placed_ext, placed_min, free2, used


def _spread_select(gang: GangInputs, seg_starts, seg_ends, topo):
    """Per-gang spread-level views (level 0 where unset): (spread_on [C],
    topo_col [C,N], starts [C,D], ends [C,D]), indices int64."""
    sl = torch.clamp(gang.spread_level, min=0).long()
    return gang.spread_level >= 0, topo.t()[sl].long(), seg_starts[sl], seg_ends[sl]


def _dispatch_with_spread(
    spread, grouped, free, mask, gang: GangInputs, topo, seg_starts, seg_ends,
    seed, uniform, fill, with_free_after=True, axis: NodeAxis = WHOLE,
):
    """Fill dispatch for problems that may mix spread and non-spread gangs:
    with the static `spread` flag off, the plain dispatch alone; with it on,
    the spread fill as well, selected per gang.
    Returns (alloc, placed, placed_min, free_after, used, spread_on); used
    and spread_on are None with the flag off."""
    alloc, placed, placed_min, free_after = _fill_dispatch(
        grouped, free, mask, gang, topo, seg_starts, seg_ends, seed, uniform,
        fill, with_free_after, axis,
    )
    if not spread:
        return alloc, placed, placed_min, free_after, None, None
    spread_on, topo_col, starts_l, ends_l = _spread_select(gang, seg_starts, seg_ends, topo)
    a_s, p_s, pm_s, f_s, used = _fill_spread_floors_first(
        free, mask, gang.demand, gang.count, gang.min_count,
        topo_col, starts_l, ends_l, _seed_or_none(gang.spread_seed), axis,
    )
    on2, on3 = spread_on.unsqueeze(-1), spread_on[:, None, None]
    if with_free_after:
        free_after = torch.where(on3, f_s, free_after)
    return (
        torch.where(on3, a_s, alloc),
        torch.where(on2, p_s, placed),
        torch.where(on2, pm_s, placed_min),
        free_after,
        used,
        spread_on,
    )


def _live_total(gang: GangInputs, placed_total):
    """Pods of the LIVE gang: this solve's placements plus recovery
    survivors (the seed) — the spread target is judged against both."""
    seed = _seed_or_none(gang.spread_seed)
    if seed is None:
        return placed_total
    return placed_total + seed.sum(-1, dtype=torch.int32)


def _spread_floor(gang: GangInputs, placed_total):
    return torch.minimum(torch.clamp(gang.spread_min, min=1), _live_total(gang, placed_total))


def _spread_admit(gang: GangInputs, spread_on, used, placed_total):
    """Hard-spread admission: a required spread rejects placements spanning
    fewer than min(spread_min, live pods) distinct domains (`used` counts
    survivor domains through the seed load). True with the flag off."""
    if spread_on is None:
        return True
    eff = _spread_floor(gang, placed_total)
    return torch.where(spread_on & gang.spread_required, used >= eff, True)


def _spread_score(gang: GangInputs, spread_on, used, placed_total, coloc):
    """A spread gang's PlacementScore is its domain coverage toward the
    spread target (1.0 = met), replacing the co-location score."""
    if spread_on is None:
        return coloc
    eff = _spread_floor(gang, placed_total)
    cover = used.to(torch.float32) / torch.clamp(eff, min=1).to(torch.float32)
    return torch.where(spread_on, torch.clamp(cover, 0.0, 1.0), coloc)


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


def _gang_pin_mask(free: torch.Tensor, topo: torch.Tensor, gang: GangInputs, pinned: bool):
    """Node mask confining a pinned gang to its survivors' domain at
    req_level (all nodes when unpinned), and the capacity view with the
    nodes outside it zeroed, so the aggregate checks and the domain pick
    never look outside the pin. `pinned` is the problem's static flag:
    without it the mask is ``[N]`` and the view is the shared snapshot;
    with it they are per gang, ``[C,N]`` and ``[C,N,R]``."""
    if not pinned:
        return torch.ones(topo.shape[:1], dtype=torch.bool, device=free.device), free
    pin = gang.gang_pin
    if pin is None:
        pin = torch.full_like(gang.req_level, -1)
    pin_on = (pin >= 0) & (gang.req_level >= 0)
    rq = torch.clamp(gang.req_level, min=0).long()
    pin_mask = torch.where(pin_on.unsqueeze(-1), topo.t()[rq] == pin.unsqueeze(-1), True)
    free_vis = torch.where(pin_mask.unsqueeze(-1), free, 0.0)
    return pin_mask, free_vis


def _aggregate_tables(free: torch.Tensor, gang: GangInputs, cs_pair=None, axis: NodeAxis = WHOLE):
    """Shared prelude of the selector: capped per-node fit counts and their
    prefix sums ``cs_k [C,P,N+1]`` (None on the dedup path, where the level
    loop gathers from ``cs_pair`` instead), the free-capacity prefix
    ``cs_free`` with its float tolerance, and the admission floor's joint
    demand ``[C,R]``. `free` is one snapshot ``[N,R]`` for the whole chunk
    (``cs_free [N+1,R]``, ``free_tol [R]``) or a view per gang ``[C,N,R]``
    under recovery pins (``[C,N+1,R]``, ``[C,R]``). Sharded (`axis`), the
    tables hold this rank's entries (``NodeAxis.table``)."""
    active = gang.count > 0
    if cs_pair is not None and gang.uidx is not None:
        cs_k = None
    else:
        # free against demand [C,P,R] → [C,P,N]; cap per-node fits at the
        # group count (keeps the int32 prefix sums exact)
        k_all = _pods_fit_per_node(free.unsqueeze(1) if free.dim() == 3 else free, gang.demand)
        k_all = torch.minimum(k_all, gang.count.unsqueeze(-1))
        cs_k = axis.table(k_all, -1)
    min_demand = (gang.min_count.unsqueeze(-1).to(free.dtype) * gang.demand).sum(1)
    cs_free, free_total = axis.table(free, -2, total=True)
    # float32 prefix sums of byte-scale capacity accumulate rounding error;
    # slack the joint check so it can only false-KEEP (the fill is exact)
    free_tol = 1e-5 * free_total
    return active, cs_k, cs_free, free_tol, min_demand


def _level_bounds(seg_starts, seg_ends, seg_list):
    """Per-level (starts, ends) domain bounds: the ragged views, or the
    padded table's rows."""
    if seg_list is not None:
        return list(seg_list)
    return [(seg_starts[l], seg_ends[l]) for l in range(seg_starts.shape[0])]


def _coloc_score(alloc, placed_total, seg_starts, seg_ends, weights, ok, seg_list=None,
                 axis: NodeAxis = WHOLE):
    """Level-weighted dominant-domain co-location score per gang ``[C]``.
    `seg_list`: per-level ragged (starts, ends) views (the padded rows pad
    every level to the broadest level's domain count)."""
    pods_per_node = alloc.sum(1, dtype=torch.int32)  # [C, N]
    total = torch.clamp(placed_total.sum(1, dtype=torch.int32), min=1)
    cs_pods = axis.table(pods_per_node, -1)
    spans = axis.spans(cs_pods, 1, _level_bounds(seg_starts, seg_ends, seg_list))
    score = torch.zeros(alloc.shape[:1], dtype=torch.float32, device=alloc.device)
    for l, pods in enumerate(spans):
        dominant = pods.amax(1)
        score = score + weights[l] * (
            dominant.to(torch.float32) / total.to(torch.float32)
        )
    return torch.clamp(torch.where(ok, score, 0.0), 0.0, 1.0)


def gang_select_single(
    free, topo, seg_starts, seg_ends, gang: GangInputs, narrow_cap, seed,
    cs_pair=None, seg_list=None, grouped: bool = False, pinned: bool = False,
    spread: bool = False, uniform: bool = False, lazy_rescue: bool = False,
    fill=fill_batch, axis: NodeAxis = WHOLE,
):
    """Decide a chunk of gangs against one capacity snapshot ``free [N,R]``.

    Candidate levels are ranked by aggregate feasibility (prefix-sum
    boundary gathers); ONE fill is attempted at the best allowed level (or
    cluster-wide when none). Eager (the default): a second fill then either
    spills the best-effort extras cluster-wide or, when the level fill
    missed the floor and no broader feasible level remains, rescues the
    gang cluster-wide. `lazy_rescue` (uniform problems only: their extras
    spill is empty): no second fill; such a gang's fallback cap becomes
    ``_CLUSTER_RETRY`` and it takes the cluster-wide fill next wave. With
    the dedup table and no grouped, pinned or spread gang, the lazy path
    fills from slab bounds (``_fill_slab_pair``). A fill that misses the
    floor lowers `narrow_cap` for the next wave (fallback_cap). `grouped`,
    `pinned` and `spread` are the problem's static flags;
    `seg_starts`/`seg_ends` are the padded int64 tables (the grouped and
    spread fills index them per gang). Sharded (`axis`), ``free`` and
    ``topo`` are this rank's node slab and ``alloc`` this rank's columns;
    every other result is the same on every rank.

    Returns (alloc [C,P,N], placed [C,P], ok [C], chosen [C] (level index,
    n_levels for cluster-wide, -1 when nothing allowed), score [C],
    had_candidate [C], fallback_cap [C]).
    """
    n_nodes, n_levels = topo.shape
    c = gang.demand.shape[0]
    device = free.device
    weights = _level_weights(n_levels, device)
    fill = axis.fill(fill)

    pin_mask, free_vis = _gang_pin_mask(free, topo, gang, pinned)
    active, cs_k, cs_free, free_tol, min_demand = _aggregate_tables(
        free_vis, gang, cs_pair, axis
    )
    any_active = active.any(1)
    bounds = _level_bounds(seg_starts, seg_ends, seg_list)
    if cs_k is None:
        # dedup path: masked-out gangs (count zeroed by the pending filter)
        # read the reserved all-zero row 0
        eff = torch.where(active, gang.uidx, 0).long()
        k_spans = axis.row_spans(cs_pair, eff, bounds)  # [C, P, D]
    else:
        k_spans = axis.spans(cs_k, 2, bounds)
    free_spans = axis.spans(cs_free, cs_free.dim() - 2, bounds)  # [D,R] or [C,D,R]

    h = _strided_hash(seed)
    oks, bests = [], []
    for l in range(n_levels):
        starts, ends = bounds[l]
        K, free_agg = k_spans[l], free_spans[l]
        if free_agg.dim() == 2:
            free_agg = free_agg.unsqueeze(0)
        act = active.unsqueeze(-1)
        feas = torch.where(act, K >= gang.min_count.unsqueeze(-1), True).all(1)
        feas = feas & (free_agg >= (min_demand - free_tol).unsqueeze(1)).all(-1)
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
    if spread:
        # a spread gang gets ONE fill attempt per wave, at its required pack
        # level (else the broadest); with no required pack it goes straight
        # to the cluster-wide fill, which sees every spread-level domain
        s_on = gang.spread_level >= 0
        pref_eff = torch.where(s_on, torch.clamp(req, min=0), pref_eff)
        allowed = allowed & ~(s_on & (req < 0)).unsqueeze(-1)
    dist = (lv - pref_eff.unsqueeze(-1)).abs()
    level_rank = 2 * (n_levels - dist) + (lv > pref_eff.unsqueeze(-1)).long()
    has_level = allowed.any(1)
    chosen_level = torch.where(allowed, level_rank + 1, 0).argmax(1)  # [C]
    use_cluster = (~has_level) & (req < 0) & any_active
    had_candidate = has_level | use_cluster

    best_sel = bests.gather(1, chosen_level.unsqueeze(-1))  # [C, 1]
    # slab path: every fill mask is one contiguous node slab (the picked
    # domain, the whole cluster, or nothing), so the fill runs on its bounds
    # from the shared prefix tables; it never builds free_after, which only
    # the eager rescue reads
    use_slab_fill = (
        cs_k is None and uniform and lazy_rescue
        and not grouped and not spread and not pinned
    )
    if use_slab_fill:
        sl_start = torch.where(has_level, seg_starts[chosen_level, best_sel[:, 0]], 0)
        sl_end = torch.where(
            has_level,
            seg_ends[chosen_level, best_sel[:, 0]],
            torch.where(use_cluster, axis.global_n(n_nodes), 0),
        )
        alloc, placed = _fill_slab_pair(free, sl_start, sl_end, gang, cs_pair, eff, fill, axis)
        placed_min = placed  # uniform: floors ARE the counts
        used = spread_on = None
    else:
        packed_mask = (topo.t()[chosen_level] == best_sel) & pin_mask
        mask = torch.where(has_level.unsqueeze(-1), packed_mask, use_cluster.unsqueeze(-1))
        alloc, placed, placed_min, free_after, used, spread_on = _dispatch_with_spread(
            spread, grouped, free, mask.contiguous(), gang, topo, seg_starts, seg_ends,
            seed, uniform, fill, with_free_after=not lazy_rescue, axis=axis,
        )
    level_fill_ok = (
        had_candidate
        & any_active
        & torch.where(active, placed_min >= gang.min_count, True).all(1)
        & _spread_admit(gang, spread_on, used, placed.sum(1, dtype=torch.int32))
    )

    # when the level fill fails, the retry cap jumps straight to the next
    # BROADER level whose aggregates looked feasible (skip hopeless levels)
    lower_feasible = torch.where(allowed & (lv < chosen_level.unsqueeze(-1)), lv, -1)
    fallback_cap = lower_feasible.amax(1)
    no_req = req < 0
    if lazy_rescue:
        # uniform only: a level fill that met the floor placed every pod, so
        # there is nothing to spill; a gang that needs the cluster rescue
        # defers it to the next (compacted) wave through the sentinel cap,
        # where it finds no allowed level and takes the cluster-wide fill
        defer = has_level & ~level_fill_ok & no_req & (fallback_cap < 0) & any_active
        fallback_cap = torch.where(defer, _CLUSTER_RETRY, fallback_cap)
        fill_ok = level_fill_ok
    else:
        # Second fill doubles as both paths:
        # - level fill met the floor → best-effort extras spill cluster-wide
        #   (spread gangs never spill: the balanced fill placed all they get)
        # - level fill missed the floor AND no broader feasible level remains
        #   (and no required pack) → cluster-wide scatter as a last resort
        #   (never a spread gang: without a required pack it takes no level, so
        #   this pass's spread fill reaches no result; it runs for the flag)
        cluster_rescue = has_level & ~level_fill_ok & no_req & (fallback_cap < 0) & any_active
        spill = level_fill_ok & has_level & no_req
        if spread_on is not None:
            spill = spill & ~spread_on
        base_free = torch.where(cluster_rescue[:, None, None], free, free_after)
        # extras of a group-constrained group stay inside its chosen domain:
        # only unconstrained groups spill
        spill_p = spill.unsqueeze(-1)
        if gang.group_req is not None:
            spill_p = spill_p & (gang.group_req < 0)
        remaining = torch.where(
            cluster_rescue.unsqueeze(-1),
            gang.count,
            torch.where(spill_p, gang.count - placed, 0),
        )
        rescue_min = torch.where(cluster_rescue.unsqueeze(-1), gang.min_count, 0)
        # the capacity this fill leaves is not used: it is not written
        all_nodes = torch.ones((c, n_nodes), dtype=torch.bool, device=device)
        alloc2, placed2, placed2_min, _, used2, _ = _dispatch_with_spread(
            spread, grouped, base_free.contiguous(), all_nodes,
            gang._replace(count=remaining, min_count=rescue_min), topo, seg_starts,
            seg_ends, seed, uniform, fill, with_free_after=False, axis=axis,
        )
        rescue_ok = (
            cluster_rescue
            & torch.where(active, placed2_min >= gang.min_count, True).all(1)
            & _spread_admit(gang, spread_on, used2, placed2.sum(1, dtype=torch.int32))
        )
        r3, s3 = rescue_ok[:, None, None], spill[:, None, None]
        alloc = torch.where(r3, alloc2, torch.where(s3, alloc + alloc2, alloc))
        r2, s2 = rescue_ok.unsqueeze(-1), spill.unsqueeze(-1)
        placed = torch.where(r2, placed2, torch.where(s2, placed + placed2, placed))
        if spread_on is not None:
            used = torch.where(rescue_ok, used2, used)
        fill_ok = level_fill_ok | rescue_ok
        chosen_level = torch.where(rescue_ok, n_levels, chosen_level)
        has_level = has_level & ~rescue_ok
        use_cluster = use_cluster | rescue_ok

    # epilogue (lazy and eager): mask out failed fills, score, pick the
    # reported level
    alloc = torch.where(fill_ok[:, None, None], alloc, 0)
    placed = torch.where(fill_ok.unsqueeze(-1), placed, 0)
    score = _coloc_score(alloc, placed, seg_starts, seg_ends, weights, fill_ok, seg_list, axis)
    score = torch.where(
        fill_ok,
        _spread_score(gang, spread_on, used, placed.sum(1, dtype=torch.int32), score),
        0.0,
    )
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
    grq=None, gpin=None, gangpin=None, spreadlvl=None, spreadmin=None,
    spreadreq=None, spreadseed=None,
    grouped=False, pinned=False, spread=False,
    pair_dem=None, pair_cap=None, uidx=None, uniform=False, seg_list=None,
    fill=fill_batch, lazy_rescue=False, axis: NodeAxis = WHOLE,
):
    """Decide one chunk of gangs in parallel against one capacity snapshot,
    commit by iterative prefix-acceptance with a final joint-feasibility
    guarantee, and produce the retry/narrow-cap bookkeeping for the next
    wave.

    `pair_dem [U,R]` + `pair_cap [U]` + `uidx [C,P]` (optional demand
    dedup): the capped-fit prefix sums are computed once per UNIQUE
    (demand, count) pair; each gang's level loop gathers the SAME integer
    values (bit-exact). Off under `pinned` (each gang sees its own
    capacity view there).
    `lazy_rescue` (uniform problems only) defers cluster rescues to the
    next wave (``gang_select_single``); a deferred gang always retries.
    `axis`: the node axis (``ops.nodeaxis``); sharded, ``free``,
    ``topo``, the returned free and alloc are this rank's node slab.
    Returns (free, accept, placed, score, chosen, retry, new_cap,
    fill_failed, alloc)."""
    if lazy_rescue and not uniform:
        raise ValueError(
            "lazy_rescue requires a uniform problem: only then is the extras"
            " spill provably empty"
        )
    cnt = cnt * pend.unsqueeze(-1)
    use_dedup = pair_dem is not None and uidx is not None and not pinned
    cs_pair = None
    if use_dedup:
        fit_pair = torch.minimum(
            _pods_fit_per_node(free, pair_dem), pair_cap.unsqueeze(-1)
        )  # [U, N]
        cs_pair = axis.table(fit_pair, -1)  # [U, N+1]
    gang = GangInputs(
        dem, cnt, mn, rq, pf, uidx if use_dedup else None,
        grq, gpin, gangpin, spreadlvl, spreadmin, spreadreq, spreadseed,
    )
    alloc, placed, ok, chosen, score, had_cand, fallback_cap = gang_select_single(
        free, topo, seg_starts, seg_ends, gang, ncap, seeds, cs_pair, seg_list,
        grouped=grouped, pinned=pinned, spread=spread, uniform=uniform,
        lazy_rescue=lazy_rescue, fill=fill, axis=axis,
    )

    # integer-valued products: exact in float32 (TF32 must be off on CUDA)
    usage = torch.einsum("cpn,cpr->cnr", alloc.to(free.dtype), dem)  # [C,N,R]
    limit = free.unsqueeze(0) + 1e-6

    def prefix_fits(acc):
        cum = _seg_cumsum(torch.where(acc[:, None, None], usage, 0.0), 0)
        return axis.all((cum <= limit).flatten(1).all(1))

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
    if lazy_rescue:
        retry = retry | (pend & fill_failed & (new_cap == _CLUSTER_RETRY))
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


def _constraint_defaults(
    count, group_req, group_pin, gang_pin,
    spread_level, spread_min, spread_required, spread_seed,
):
    """The constraint arrays of ``count``'s gangs, with the JAX package's
    sentinels (no constraint) where one is None."""
    c, device = count.shape[0], count.device
    if group_req is None:
        group_req = torch.full(count.shape, -1, dtype=torch.int32, device=device)
    if group_pin is None:
        group_pin = torch.full(count.shape, -1, dtype=torch.int32, device=device)
    if gang_pin is None:
        gang_pin = torch.full((c,), -1, dtype=torch.int32, device=device)
    return (group_req, group_pin, gang_pin) + _spread_defaults(
        c, device, spread_level, spread_min, spread_required, spread_seed
    )


def _seg_views(seg_starts, seg_ends, level_widths):
    """Per-level ragged (starts, ends) views of the padded tables, or None."""
    if level_widths is None:
        return None
    return tuple((seg_starts[l, :w], seg_ends[l, :w]) for l, w in enumerate(level_widths))


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
    group_req=None,  # [C, P] i32
    group_pin=None,  # [C, P] i32
    gang_pin=None,  # [C] i32
    spread_level=None,  # [C] i32
    spread_min=None,  # [C] i32
    spread_required=None,  # [C] bool
    spread_seed=None,  # [C, D] i32 (or the [C, 0] placeholder)
    pair_demand=None,  # [U, R] f32
    pair_count=None,  # [U] i32
    pair_idx=None,  # [C, P] i32
    commit_iters: int = 2,
    grouped: bool = False,
    pinned: bool = False,
    spread: bool = False,
    uniform: bool = False,
    level_widths: tuple = None,
    fill=fill_batch,
):
    """One wave over one chunk, with per-pod allocations (the binding path).
    Absent constraint arrays get the JAX package's sentinels (no
    constraint); `grouped`, `pinned` and `spread` are the problem's static
    flags. `level_widths`: per-level real domain counts for the ragged
    candidate scan. `fill`: the fill implementation — the kernel wrapper by
    default; tests pass ``fill_batch_ref`` to hold the kernel against its
    plain version inside the path. Returns a dict of the chunk's results."""
    seg_starts = seg_starts.long()
    seg_ends = seg_ends.long()
    seg_list = _seg_views(seg_starts, seg_ends, level_widths)
    (
        group_req, group_pin, gang_pin,
        spread_level, spread_min, spread_required, spread_seed,
    ) = _constraint_defaults(
        count, group_req, group_pin, gang_pin,
        spread_level, spread_min, spread_required, spread_seed,
    )
    free_after, accept, placed, score, chosen, retry, new_cap, _, alloc = (
        wave_chunk_core(
            free, topo, seg_starts, seg_ends,
            demand, count, min_count, req_level, pref_level,
            pending, narrow_cap, seeds, commit_iters,
            group_req, group_pin, gang_pin,
            spread_level, spread_min, spread_required, spread_seed,
            grouped, pinned, spread,
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


def solve_wave_chunk_stack(
    free,  # [B, N, R] f32 — one capacity snapshot per stacked subproblem
    topo,  # [B, N, L] i32
    seg_starts,  # [B, L, D] i32
    seg_ends,  # [B, L, D] i32
    demand,  # [B, C, P, R] f32 — one CHUNK of gangs per subproblem lane
    count,  # [B, C, P] i32
    min_count,  # [B, C, P] i32
    req_level,  # [B, C] i32
    pref_level,  # [B, C] i32
    pending,  # [B, C] bool
    narrow_cap,  # [B, C] i32
    seeds,  # [B, C] i32
    group_req,  # [B, C, P] i32
    group_pin,  # [B, C, P] i32
    gang_pin,  # [B, C] i32
    spread_level,  # [B, C] i32
    spread_min,  # [B, C] i32
    spread_required,  # [B, C] bool
    spread_seed,  # [B, C, D] i32 (or the [B, C, 0] placeholder)
    commit_iters: int = 2,
    grouped: bool = False,
    pinned: bool = False,
    spread: bool = False,
    uniform: bool = False,
    fill=fill_batch,
):
    """One wave over one chunk of every stacked subproblem lane at once: the
    partitioned frontier's batched dispatch (``solver/frontier.py``).

    Node-disjoint subproblems padded to one shape are stacked on a leading
    lane axis and decided by ``torch.func.vmap`` of the same
    :func:`wave_chunk_core` the binding path runs per problem (without the
    demand dedup and the ragged ``level_widths``, as the JAX package calls
    it). Each lane carries its own capacity, topology slabs and narrow caps,
    so lanes never read each other's rows. The fill's vmap rule folds the
    lanes into its gang axis: one kernel launch per fill serves every lane.
    Inert padding lanes (zero capacity and counts, pending False) leave
    their free untouched.

    Static flags are the OR over the stack (``uniform``: the AND); a lane
    without groups, pins or spread takes the same values through the
    flagged code. Returns (free_after [B,N,R], accept [B,C], retry [B,C],
    new_cap [B,C], placed [B,C,P], score [B,C], chosen_level [B,C],
    alloc [B,C,P,N]), the last four masked by accept as
    :func:`solve_wave_chunk` masks them."""
    n_levels = topo.shape[2]

    def lane(free_b, topo_b, ss_b, se_b, dem_b, cnt_b, mn_b, rq_b, pf_b, pend_b, ncap_b,
             seed_b, grq_b, gpin_b, gangpin_b, slvl_b, smin_b, sreq_b, sseed_b):
        free_after, accept, placed, score, chosen, retry, new_cap, _, alloc = wave_chunk_core(
            free_b, topo_b, ss_b, se_b, dem_b, cnt_b, mn_b, rq_b, pf_b, pend_b, ncap_b,
            seed_b, commit_iters, grq_b, gpin_b, gangpin_b, slvl_b, smin_b, sreq_b, sseed_b,
            grouped, pinned, spread, uniform=uniform, fill=fill,
        )
        # the post-processing of solve_wave_chunk, so that a stacked lane
        # and the per-problem path cannot diverge
        return (
            free_after,
            accept,
            retry,
            new_cap,
            torch.where(accept.unsqueeze(-1), placed, 0),
            torch.where(accept, score, 0.0),
            torch.where(accept, torch.where(chosen >= n_levels, -1, chosen), -1).to(torch.int32),
            torch.where(accept[:, None, None], alloc, 0),
        )

    return torch.func.vmap(lane)(
        free, topo, seg_starts.long(), seg_ends.long(), demand, count, min_count,
        req_level, pref_level, pending, narrow_cap, seeds, group_req, group_pin, gang_pin,
        spread_level, spread_min, spread_required, spread_seed,
    )


def _host_int(t: torch.Tensor) -> int:
    """The stats path's one device→host read per wave: a count."""
    return int(t)


def solve_waves_device(
    capacity,  # [N, R] f32
    topo,  # [N, L] i32
    seg_starts,  # [L, D] i32
    seg_ends,  # [L, D] i32
    demand,  # [G, P, R] f32, G divisible by n_chunks
    count,  # [G, P] i32
    min_count,  # [G, P] i32
    req_level,  # [G] i32
    pref_level,  # [G] i32
    group_req=None,  # [G, P] i32
    group_pin=None,  # [G, P] i32
    gang_pin=None,  # [G] i32
    spread_level=None,  # [G] i32
    spread_min=None,  # [G] i32
    spread_required=None,  # [G] bool
    spread_seed=None,  # [G, D] i32 (or the [G, 0] placeholder)
    pair_demand=None,  # [U, R] f32, demand dedup (solver.dedup)
    pair_count=None,  # [U] i32
    pair_idx=None,  # [G, P] i32
    n_chunks: int = 20,
    max_waves: int = 8,
    commit_iters: int = 0,
    grouped: bool = False,
    pinned: bool = False,
    spread: bool = False,
    uniform: bool = False,
    lazy_rescue: bool = False,
    level_widths: tuple = None,
    fill=fill_batch,
    axis: NodeAxis = WHOLE,
):
    """The whole multi-wave wave-parallel solve of the stats path, with one
    device→host read per wave (the count of pending gangs, ``_host_int``)
    and one more for the lazy-rescue epilogue; nothing is read inside a
    chunk.

    Per wave: pending gangs are compacted to the front (stable, so their
    order holds; each keeps its seed ``index + wave*7919``), and the chunks
    that hold one, exactly the first ceil(pending / C), are decided and
    committed in turn against the running capacity (``wave_chunk_core``,
    `commit_iters` refinement passes). The JAX program skips the other,
    settled chunks with a ``lax.cond``: they leave capacity and narrow caps
    unchanged and report nothing, which is what their rows get here. Gangs
    that lost a commit race or walk their narrow cap retry next wave. With
    `lazy_rescue`, a gang that deferred its cluster rescue on the last wave
    gets it in one more pass over exactly those gangs.

    `axis` shards the node axis (``parallel.sharded.solve_stress_sharded``):
    ``capacity``, ``topo`` and ``free_after`` are then this rank's node
    slab, everything else is replicated, and the wave loop reads only
    replicated counts, so every rank takes the same branches and calls the
    same collectives.

    Returns a dict: admitted [G], placed [G,P], score [G], chosen_level [G]
    (-1 cluster-wide or none), free_after [N,R], waves (int), pending [G]
    (still pending, or a fill ever missed and the gang was not admitted:
    the exact tail's candidates)."""
    g_total, p_max, _ = demand.shape
    n_levels = topo.shape[1]
    device = demand.device
    (
        group_req, group_pin, gang_pin,
        spread_level, spread_min, spread_required, spread_seed,
    ) = _constraint_defaults(
        count, group_req, group_pin, gang_pin,
        spread_level, spread_min, spread_required, spread_seed,
    )
    use_dedup = (
        pair_demand is not None and pair_count is not None
        and pair_idx is not None and not pinned
    )
    c = g_total // n_chunks
    seg_starts = seg_starts.long()
    seg_ends = seg_ends.long()
    seg_list = _seg_views(seg_starts, seg_ends, level_widths)
    per_gang = (
        demand, count, min_count, req_level, pref_level, group_req, group_pin,
        gang_pin, spread_level, spread_min, spread_required, spread_seed,
    ) + ((pair_idx,) if use_dedup else ())
    state = {
        "free": capacity,
        "pending": torch.ones((g_total,), dtype=torch.bool, device=device),
        "narrow_cap": torch.full((g_total,), n_levels - 1, dtype=torch.int32, device=device),
        "admitted": torch.zeros((g_total,), dtype=torch.bool, device=device),
        "placed": torch.zeros((g_total, p_max), dtype=torch.int32, device=device),
        "score": torch.zeros((g_total,), dtype=torch.float32, device=device),
        "chosen": torch.full((g_total,), -1, dtype=torch.int32, device=device),
        "rescue": torch.zeros((g_total,), dtype=torch.bool, device=device),
    }

    def wave_body(state, pending, n_pending, wave):
        # compaction: the stable sort keeps pending gangs in their order
        order = torch.argsort((~pending).to(torch.uint8), stable=True)
        rows = order[: -(-n_pending // c) * c]  # the chunks holding a pending gang
        seeds = torch.arange(g_total, dtype=torch.int32, device=device) + wave * 7919
        xs = [a.index_select(0, rows) for a in per_gang]
        pend = pending.index_select(0, rows)
        ncap = state["narrow_cap"].index_select(0, rows)
        seeds = seeds.index_select(0, rows)
        free = state["free"]
        ys = []
        for k in range(rows.shape[0] // c):
            sl = slice(k * c, (k + 1) * c)
            (
                dem, cnt, mn, rq, pf, grq, gpin, gangpin, slvl, smin, sreq, sseed,
                *uidx,
            ) = (x[sl] for x in xs)
            free, accept, placed, score, chosen, retry, new_cap, fill_failed, _ = (
                wave_chunk_core(
                    free, topo, seg_starts, seg_ends,
                    dem, cnt, mn, rq, pf, pend[sl], ncap[sl], seeds[sl], commit_iters,
                    grq, gpin, gangpin, slvl, smin, sreq, sseed,
                    grouped, pinned, spread,
                    pair_dem=pair_demand if use_dedup else None,
                    pair_cap=pair_count if use_dedup else None,
                    uidx=uidx[0] if use_dedup else None,
                    uniform=uniform, seg_list=seg_list, fill=fill,
                    lazy_rescue=lazy_rescue, axis=axis,
                )
            )
            ys.append((accept, placed, score, chosen, retry, new_cap, fill_failed))
        accept, placed, score, chosen, retry, new_cap, fill_failed = (
            torch.cat(y) for y in zip(*ys)
        )

        def settled(like):
            """All rows zero, the active rows set: settled chunks report no
            accept, retry or fill failure."""
            return torch.zeros((g_total,) + like.shape[1:], dtype=like.dtype, device=device)

        accept = settled(accept).index_copy_(0, rows, accept)
        retry = settled(retry).index_copy_(0, rows, retry)
        fill_failed = settled(fill_failed).index_copy_(0, rows, fill_failed)
        # only accepted rows are merged: the others' values are never read
        placed = settled(placed).index_copy_(0, rows, placed)
        score = settled(score).index_copy_(0, rows, score)
        chosen = settled(chosen).index_copy_(0, rows, chosen)
        return {
            "free": free,
            "pending": retry,
            "narrow_cap": state["narrow_cap"].index_copy(0, rows, new_cap),
            "admitted": state["admitted"] | accept,
            "placed": torch.where(accept.unsqueeze(-1), placed, state["placed"]),
            "score": torch.where(accept, score, state["score"]),
            "chosen": torch.where(accept, chosen, state["chosen"]),
            # a gang whose single fill ever missed the floor is an exact-tail
            # candidate (its seed-picked domain may have been the wrong one)
            "rescue": state["rescue"] | fill_failed,
        }

    # After the first wave the JAX loop's condition, progress & any(pending),
    # is any(retry): the pending count read after each wave decides it.
    wave, n_pending = 0, g_total
    while wave < max_waves and n_pending:
        state = wave_body(state, state["pending"], n_pending, wave)
        wave += 1
        n_pending = _host_int(state["pending"].sum())
    if lazy_rescue:
        # a gang that deferred its cluster rescue on the last wave is still
        # pending with the sentinel cap: one more pass over exactly those
        # gangs gives it the cluster-wide fill the eager path makes in-wave
        # (other pending gangs are left out: another level attempt would
        # admit more than the eager path within the same budget)
        deferred = state["pending"] & (state["narrow_cap"] == _CLUSTER_RETRY)
        n_deferred = _host_int(deferred.sum())
        if n_deferred:
            rest = state["pending"] & ~deferred
            state = wave_body(state, deferred, n_deferred, wave)
            state["pending"] = state["pending"] | rest
            wave += 1
    chosen = state["chosen"]
    return {
        "admitted": state["admitted"],
        "placed": state["placed"],
        "score": state["score"],
        "chosen_level": torch.where(chosen >= n_levels, -1, chosen),
        "free_after": state["free"],
        "waves": wave,
        "pending": state["pending"] | (state["rescue"] & ~state["admitted"]),
    }


def _one_hot_sum(one_hot, cands):
    """``sum(one_hot[i] * cands[i] for i)`` as XLA computes the JAX
    package's expression: a chain of adds from the first term (XLA drops
    Python's leading 0), so a zero comes out -0.0 where every term is
    -0.0. A reduction, which starts from +0.0, would give +0.0 there."""
    terms = one_hot.view((-1,) + (1,) * (cands.dim() - 1)) * cands
    acc = terms[0]
    for term in terms[1:]:
        acc = acc + term
    return acc


def gang_select_and_fill(
    free, topo, seg_starts, seg_ends, gang: GangInputs, grouped=False,
    pinned=False, spread=False, uniform=False, seg_list=None, fill=fill_batch,
    axis: NodeAxis = WHOLE,
):
    """One gang's placement decision against ``free [N,R]`` (the exact
    sequential kernel's step). `gang` holds one gang (C=1).

    Per level, the best-fit feasible domain (least spare fit count, ties to
    the least free capacity); then the fill at every level's domain and
    cluster-wide, the L+1 candidates stacked as the rows of ONE dispatch
    (they all start from `free`); the preferred level among the candidates
    whose fill truly meets the floor wins; best-effort extras spill
    cluster-wide (one more fill, C=1). All-or-nothing: `free` comes back
    unchanged when no candidate admits. Branch-free: nothing is read on the
    host. `seg_starts`/`seg_ends` are the padded int64 tables.

    Returns (free_new [N,R], alloc [1,P,N], placed [1,P], ok [1],
    chosen_level [1] (-1 cluster-wide or none), score [1])."""
    n_nodes, n_levels = topo.shape
    device = free.device
    weights = _level_weights(n_levels, device)
    fill = axis.fill(fill)

    pin_mask, free_vis = _gang_pin_mask(free, topo, gang, pinned)
    active, cs_k, cs_free, free_tol, min_demand = _aggregate_tables(free_vis, gang, axis=axis)
    any_active = active.any(1)  # [1]
    act = active.unsqueeze(-1)  # [1, P, 1]
    bounds = _level_bounds(seg_starts, seg_ends, seg_list)
    k_spans = axis.spans(cs_k, 2, bounds)  # [1, P, D]
    free_spans = axis.spans(cs_free, cs_free.dim() - 2, bounds)  # [D,R] or [1,D,R]
    level_ok, masks = [], []
    for l in range(n_levels):
        starts, ends = bounds[l]
        K, free_agg = k_spans[l], free_spans[l]
        if free_agg.dim() == 2:
            free_agg = free_agg.unsqueeze(0)
        feas = torch.where(act, K >= gang.min_count.unsqueeze(-1), True).all(1)
        feas = feas & (free_agg >= (min_demand - free_tol).unsqueeze(1)).all(-1)
        feas = feas & (ends > starts) & any_active.unsqueeze(-1)  # [1, D]
        # best fit: least leftover fit count (K is capped at the count, so
        # full fits tie at 0), then the domain with the least free capacity
        spare = torch.where(act, K - gang.count.unsqueeze(-1), 0).sum(1, dtype=torch.int32)
        free_total = free_agg.sum(-1)  # [1, D]
        tie = free_total / (free_total.amax(-1, keepdim=True) + 1.0)
        key = spare.to(torch.float32) + tie
        best = torch.where(feas, key, torch.inf).argmin(1)  # [1]
        ok_l = feas.any(1)
        level_ok.append(ok_l)
        masks.append(ok_l.unsqueeze(-1) & (topo[:, l] == best.unsqueeze(-1)) & pin_mask)
    masks.append(torch.ones((1, n_nodes), dtype=torch.bool, device=device))

    # the L+1 candidate fills in one dispatch: row i is the gang's fill
    # inside masks[i], every row from the same free
    n_cand = n_levels + 1
    rep = GangInputs(*(
        None if t is None else t.expand((n_cand,) + t.shape[1:]) for t in gang
    ))
    rep = rep._replace(demand=rep.demand.contiguous())
    alloc_c, placed_c, placed_min_c, free_c, used_c, spread_on = _dispatch_with_spread(
        spread, grouped, free, torch.cat(masks), rep, topo, seg_starts, seg_ends,
        torch.zeros((n_cand,), dtype=torch.int32, device=device), uniform, fill, axis=axis,
    )
    lv = torch.arange(n_levels, device=device)
    req = gang.req_level  # [1]
    min_allowed = torch.where(req >= 0, req, 0)
    allowed = torch.cat([
        torch.cat(level_ok) & (lv >= min_allowed),
        (req < 0) & any_active,  # cluster-wide only without a required pack
    ])
    oks = (
        allowed
        & torch.where(active, placed_min_c >= gang.min_count, True).all(1)
        & _spread_admit(rep, spread_on, used_c, placed_c.sum(1, dtype=torch.int32))
    )  # [L+1]

    # preference: the preferred level first, then the closest levels
    # (narrower wins ties), cluster-wide last — except a spread gang, which
    # prefers its broadest allowed mask, and with no required pack ranks
    # cluster-wide above every level (a level candidate is one domain)
    pref_eff = torch.where(gang.pref_level >= 0, gang.pref_level, n_levels - 1)
    cluster_rank = torch.zeros((1,), dtype=torch.long, device=device)
    if spread:
        spread_on = spread_on[:1]
        pref_eff = torch.where(spread_on, torch.clamp(req, min=0), pref_eff)
        cluster_rank = torch.where(spread_on & (req < 0), 2 * (n_levels + 1), cluster_rank)
    level_rank = 2 * (n_levels - (lv - pref_eff).abs()) + (lv > pref_eff).long()
    pref_rank = torch.cat([level_rank, cluster_rank])
    chosen = torch.where(oks, pref_rank + 1, 0).argmax()  # 0-d
    ok_min = oks.any().unsqueeze(0)  # [1]

    # the JAX package takes the chosen candidate by one-hot weighted sums in
    # float32; for the counts that is the chosen row through float32 (every
    # other term is a zero), for the capacity the sum's signed zeros matter
    pick = chosen.unsqueeze(0)
    alloc = alloc_c.to(free.dtype)[pick].to(torch.int32)
    placed = placed_c.to(free.dtype)[pick].to(torch.int32)
    used = None if used_c is None else used_c.to(free.dtype)[pick].to(torch.int32)
    one_hot = (torch.arange(n_cand, device=device) == chosen).to(free.dtype)
    free_after = _one_hot_sum(one_hot, free_c)

    # best-effort extras spill cluster-wide: no required pack, never from a
    # group-constrained group, never for a spread gang
    spill = (req < 0) & ok_min & (chosen < n_levels)
    if spread:
        spill = spill & ~spread_on
    remaining = torch.where(spill.unsqueeze(-1) & (gang.group_req < 0), gang.count - placed, 0)
    alloc2, placed2, free_after2 = fill(free_after, masks[-1], gang.demand, remaining)
    s2 = spill.unsqueeze(-1)
    alloc = torch.where(s2.unsqueeze(-1), alloc + alloc2, alloc)
    placed = torch.where(s2, placed + placed2, placed)
    free_final = torch.where(spill[:, None, None], free_after2, free_after)[0]

    # all-or-nothing: capacity unchanged unless admitted
    free_new = torch.where(ok_min.unsqueeze(-1), free_final, free)
    alloc = torch.where(ok_min[:, None, None], alloc, 0)
    placed = torch.where(ok_min.unsqueeze(-1), placed, 0)
    chosen_l = torch.where(ok_min & (chosen < n_levels), chosen, -1).to(torch.int32)
    score = _coloc_score(alloc, placed, seg_starts, seg_ends, weights, ok_min, seg_list, axis)
    score = torch.where(
        ok_min,
        _spread_score(gang, spread_on, used, placed.sum(1, dtype=torch.int32), score),
        0.0,
    )
    return free_new, alloc, placed, ok_min, chosen_l, score


def solve_packing(
    capacity,  # [N, R] f32
    topo,  # [N, L] i32
    seg_starts,  # [L, D] i32
    seg_ends,  # [L, D] i32
    demand,  # [G, P, R] f32
    count,  # [G, P] i32
    min_count,  # [G, P] i32
    req_level,  # [G] i32 (-1 none)
    pref_level,  # [G] i32 (-1 → narrowest)
    group_req=None,  # [G, P] i32 (-1 none)
    group_pin=None,  # [G, P] i32 (-1 none)
    gang_pin=None,  # [G] i32 (-1 none)
    spread_level=None,  # [G] i32 (-1 none)
    spread_min=None,  # [G] i32
    spread_required=None,  # [G] bool
    spread_seed=None,  # [G, D] i32 (or the [G, 0] placeholder)
    with_alloc: bool = True,
    grouped: bool = False,
    pinned: bool = False,
    spread: bool = False,
    uniform: bool = False,
    level_widths: tuple = None,
    fill=fill_batch,
    axis: NodeAxis = WHOLE,
):
    """The exact sequential greedy: ``gang_select_and_fill`` for each gang
    in order against the capacity the earlier gangs left. A host loop over
    the gangs that reads nothing from the device. `axis` shards the node
    axis as in :func:`solve_waves_device` (``capacity``, ``topo``, ``alloc``
    and ``free_after`` are then this rank's). Returns a dict: admitted
    [G], placed [G,P], score [G], chosen_level [G], alloc [G,P,N] (None
    without `with_alloc`), free_after [N,R]."""
    seg_starts = seg_starts.long()
    seg_ends = seg_ends.long()
    seg_list = _seg_views(seg_starts, seg_ends, level_widths)
    gangs = GangInputs(
        demand, count, min_count, req_level, pref_level, None,
        *_constraint_defaults(
            count, group_req, group_pin, gang_pin,
            spread_level, spread_min, spread_required, spread_seed,
        ),
    )
    free = capacity
    ys = []
    for g in range(demand.shape[0]):
        gang = GangInputs(*(None if t is None else t[g : g + 1] for t in gangs))
        free, alloc, placed, ok, chosen_l, score = gang_select_and_fill(
            free, topo, seg_starts, seg_ends, gang, grouped=grouped, pinned=pinned,
            spread=spread, uniform=uniform, seg_list=seg_list, fill=fill, axis=axis,
        )
        ys.append((ok, placed, score, chosen_l) + ((alloc,) if with_alloc else ()))
    cols = [torch.cat(y) for y in zip(*ys)]
    return {
        "admitted": cols[0],
        "placed": cols[1],
        "score": cols[2],
        "chosen_level": cols[3],
        "alloc": cols[4] if with_alloc else None,
        "free_after": free,
    }
