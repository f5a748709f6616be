"""The exact kernel's order of work, and its wrapper, on the CPU.

``csrc/exact.cu`` cannot run here. It departs from the plain version's
order of work (``ops.packing.solve_packing``'s host loop), so that order is
written below as ``kernel_model``, a numpy model used only by tests, and
held against the JAX package's ``solve_packing`` on every case of
``tests/exact_scan_cases.py``:

- a level is scanned only when its candidate is reached, and the
  candidates are filled in the order of their preference rank, the first
  one whose fill meets every floor wins (the ranks are distinct, so it is
  the argmax's pick); a candidate that is not allowed is never filled;
- the capacity left is the winner's: XLA's one-hot sum of the L+1
  candidates' capacities equals it bit for bit, because a −0.0 of free is
  −0.0 in every candidate (no fill takes there) and a fill never makes a
  −0.0; the −0.0s a signed zero demand turns to +0.0 (``0 · −0.0`` debited
  from every node) are turned once, before the candidates;
- float sums run in sequence: the capacity prefix's S ≤ 64 segments
  chained in order, each from its first node, the segment offsets chained
  over the segment totals, the joint floor over the groups and a domain's
  free total over the resources;
- a level fill walks the domain's node range when the level's domains are
  the ranges of its boundary tables (``ops.exact.slab_levels``), else every
  node against ``topo``.

The card tests (``tests/test_torch_gpu.py``) hold the kernel itself to the
plain version, bit for bit on every field.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.ops import packing as jp
from grove_tpu_torch.convert import problem_from_arrays
from grove_tpu_torch.ops import exact as te
from grove_tpu_torch.ops import packing as tp
from grove_tpu_torch.ops.fill import _INT_CAP, _scan_segments, fill_batch, fill_batch_ref
from grove_tpu_torch.solver import kernel as tk
from grove_tpu_torch.solver.dedup import level_widths_of
from tests.exact_scan_cases import (
    EXACT_CASES,
    FLAGGED_CASES,
    batch_arrays,
    flags_of,
    scenario_batch,
    shuffled,
    stress_problem,
)
from tests.test_torch_exact import _flagged_problem

F32 = np.float32
FIELDS = ("admitted", "placed", "chosen_level", "alloc")


def _fits(free, d, cnt):
    """Capped fits of one group on rows ``free [M,R]``."""
    k = np.full(free.shape[0], _INT_CAP, dtype=np.int64)
    for r in range(free.shape[1]):
        if d[r] > 0:
            q = np.floor(free[:, r] / d[r])
            k = np.minimum(k, np.clip(q, 0, _INT_CAP).astype(np.int64))
    return np.minimum(k, cnt)


def _seq_sum(values):
    acc = values[0]
    for v in values[1:]:
        acc = F32(acc + v)
    return acc


def _capacity_prefix(free):
    """``[N+1, R]`` exclusive prefix: segments chained in order, offsets
    chained over the segment totals, each entry local + offset."""
    n, r_dim = free.shape
    s = _scan_segments(n)
    w = n // s
    out = np.zeros((n + 1, r_dim), dtype=F32)
    for r in range(r_dim):
        off = F32(0.0)
        for seg in range(s):
            acc = None
            for i in range(w):
                x = free[seg * w + i, r]
                acc = x if acc is None else F32(acc + x)
                out[seg * w + i + 1, r] = F32(acc + off) if s > 1 else acc
            off = F32(off + acc)
    return out


def _fill(work, nodes, d, counts):
    """The plain fill's takes on the rows ``nodes`` (ascending) of
    ``work``, debited where a take is nonzero; returns (takes [P,N],
    placed [P])."""
    p_dim = d.shape[0]
    takes = np.zeros((p_dim, work.shape[0]), dtype=np.int64)
    for p in range(p_dim):
        c = int(counts[p])
        if c == 0 or nodes.size == 0:
            continue
        k = _fits(work[nodes], d[p], c)
        cum = np.cumsum(k) - k
        take = np.minimum(np.maximum(c - cum, 0), k)
        hit = nodes[take != 0]
        work[hit] = (work[hit] - take[take != 0, None].astype(F32) * d[p]).astype(F32)
        takes[p, nodes] = take
    return takes, takes.sum(1)


class NodeSet:
    """A fill mask as the kernel walks it: the nodes of ``[lo, hi)`` whose
    topology ids match every ``(level, id)`` of ``cols``. A level whose
    domains are their boundary ranges (``slab``) narrows the range; any
    other adds a column test."""

    def __init__(self, n):
        self.lo, self.hi, self.cols = 0, n, []

    def restricted(self, lvl, dom, slab, seg_starts, seg_ends):
        out = NodeSet(0)
        out.lo, out.hi, out.cols = self.lo, self.hi, list(self.cols)
        if not slab[lvl]:
            out.cols.append((lvl, dom))
        elif 0 <= dom < seg_starts.shape[1]:
            out.lo = max(out.lo, int(seg_starts[lvl, dom]))
            out.hi = max(out.lo, min(out.hi, int(seg_ends[lvl, dom])))
        else:  # no node has an id outside the table
            out.hi = out.lo
        return out

    def nodes(self, topo):
        nodes = np.arange(self.lo, self.hi)
        for lvl, dom in self.cols:
            nodes = nodes[topo[nodes, lvl] == dom]
        return nodes


def _range_prefix(values, lo, hi):
    """The exclusive prefix of ``values`` over ``[lo, hi)`` (zero outside
    it), read at any index through the clamp ``min(max(j, lo), hi)``: the
    whole-axis prefix of values that are zero outside the range."""
    table = np.zeros(values.shape[0] + 1, dtype=np.int64)
    table[lo + 1 : hi + 1] = np.cumsum(values[lo:hi])
    return lambda j: table[np.clip(j, lo, hi)]


def _group_pick(work, cand, topo, d_p, floor_p, lvl, seg_starts, seg_ends):
    """A group pack's domain at level `lvl` inside the candidate: fits
    capped at max(floor, 1), K per domain of the padded table, feasible
    where K >= floor on a nonempty domain; the first feasible domain with
    K > 0, else the first feasible one (the strided pick at seed 0).
    Returns (domain, any feasible)."""
    n = work.shape[0]
    k = np.zeros(n, dtype=np.int64)
    nodes = cand.nodes(topo)
    k[nodes] = _fits(work[nodes], d_p, max(int(floor_p), 1))
    at = _range_prefix(k, cand.lo, cand.hi)
    s, e = seg_starts[lvl].astype(np.int64), seg_ends[lvl].astype(np.int64)
    big_k = at(e) - at(s)
    feas = (big_k >= floor_p) & (e > s)
    key = np.where(feas & (big_k > 0), np.arange(s.size), np.where(feas, s.size + np.arange(s.size),
                                                                 2 * s.size))
    best = int(key.min())
    return (best if best < s.size else best - s.size if best < 2 * s.size else 0), bool(feas.any())


def _bisect(lo, hi, ge):
    """The least t in [lo, hi] with ge(t), for ge monotone and ge(hi)."""
    while lo < hi:
        mid = (lo + hi) // 2
        if ge(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _spread_step(work, cand, topo, d_p, c, sl, seg_starts, seg_ends, load):
    """One group's balanced fill over the spread level's domains: per-domain
    fits K, the water level t (the least t with sum(min(K, t)) >= c, by
    bisection on [0, max K]; 2 * _INT_CAP when sum(K) < c), the quota
    min(K, t) less one on the `excess` water-level domains of largest key
    load * D + index (found by bisection on the key), then the take inside
    each node's domain. Debits `work` and adds the takes to `load`; returns
    the takes [N]."""
    n = work.shape[0]
    d_dim = seg_starts.shape[1]
    k = np.zeros(n, dtype=np.int64)
    nodes = cand.nodes(topo)
    k[nodes] = _fits(work[nodes], d_p, c)
    at = _range_prefix(k, cand.lo, cand.hi)
    s, e = seg_starts[sl].astype(np.int64), seg_ends[sl].astype(np.int64)
    big_k = at(e) - at(s)
    if big_k.sum() < c:
        t = 2 * _INT_CAP
    else:
        t = _bisect(0, int(big_k.max()), lambda m: np.minimum(big_k, m).sum() >= c)
    q = np.minimum(big_k, t)
    excess = int(q.sum() - min(c, big_k.sum()))
    level = big_k >= t
    if excess > 0:
        key = load.astype(np.int64) * d_dim + np.arange(d_dim)
        cut = _bisect(0, int(key[level].max()) + 1,
                      lambda m: int((level & (key >= m)).sum()) <= excess)
        q = q - (level & (key >= cut))
    col = topo[:, sl]
    take = np.zeros(n, dtype=np.int64)
    if nodes.size:
        in_dom = at(nodes) - at(s[col[nodes]])
        take[nodes] = np.minimum(np.maximum(q[col[nodes]] - in_dom, 0), k[nodes])
    hit = np.flatnonzero(take)
    work[hit] = (work[hit] - take[hit, None].astype(F32) * d_p).astype(F32)
    taken = _range_prefix(take, cand.lo, cand.hi)
    load += (taken(e) - taken(s)).astype(load.dtype)
    return take


def kernel_model(capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
                 pref_level, group_req=None, group_pin=None, gang_pin=None, spread_level=None,
                 spread_min=None, spread_required=None, spread_seed=None, *, with_alloc,
                 grouped=False, pinned=False, spread=False, uniform=False, level_widths=None):
    """``csrc/exact.cu``'s order of work for one problem, in numpy (see the
    module docstring). Returns solve_packing's dict of numpy arrays."""
    n, r_dim = capacity.shape
    n_levels = topo.shape[1]
    g_dim, p_dim, _ = demand.shape
    d_dim = seg_starts.shape[1]
    widths = level_widths or (d_dim,) * n_levels
    weights = tp._level_weights(n_levels, "cpu").numpy()
    slab = te.slab_levels(*(torch.from_numpy(a)[None] for a in (topo, seg_starts, seg_ends)))[0]
    unset = np.full((g_dim, p_dim), -1)
    group_req = unset if group_req is None else group_req
    group_pin = unset if group_pin is None else group_pin
    gang_pin = unset[:, 0] if gang_pin is None else gang_pin
    spread_level = unset[:, 0] if spread_level is None else spread_level
    free = capacity.astype(F32).copy()
    out = {
        "admitted": np.zeros(g_dim, dtype=bool),
        "placed": np.zeros((g_dim, p_dim), dtype=np.int32),
        "score": np.zeros(g_dim, dtype=F32),
        "chosen_level": np.full(g_dim, -1, dtype=np.int32),
        "alloc": np.zeros((g_dim, p_dim, n), dtype=np.int32) if with_alloc else None,
    }
    for g in range(g_dim):
        d, cnt, mn = demand[g], count[g].astype(np.int64), min_count[g].astype(np.int64)
        req, pref = int(req_level[g]), int(pref_level[g])
        active = cnt > 0
        any_active = bool(active.any())
        floors, extras = np.minimum(mn, cnt), np.maximum(cnt - mn, 0)
        # a gang pin: the prelude sees free zeroed outside the pinned domain
        everywhere = NodeSet(n)
        pin = int(gang_pin[g]) if pinned else -1
        pin_on = pin >= 0 and req >= 0
        if pin_on:
            everywhere = everywhere.restricted(req, pin, slab, seg_starts, seg_ends)
            vis = np.zeros_like(free)
            vis[everywhere.nodes(topo)] = free[everywhere.nodes(topo)]
        else:
            vis = free
        cs_k = np.concatenate([np.zeros((p_dim, 1), np.int64),
                               np.cumsum([_fits(vis, d[p], cnt[p]) for p in range(p_dim)], 1)],
                              1)
        cs_free = _capacity_prefix(vis)
        floor_demand = np.array([_seq_sum([F32(F32(mn[p]) * d[p, r]) for p in range(p_dim)])
                                 for r in range(r_dim)], dtype=F32)
        thr = (floor_demand - (F32(1e-5) * cs_free[n]).astype(F32)).astype(F32)

        def level_scan(lvl):
            w = widths[lvl]
            s, e = seg_starts[lvl, :w].astype(np.int64), seg_ends[lvl, :w].astype(np.int64)
            k_dom = cs_k[:, e] - cs_k[:, s]  # [P, w]
            fa = cs_free[e] - cs_free[s]  # [w, R]
            ft = np.array([_seq_sum(list(row)) for row in fa], dtype=F32)
            denom = F32(ft.max() + F32(1.0))
            feas = (np.where(active[:, None], k_dom >= mn[:, None], True).all(0)
                    & (fa >= thr).all(1) & (e > s) & any_active)
            spare = np.where(active[:, None], k_dom - cnt[:, None], 0).sum(0)
            key = (spare.astype(F32) + (ft / denom).astype(F32)).astype(F32)
            if not feas.any():
                return None
            return int(np.argmin(np.where(feas, key, np.inf)))

        g0 = free.copy()
        for r in range(r_dim):
            if np.signbit(d[:, r]).any():
                g0[:, r] = np.where(g0[:, r] == 0, F32(0.0), g0[:, r])
        spread_on = spread and int(spread_level[g]) >= 0
        if spread_on:
            sl = int(spread_level[g])
            seed = (np.zeros(d_dim, np.int64) if spread_seed is None or spread_seed.shape[1] == 0
                    else spread_seed[g].astype(np.int64))
            pref_eff = max(req, 0)
        else:
            pref_eff = pref if pref >= 0 else n_levels - 1
        rank = [2 * (n_levels - abs(lvl - pref_eff)) + (lvl > pref_eff) for lvl in range(n_levels)]
        levels = sorted(range(n_levels), key=lambda lvl: -rank[lvl])
        order = [n_levels] + levels if spread_on and req < 0 else levels + [n_levels]
        min_allowed = req if req >= 0 else 0
        chosen = None
        for cand in order:
            if cand < n_levels:
                if cand < min_allowed:
                    continue
                best = level_scan(cand)
                if best is None:
                    continue
                mask = NodeSet(n).restricted(cand, best, slab, seg_starts, seg_ends)
            else:
                if not (req < 0 and any_active):
                    continue
                mask = NodeSet(n)
            if pin_on:
                mask = mask.restricted(req, pin, slab, seg_starts, seg_ends)
            work = g0.copy()
            takes = np.zeros((p_dim, n), dtype=np.int64)
            used = 0
            if spread_on:  # the balanced fill: floors, then extras
                load = seed.copy()
                placed_min = None
                for phase in (floors, extras):
                    for p in range(p_dim):
                        if phase[p] > 0:
                            takes[p] += _spread_step(work, mask, topo, d[p], int(phase[p]), sl,
                                                     seg_starts, seg_ends, load)
                    if placed_min is None:
                        placed_min = takes.sum(1)
                placed = takes.sum(1)
                used = int((load > 0).sum())
            else:  # each group in its own mask: floors, then extras
                sets = []
                for p in range(p_dim):
                    gmask = mask
                    lvl = int(group_req[g, p]) if grouped else -1
                    if lvl >= 0:
                        dom, ok = _group_pick(work, mask, topo, d[p], floors[p], lvl,
                                              seg_starts, seg_ends)
                        if group_pin[g, p] >= 0:
                            dom, ok = int(group_pin[g, p]), True
                        gmask = mask.restricted(lvl, dom, slab, seg_starts, seg_ends)
                        if not ok:
                            gmask.hi = gmask.lo
                    sets.append(gmask.nodes(topo))
                    t, _ = _fill(work, sets[p], d[p : p + 1], floors[p : p + 1])
                    takes[p] += t[0]
                placed_min = takes.sum(1)
                if not (uniform and not grouped):
                    for p in range(p_dim):
                        t, _ = _fill(work, sets[p], d[p : p + 1], extras[p : p + 1])
                        takes[p] += t[0]
                placed = takes.sum(1)
            ok = np.where(active, placed_min >= mn, True).all()
            if spread_on and spread_required[g]:
                ok &= used >= min(max(int(spread_min[g]), 1), int(placed.sum() + seed.sum()))
            if ok:
                chosen = cand
                break
        if chosen is None:
            continue
        free = work
        placed = placed.astype(F32).astype(np.int64)
        left = np.where(group_req[g] < 0, cnt - placed, 0)
        if req < 0 and chosen < n_levels and not spread_on and (left != 0).any():
            takes2, placed2 = _fill(free, np.arange(n), d, left)
            takes, placed = takes + takes2, placed + placed2
        if spread_on:
            eff = min(max(int(spread_min[g]), 1), int(placed.sum() + seed.sum()))
            score = F32(F32(used) / F32(max(eff, 1)))
        else:
            pods = takes.sum(0)
            cs_pods = np.concatenate([[0], np.cumsum(pods)])
            total = F32(max(int(placed.sum()), 1))
            score = F32(0.0)
            for lvl in range(n_levels):
                w = widths[lvl]
                dom = (cs_pods[seg_ends[lvl, :w]] - cs_pods[seg_starts[lvl, :w]]).max()
                score = F32(score + F32(weights[lvl] * F32(F32(dom) / total)))
        out["admitted"][g] = True
        out["placed"][g] = placed
        out["score"][g] = min(max(score, F32(0.0)), F32(1.0))
        out["chosen_level"][g] = chosen if chosen < n_levels else -1
        if with_alloc:
            out["alloc"][g] = takes
    out["free_after"] = free
    return out


def _arrays(problem):
    return batch_arrays([problem])


def _flags(problem):
    return dict(uniform=bool((problem.min_count == problem.count).all()),
                level_widths=level_widths_of(problem))


def _assert_solve_equal(got, want, score_rtol):
    for name in FIELDS:
        if want[name] is None:
            assert got[name] is None, name
            continue
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(got["free_after"]).view(np.int32),
                                  np.asarray(want["free_after"]).view(np.int32))
    np.testing.assert_allclose(np.asarray(got["score"]), np.asarray(want["score"]),
                               rtol=score_rtol, atol=0)


def _jax_solve(arrays, with_alloc, flags):
    return jp.solve_packing(*map(jnp.asarray, arrays), with_alloc=with_alloc, **flags)


@pytest.mark.parametrize("with_alloc", [True, False], ids=["alloc", "stats"])
@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_kernel_order_matches_jax(case, with_alloc):
    """The kernel's order of work gives the JAX package's results: every
    field bit for bit (capacity by its bits), the score at rtol 1e-6 (XLA's
    CPU backend fuses its multiply-add)."""
    problem = EXACT_CASES[case]()
    arrays = [a[0] for a in _arrays(problem)]
    flags = _flags(problem)
    want = _jax_solve(arrays, with_alloc, flags)
    got = kernel_model(*arrays, with_alloc=with_alloc, **flags)
    _assert_solve_equal(got, want, 1e-6)
    assert 0 < got["admitted"].sum()


FLAG_SETS = {"grouped": (True, False, False), "pinned": (True, True, False),
             "spread": (False, False, True)}


@pytest.mark.parametrize("with_alloc", [True, False], ids=["alloc", "stats"])
@pytest.mark.parametrize("case", list(FLAGGED_CASES))
def test_kernel_order_matches_jax_with_flags(case, with_alloc):
    """The grouped, pinned and spread branches' order of work gives the JAX
    package's results on each flag set, a problem mixing spread and other
    gangs, its signed zeros and its permuted nodes; held as above. Some
    gangs wait (the cases cut capacity), so candidates fail and the order
    of the visits shows."""
    problem = FLAGGED_CASES[case]()
    flags = flags_of(problem)
    want_flags = FLAG_SETS.get(case, (True, True, True))
    assert (flags["grouped"], flags["pinned"], flags["spread"]) == want_flags
    arrays = [a[0] for a in batch_arrays([problem], constraints=True)]
    kw = dict(flags, level_widths=level_widths_of(problem))
    want = _jax_solve(arrays, with_alloc, kw)
    got = kernel_model(*arrays, with_alloc=with_alloc, **kw)
    _assert_solve_equal(got, want, 1e-6)
    assert 0 < got["admitted"].sum() < (problem.count > 0).any(1).sum()


def test_kernel_order_matches_jax_on_padded_levels():
    """Without level widths the scan runs the padded tables' width at every
    level: the padded domains never win."""
    problem = stress_problem(100, 96, seed=4)
    arrays = [a[0] for a in _arrays(problem)]
    want = _jax_solve(arrays, False, dict(uniform=True))
    got = kernel_model(*arrays, with_alloc=False, uniform=True, level_widths=None)
    _assert_solve_equal(got, want, 1e-6)


def test_kernel_order_matches_jax_on_a_scenario_batch():
    """Each problem of a batch of independent scenarios (one block each on
    the card) against the JAX package's solve of it alone."""
    problems = scenario_batch()
    batch = batch_arrays(problems)
    for i, problem in enumerate(problems):
        arrays = [a[i] for a in batch]
        flags = _flags(problem)
        got = kernel_model(*arrays, with_alloc=True, **flags)
        _assert_solve_equal(got, _jax_solve(arrays, True, flags), 1e-6)


# -- the dispatch -------------------------------------------------------------


def test_cpu_solve_never_reaches_the_kernel_wrapper(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("solve on the CPU reached ops.exact.exact_scan")

    monkeypatch.setattr(tk, "exact_scan", refuse)
    problem = stress_problem(64, 32)
    before = te.exact_scan.launches
    got = tk.solve(problem, with_alloc=False, device="cpu")
    assert got.admitted.any() and te.exact_scan.launches == before


# a problem of each flag set and its flags (grouped, pinned, spread); the
# pinned case's recovery pins come with their group packs
_DISPATCH_CASES = {
    "plain": (lambda: stress_problem(96, 64), (False, False, False)),
    "grouped": (FLAGGED_CASES["grouped"], (True, False, False)),
    "pinned": (FLAGGED_CASES["pinned"], (True, True, False)),
    "spread": (FLAGGED_CASES["spread"], (False, False, True)),
    "all": (lambda: problem_from_arrays(_flagged_problem()), (True, True, True)),
}


@pytest.mark.parametrize("kind", list(_DISPATCH_CASES))
def test_uses_exact_kernel_by_flag_set(kind, monkeypatch):
    """On a CUDA device with the default fill, a problem of every flag set
    reaches the exact kernel's wrapper, once, with its flags; another fill
    or the CPU keeps the host loop. The dispatch is answered as for a CUDA
    device, so the wrapper's CPU path (the plain version) runs here."""
    build, flags = _DISPATCH_CASES[kind]
    problem = build()
    assert tk._flags(tk._problem_arrays(problem))[:3] == flags
    cuda = torch.device("cuda")
    dispatch = tk.uses_exact_kernel
    assert dispatch(cuda, fill_batch) is True
    # another fill (the plain fill, a recording fill) keeps the host loop
    assert dispatch(cuda, fill_batch_ref) is False
    assert dispatch(cuda, lambda *a, **k: None) is False
    assert dispatch(torch.device("cpu"), fill_batch) is False
    calls = []

    def recording(*args, **kwargs):
        calls.append(tuple(kwargs[k] for k in ("grouped", "pinned", "spread")))
        return te.exact_scan(*args, **kwargs)

    monkeypatch.setattr(tk, "uses_exact_kernel", lambda device, fill: dispatch(cuda, fill))
    monkeypatch.setattr(tk, "exact_scan", recording)
    kern = tk.solve(problem, with_alloc=False, device="cpu")
    assert calls == [flags]
    loop = tk.solve(problem, with_alloc=False, device="cpu", fill=fill_batch_ref)
    assert calls == [flags]
    np.testing.assert_array_equal(kern.admitted, loop.admitted)


def test_flagged_problems_take_the_host_loop(monkeypatch):
    """With the kernel's dispatch forced on the CPU, a grouped, pinned and
    spread problem reaches the wrapper as a plain one does, with its seven
    constraint arrays and its flags, and the wrapper's CPU path (the plain
    version) equals the host loop on every field."""
    calls = []
    monkeypatch.setattr(tk, "uses_exact_kernel", lambda *a: True)

    def recording(*args, **kwargs):
        calls.append((len(args), args[0].shape,
                      tuple(kwargs[k] for k in ("grouped", "pinned", "spread"))))
        return te.exact_scan(*args, **kwargs)

    monkeypatch.setattr(tk, "exact_scan", recording)
    flagged = problem_from_arrays(_flagged_problem())
    assert tk._flags(tk._problem_arrays(flagged))[:3] == (True, True, True)
    plain = stress_problem(96, 64)
    for problem in (flagged, plain):
        forced = tk.solve(problem, device="cpu")
        monkeypatch.setattr(tk, "uses_exact_kernel", lambda *a: False)
        loop = tk.solve(problem, device="cpu")
        monkeypatch.setattr(tk, "uses_exact_kernel", lambda *a: True)
        for name in ("admitted", "placed", "score", "chosen_level", "alloc"):
            np.testing.assert_array_equal(getattr(forced, name), getattr(loop, name))
        np.testing.assert_array_equal(forced.free_after.view(np.int32),
                                      loop.free_after.view(np.int32))
    assert calls == [(16, (1, 128, 2), (True, True, True)), (16, (1, 96, 2), (False,) * 3)]


# -- the wrapper's host side --------------------------------------------------


def test_launch_plan_keeps_a_full_width_problem_in_shared_memory():
    """(a)'s 5,120 nodes with P=3 and R=2 fit one block's shared memory;
    past 227 KB the big arrays go to a global scratch buffer per problem."""
    plan = te.launch_plan(5120, 3, 2)
    assert plan["use_smem"] and plan["scratch"] == 0
    assert plan["big"] == 4 * (2 * 5120 * 2 + 3 * 5121 + 5121 * 2 + 5121) + 4 * 6
    assert plan["smem"] == plan["small"] + plan["big"] <= 227 * 1024
    assert plan["small"] % 16 == 0 and plan["big"] % 16 == 0
    wide = te.launch_plan(20000, 3, 2)
    assert not wide["use_smem"] and wide["smem"] == wide["small"]
    assert wide["scratch"] == wide["big"] > 227 * 1024
    assert te.launch_plan(1, 1, 1)["use_smem"]


def test_launch_plan_places_the_flag_arrays():
    """The arrays a flag needs come after the first five, each in shared
    memory while it fits: at (e)'s width the spread's quota does, its load
    and both prefix tables go to scratch; group packs add one prefix table;
    a plain problem none. Offsets are 16-byte aligned and the arrays of one
    memory do not overlap."""
    plain = te.launch_plan(5120, 3, 2, 5120)
    assert plain["big"] == te.launch_plan(5120, 3, 2)["big"]
    spread = te.launch_plan(5120, 3, 2, 5120, spread=True)
    in_smem = [a for i, a in enumerate(te.ARRAYS) if spread["smem_mask"] >> i & 1 and
               spread["sizes"][i]]
    assert in_smem == ["capacity", "work", "cs_k", "cs_free", "pods", "kq"]
    assert spread["scratch"] == 2 * te._align(4 * 5121) + te._align(4 * 5120)
    assert spread["smem"] == plain["smem"] + te._align(4 * 5120) <= 227 * 1024
    grouped = te.launch_plan(1024, 4, 2, 1024, grouped=True)
    assert grouped["scratch"] == 0
    assert grouped["big"] == te.launch_plan(1024, 4, 2)["big"] + te._align(4 * 1025)
    wide = te.launch_plan(20000, 3, 2, 20000, grouped=True, spread=True)
    assert not wide["use_smem"] and wide["smem"] > wide["small"]  # kq and load fit
    for plan in (plain, spread, grouped, wide):
        assert sum(plan["sizes"]) == plan["big"]
        for where, end in ((1, plan["smem"]), (0, plan["scratch"])):
            spans = sorted((plan["offsets"][i], plan["sizes"][i]) for i in range(len(te.ARRAYS))
                           if (plan["smem_mask"] >> i & 1) == where and plan["sizes"][i])
            at = plan["small"] if where else 0
            for offset, size in spans:
                assert offset % 16 == 0 and offset >= at
                at = offset + size
            assert at <= end


def test_slab_levels_flags_the_encoders_contiguous_domains():
    problem = stress_problem(100, 16)
    arrays = [torch.from_numpy(a) for a in _arrays(problem)[1:4]]
    assert te.slab_levels(*arrays).tolist() == [[1] * 5]
    mixed = shuffled(stress_problem(128, 16, seed=6))
    arrays = [torch.from_numpy(a) for a in _arrays(mixed)[1:4]]
    # the one-domain levels stay whole ranges; the permuted ones do not
    assert te.slab_levels(*arrays).tolist() == [[1, 1, 0, 0, 0]]
    both = [torch.cat([a, b]) for a, b in zip(
        (torch.from_numpy(a) for a in _arrays(stress_problem(128, 16))[1:4]), arrays)]
    assert te.slab_levels(*both).tolist() == [[1] * 5, [1, 1, 0, 0, 0]]


def test_slab_levels_rejects_ids_outside_their_range():
    topo = torch.tensor([[[0], [0], [1], [1]]], dtype=torch.int32)
    starts = torch.tensor([[[0, 2]]], dtype=torch.int32)
    ends = torch.tensor([[[2, 4]]], dtype=torch.int32)
    assert te.slab_levels(topo, starts, ends).tolist() == [[1]]
    assert te.slab_levels(topo, starts, torch.tensor([[[3, 4]]], dtype=torch.int32)).tolist() \
        == [[0]]  # node 2 (id 1) inside domain 0's range
    assert te.slab_levels(topo.flip(1), starts, ends).tolist() == [[0]]
    assert te.slab_levels(topo + 1, starts, ends).tolist() == [[0]]  # id 2 >= D


def test_check_inputs():
    problem = stress_problem(64, 32)
    args = (problem.count, problem.min_count, problem.pref_level, problem.demand, 5)
    te.check_inputs(*args)
    for i, bad in ((0, -1), (1, -1), (2, 5), (2, -2), (3, np.inf)):
        arrays = [a.copy() if isinstance(a, np.ndarray) else a for a in args]
        arrays[i].reshape(-1)[0] = bad
        with pytest.raises(ValueError, match="exact_scan"):
            te.check_inputs(*arrays)


def test_check_inputs_constraints():
    """Group packs and spread levels in [-1, L), survivor seeds of width 0
    or D and never below 0; the encoder's flagged problems pass."""
    problem = FLAGGED_CASES["mixed"]()
    arrays = tk._problem_arrays(problem)
    kw = dict(group_req=arrays[9], spread_level=arrays[12], spread_seed=arrays[15],
              n_domains=problem.seg_starts.shape[1])
    args = (problem.count, problem.min_count, problem.pref_level, problem.demand, 5)
    te.check_inputs(*args, **kw)
    assert kw["spread_seed"].shape[1] == 96 and (kw["group_req"] >= 0).any()
    for name, bad in (("group_req", 5), ("group_req", -2), ("spread_level", 5),
                      ("spread_level", -2), ("spread_seed", -1)):
        broken = dict(kw, **{name: kw[name].copy()})
        broken[name].reshape(-1)[0] = bad
        with pytest.raises(ValueError, match="exact_scan"):
            te.check_inputs(*args, **broken)
    with pytest.raises(ValueError, match="survivor seeds of width 95"):
        te.check_inputs(*args, **dict(kw, spread_seed=kw["spread_seed"][:, :95]))
    te.check_inputs(*args, **dict(kw, spread_seed=kw["spread_seed"][:, :0]))


def test_pack_args_shapes_types_and_widths():
    problem = stress_problem(100, 16)
    batch = [torch.from_numpy(a) for a in batch_arrays([problem, problem])]
    batch[2], batch[3] = batch[2].long(), batch[3].long()  # the solver's int64 tables
    args = te.pack_args(*batch, level_widths=level_widths_of(problem))
    for name in ("topo", "seg_starts", "seg_ends", "count", "min_count", "req_level",
                 "pref_level"):
        assert args[name].dtype == torch.int32 and args[name].is_contiguous(), name
    assert args["widths"] == (1, 1, 2, 13, 100)
    assert args["weights"] == tuple(tp._level_weights(5, "cpu").tolist())
    assert np.array(args["weights"], dtype=F32).tolist() == list(args["weights"])
    assert args["slab"].shape == (2, 5) and args["segments"] == _scan_segments(100) == 4
    assert te.pack_args(*batch)["widths"] == (100,) * 5  # padded scan
    with pytest.raises(ValueError, match="level widths"):
        te.pack_args(*batch, level_widths=(1, 1, 2, 13, 101))
    with pytest.raises(ValueError, match="level widths"):
        te.pack_args(*batch, level_widths=(1, 1, 2))
    assert all(args[name] is None for name in te.CONSTRAINTS)


def test_pack_args_takes_the_constraints():
    problems = [FLAGGED_CASES["mixed"](), FLAGGED_CASES["mixed"]()]
    batch = [torch.from_numpy(a) for a in batch_arrays(problems, constraints=True)]
    batch[9:] = [t.long() if t.dtype == torch.int32 else t for t in batch[9:]]
    args = te.pack_args(*batch, level_widths=level_widths_of(problems[0]))
    for name in te.CONSTRAINTS:
        want = torch.uint8 if name == "spread_required" else torch.int32
        assert args[name].dtype == want and args[name].is_contiguous(), name
    assert args["spread_seed"].shape == (2, 64, 96) and args["group_req"].shape == (2, 64, 4)


def test_exact_scan_on_cpu_is_the_plain_version_per_problem():
    """The wrapper on CPU tensors: each problem of the batch equals
    ``solve_packing`` of it alone; nothing counts as a launch."""
    problems = scenario_batch()
    batch = [torch.from_numpy(a) for a in batch_arrays(problems)]
    before = te.exact_scan.launches
    got = te.exact_scan(*batch, with_alloc=True, uniform=True,
                        level_widths=level_widths_of(problems[0]))
    assert te.exact_scan.launches == before
    g_dim = problems[0].demand.shape[0]
    assert got["admitted"].dtype == torch.bool and got["alloc"].shape == (3, g_dim, 3, 64)
    for i in range(len(problems)):
        want = tp.solve_packing(*(a[i] for a in batch), with_alloc=True, uniform=True,
                                level_widths=level_widths_of(problems[i]))
        _assert_solve_equal({k: v[i] for k, v in got.items()}, want, 0)
    assert te.exact_scan(*batch, with_alloc=False)["alloc"] is None
    with pytest.raises(ValueError, match="unsupported device"):
        te.exact_scan(*(a.to("meta") for a in batch))


@pytest.mark.parametrize("case", ["grouped", "spread"])
def test_exact_scan_on_cpu_with_flags_is_the_plain_version_per_problem(case):
    """A batch of two flagged problems through the wrapper on CPU tensors:
    each equals ``solve_packing`` of it alone with its flags."""
    problems = [FLAGGED_CASES[case](), FLAGGED_CASES[case]()]
    problems[1].capacity[48:] = 0.0
    batch = [torch.from_numpy(a) for a in batch_arrays(problems, constraints=True)]
    flags = flags_of(problems[0])
    got = te.exact_scan(*batch, with_alloc=True, level_widths=level_widths_of(problems[0]),
                        **flags)
    for i, problem in enumerate(problems):
        want = tp.solve_packing(*(a[i] for a in batch), with_alloc=True,
                                level_widths=level_widths_of(problem), **flags)
        _assert_solve_equal({k: v[i] for k, v in got.items()}, want, 0)
    assert got["admitted"][0].sum() > got["admitted"][1].sum() > 0
