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
from grove_tpu_torch.ops.fill import _INT_CAP, _scan_segments, fill_batch
from grove_tpu_torch.solver import kernel as tk
from grove_tpu_torch.solver.dedup import level_widths_of
from tests.exact_scan_cases import (
    EXACT_CASES,
    batch_arrays,
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


def kernel_model(capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
                 pref_level, with_alloc, uniform, level_widths):
    """``csrc/exact.cu``'s order of work for one problem, in numpy (see the
    module docstring). Returns solve_packing's dict of numpy arrays."""
    n, r_dim = capacity.shape
    n_levels = topo.shape[1]
    g_dim, p_dim, _ = demand.shape
    widths = level_widths or (seg_starts.shape[1],) * n_levels
    weights = tp._level_weights(n_levels, "cpu").numpy()
    slab = te.slab_levels(*(torch.from_numpy(a)[None] for a in (topo, seg_starts, seg_ends)))[0]
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
        cs_k = np.concatenate([np.zeros((p_dim, 1), np.int64),
                               np.cumsum([_fits(free, d[p], cnt[p]) for p in range(p_dim)], 1)],
                              1)
        cs_free = _capacity_prefix(free)
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
        pref_eff = pref if pref >= 0 else n_levels - 1
        rank = [2 * (n_levels - abs(lvl - pref_eff)) + (lvl > pref_eff) for lvl in range(n_levels)]
        min_allowed = req if req >= 0 else 0
        chosen = None
        for cand in sorted(range(n_levels), key=lambda lvl: -rank[lvl]) + [n_levels]:
            if cand < n_levels:
                if cand < min_allowed:
                    continue
                best = level_scan(cand)
                if best is None:
                    continue
                if slab[cand]:
                    nodes = np.arange(seg_starts[cand, best], seg_ends[cand, best])
                else:
                    nodes = np.flatnonzero(topo[:, cand] == best)
            else:
                if not (req < 0 and any_active):
                    continue
                nodes = np.arange(n)
            work = g0.copy()
            if uniform:
                takes, placed = _fill(work, nodes, d, np.minimum(mn, cnt))
                placed_min = placed
            else:
                takes, placed_min = _fill(work, nodes, d, np.minimum(mn, cnt))
                takes2, placed2 = _fill(work, nodes, d, np.maximum(cnt - mn, 0))
                takes, placed = takes + takes2, placed_min + placed2
            if np.where(active, placed_min >= mn, True).all():
                chosen = cand
                break
        if chosen is None:
            continue
        free = work
        placed = placed.astype(F32).astype(np.int64)
        if req < 0 and chosen < n_levels and (cnt - placed != 0).any():
            takes2, placed2 = _fill(free, np.arange(n), d, cnt - placed)
            takes, placed = takes + takes2, placed + placed2
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


@pytest.mark.parametrize("flags,kernel", [
    ((False, False, False), True),
    ((True, False, False), False),
    ((False, True, False), False),
    ((False, False, True), False),
    ((True, True, True), False),
], ids=["plain", "grouped", "pinned", "spread", "all"])
def test_uses_exact_kernel_by_flag_set(flags, kernel):
    cuda = torch.device("cuda")
    assert tk.uses_exact_kernel(cuda, fill_batch, *flags) is kernel
    # another fill (the plain fill, a recording fill) keeps the host loop
    assert tk.uses_exact_kernel(cuda, lambda *a, **k: None, *flags) is False
    assert tk.uses_exact_kernel(torch.device("cpu"), fill_batch, *flags) is False


def test_flagged_problems_take_the_host_loop(monkeypatch):
    """With the kernel's dispatch forced on the CPU, a grouped, pinned and
    spread problem still takes the host loop (its flags say so) and a
    plain one reaches the wrapper, whose CPU path is the plain version:
    both equal the host loop."""
    calls = []
    monkeypatch.setattr(tk, "uses_exact_kernel",
                        lambda device, fill, *flags: not any(flags))

    def recording(*args, **kwargs):
        calls.append(args[0].shape)
        return te.exact_scan(*args, **kwargs)

    monkeypatch.setattr(tk, "exact_scan", recording)
    flagged = problem_from_arrays(_flagged_problem())
    assert tk._flags(tk._problem_arrays(flagged))[:3] == (True, True, True)
    plain = stress_problem(96, 64)
    for problem, reached in ((flagged, False), (plain, True)):
        calls.clear()
        forced = tk.solve(problem, device="cpu")
        assert bool(calls) is reached
        monkeypatch.setattr(tk, "uses_exact_kernel", lambda *a: False)
        loop = tk.solve(problem, device="cpu")
        monkeypatch.setattr(tk, "uses_exact_kernel",
                            lambda device, fill, *flags: not any(flags))
        for name in ("admitted", "placed", "score", "chosen_level", "alloc"):
            np.testing.assert_array_equal(getattr(forced, name), getattr(loop, name))
        np.testing.assert_array_equal(forced.free_after.view(np.int32),
                                      loop.free_after.view(np.int32))
    assert calls == [(1, 96, 2)]


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
