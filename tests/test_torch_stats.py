"""The port's stats path against the JAX package's.

``ops.packing.solve_waves_device`` (compaction, settled chunks, lazy rescue,
the slab fill) and ``solver.kernel.solve_waves_stats`` (with its exact
hybrid tail) against ``grove_tpu``'s functions of the same names. Problems
are encoded once by the JAX package and carried across with
``problem_from_arrays``. Integer, bool and capacity results are compared
bit for bit; the PlacementScore with rtol=1e-6, atol=0, because XLA's CPU
backend fuses the score's multiply-add (see tests/test_torch_packing.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grove_tpu.api.topology import ClusterTopology as JTopology
from grove_tpu.models import build_stress_problem as j_build_stress_problem
from grove_tpu.models import stress_gang_specs as j_stress_gang_specs
from grove_tpu.ops import packing as jp
from grove_tpu.sim.cluster import make_nodes as j_make_nodes
from grove_tpu.solver import kernel as jk
from grove_tpu.solver.encode import build_problem as j_build_problem
from grove_tpu_torch.convert import problem_from_arrays
from grove_tpu_torch.ops import packing as tp
from grove_tpu_torch.ops.fill import fill_batch
from grove_tpu_torch.solver import kernel as tk
from tests.test_solver import TOPO, gang, group
from tests.test_torch_encode import MEM_CAPACITY, mixed_specs
from tests.test_torch_solve import _flagged_specs

CHUNK = jk.BENCH_CHUNK_SIZE


def _frag_problem():
    """tests/test_solver.py's lazy-rescue problem: a two-zone cluster where
    zone 0's levels look feasible but fragment, so only the cluster-wide
    fill admits the gang (eagerly in-wave, or lazily one wave later)."""
    nodes = j_make_nodes(5, capacity={"cpu": 4.0}, hosts_per_ici_block=1, blocks_per_slice=3)
    for i, n in enumerate(nodes):
        z = 0 if i < 3 else 1
        n.labels["topology.kubernetes.io/zone"] = f"zone-{z}"
        n.labels["cloud.google.com/gke-cluster"] = f"cluster-{z}"
    nodes[2].capacity["cpu"] = 1.0
    nodes[3].capacity["cpu"] = 2.0
    nodes[4].capacity["cpu"] = 2.0
    gangs = [gang("frag", [group("frag-a", cpu=3.0, count=2),
                           group("frag-tiny", cpu=1.0, count=1),
                           group("frag-c", cpu=2.0, count=1)])]
    return j_build_problem(nodes, gangs, TOPO)


def _uniform_flagged_problem():
    """Stress gangs (floors == counts) with per-group packs, a soft spread
    and recovery pins on some: uniform, so the lazy rescue runs, but no
    slab fill (pins turn the dedup table off, spread and groups bypass it)."""
    specs = j_stress_gang_specs(192, seed=7)
    for i, spec in enumerate(specs):
        if i % 5 == 1:
            spec["groups"][0]["required_key"] = "cloud.google.com/gke-tpu-ici-block"
        elif i % 5 == 2:
            spec.update(spread_key="kubernetes.io/hostname", spread_min_domains=2)
        elif i % 5 == 3:
            spec.update(required_key="cloud.google.com/gke-tpu-slice",
                        gang_pinned_node=f"node-{(i * 5) % 64}")
    return j_build_problem(j_make_nodes(64, {"cpu": 128.0, "tpu": 8.0}, 8, 8), specs, JTopology())


PROBLEMS = {
    "stress": lambda: j_build_stress_problem(128, 1024),
    "nonuniform": lambda: j_build_problem(j_make_nodes(64, MEM_CAPACITY), mixed_specs(192, 3),
                                          JTopology()),
    "flagged": lambda: j_build_problem(j_make_nodes(128, {"cpu": 128.0, "tpu": 8.0}, 8, 8),
                                       _flagged_specs(), JTopology()),
    "uniform_flagged": _uniform_flagged_problem,
}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def case(request):
    """(name, JAX problem, port problem) of each problem, built once."""
    problem = PROBLEMS[request.param]()
    return request.param, problem, problem_from_arrays(problem)


def _device_inputs(problem, port_problem, chunk_size):
    """The padded arguments of solve_waves_device (the port's padding held
    equal to the JAX package's) and its static keywords."""
    raw, n_chunks, grouped, pinned, spread, uniform = jk.pad_problem_for_waves(problem, chunk_size)
    port_raw, *port_flags = tk.pad_problem_for_waves(port_problem, chunk_size)
    assert port_flags == [n_chunks, grouped, pinned, spread, uniform]
    for a, b in zip(raw, port_raw):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    extra = jk.dedup_extra_args(raw[4], raw[5], n_chunks, pinned, place=np.asarray)
    kw = dict(n_chunks=n_chunks, grouped=grouped, pinned=pinned, spread=spread,
              uniform=uniform, lazy_rescue=uniform, level_widths=jk.level_widths_of(problem))
    return raw, extra, kw


def _jax_device(raw, extra, kw, max_waves):
    out = jp.solve_waves_device(*map(jnp.asarray, raw),
                                **{k: jnp.asarray(v) for k, v in extra.items()},
                                max_waves=max_waves, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_device(raw, extra, kw, max_waves, **more):
    out = tp.solve_waves_device(*map(torch.from_numpy, raw),
                                **{k: torch.from_numpy(v) for k, v in extra.items()},
                                max_waves=max_waves, **kw, **more)
    return {k: v if isinstance(v, int) else v.numpy() for k, v in out.items()}


def assert_same_stats(got, want):
    """PackingResults of the stats path (no alloc on either side)."""
    assert got.alloc is None and want.alloc is None
    for name in ("admitted", "placed", "chosen_level", "free_after"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.score.dtype == want.score.dtype
    np.testing.assert_allclose(got.score, want.score, rtol=1e-6, atol=0)


def assert_same_device_result(got, want):
    assert got["waves"] == int(want["waves"])
    for name in ("admitted", "placed", "chosen_level", "free_after", "pending"):
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got["score"].dtype == want["score"].dtype
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def device_runs(case):
    """The JAX and port results of solve_waves_device on `case`, with the
    port's slab fills and pending-count reads counted."""
    name, problem, port_problem = case
    raw, extra, kw = _device_inputs(problem, port_problem, CHUNK)
    want = _jax_device(raw, extra, kw, jk.BENCH_MAX_WAVES)
    counts = {"slab": 0, "reads": 0}
    slab, read = tp._fill_slab_pair, tp._host_int

    def slab_spy(*args, **kwargs):
        counts["slab"] += 1
        return slab(*args, **kwargs)

    def read_spy(t):
        counts["reads"] += 1
        return read(t)

    mp = pytest.MonkeyPatch()
    mp.setattr(tp, "_fill_slab_pair", slab_spy)
    mp.setattr(tp, "_host_int", read_spy)
    try:
        got = _port_device(raw, extra, kw, jk.BENCH_MAX_WAVES)
    finally:
        mp.undo()
    return name, kw, got, want, counts


def test_solve_waves_device_matches(device_runs):
    name, kw, got, want, counts = device_runs
    assert_same_device_result(got, want)
    assert 0 < want["admitted"].sum() < want["admitted"].size
    assert want["waves"] >= 2
    if name == "stress":  # the slab fill ran, and gangs are left for the tail
        assert counts["slab"] > 0 and want["pending"].sum() > 0
    else:
        assert counts["slab"] == 0
    assert kw["lazy_rescue"] == (name in ("stress", "uniform_flagged"))


def test_wave_loop_reads_one_count_per_wave(device_runs):
    """One read per wave (the pending count) and, with the lazy rescue, one
    for the epilogue's check; nothing else (see also
    test_wave_loop_reads_nothing_else)."""
    _, kw, got, _, counts = device_runs
    assert counts["reads"] == got["waves"] + (1 if kw["lazy_rescue"] else 0)


def test_wave_loop_reads_nothing_else(monkeypatch):
    """Every way a tensor's value reaches Python fails inside the wave loop
    except the one read of ``_host_int``."""
    problem = j_build_stress_problem(64, 256)
    raw, extra, kw = _device_inputs(problem, problem_from_arrays(problem), CHUNK)
    allowed = [False]
    read = tp._host_int

    def counted_read(t):
        allowed[0] = True
        try:
            return read(t)
        finally:
            allowed[0] = False

    def guard(name, method):
        def guarded(self, *args, **kwargs):
            if not allowed[0]:
                raise AssertionError(f"Tensor.{name} read a value inside the wave loop")
            return method(self, *args, **kwargs)
        return guarded

    tensors = {k: torch.from_numpy(v) for k, v in extra.items()}
    args = tuple(map(torch.from_numpy, raw))
    monkeypatch.setattr(tp, "_host_int", counted_read)
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    out = tp.solve_waves_device(*args, **tensors, max_waves=jk.BENCH_MAX_WAVES, **kw)
    monkeypatch.undo()
    assert out["waves"] >= 2 and int(out["admitted"].sum()) > 0


@pytest.mark.parametrize("max_waves", [8, 3], ids=["deferral", "budget_boundary"])
def test_lazy_rescue_matches_jax_and_eager(max_waves):
    """tests/test_solver.py's deferral and budget-boundary cases: the
    port's lazy solve equals JAX's lazy solve on every field, and admits
    as JAX's eager solve does; the deferral takes more waves than the eager
    rescue, and at max_waves=3 the epilogue leaves nothing on the sentinel."""
    problem = _frag_problem()
    raw, extra, kw = _device_inputs(problem, problem_from_arrays(problem), 32)
    assert kw["uniform"] and kw["lazy_rescue"]
    got = _port_device(raw, extra, kw, max_waves)
    assert_same_device_result(got, _jax_device(raw, extra, kw, max_waves))
    eager = _jax_device(raw, extra, {**kw, "lazy_rescue": False}, max_waves)
    for name in ("admitted", "placed", "free_after"):
        np.testing.assert_array_equal(got[name], eager[name], err_msg=name)
    np.testing.assert_allclose(got["score"], eager["score"], rtol=1e-6, atol=0)
    assert got["admitted"][0] and got["chosen_level"][0] == -1
    if max_waves == 8:
        assert got["waves"] > int(eager["waves"])
    else:
        assert not got["pending"][0]


def test_eager_rescue_of_port_matches_jax():
    """lazy_rescue=False on the same uniform problem: the eager in-wave
    rescue inside the wave loop."""
    problem = _frag_problem()
    raw, extra, kw = _device_inputs(problem, problem_from_arrays(problem), 32)
    kw = {**kw, "lazy_rescue": False}
    assert_same_device_result(_port_device(raw, extra, kw, 8), _jax_device(raw, extra, kw, 8))


def test_lazy_rescue_requires_uniform():
    problem = problem_from_arrays(j_build_problem(j_make_nodes(8), mixed_specs(8, 1), JTopology()))
    raw, n_chunks, grouped, pinned, spread, uniform = tk.pad_problem_for_waves(problem, 8)
    assert not uniform
    with pytest.raises(ValueError, match="uniform"):
        tp.solve_waves_device(*map(torch.from_numpy, raw), n_chunks=n_chunks,
                              uniform=False, lazy_rescue=True)


def test_solve_waves_stats_matches(case, monkeypatch):
    """The whole stats solve, hybrid tail included, on the CPU; the tail
    runs the port's exact solve on exactly the JAX tail's gangs."""
    name, problem, port_problem = case
    want = jk.solve_waves_stats(problem)
    tails = []
    solve = tk.solve

    def tail_spy(tail, **kwargs):
        tails.append(tail.num_gangs)
        return solve(tail, **kwargs)

    monkeypatch.setattr(tk, "solve", tail_spy)
    before = fill_batch.launches
    got = tk.solve_waves_stats(port_problem, device="cpu")
    assert fill_batch.launches == before  # CPU tensors take the plain fill
    assert_same_stats(got, want)
    assert got.solve_seconds > 0
    if name == "stress":
        assert tails == [1024]  # 677 gangs, padded to a power of two
    assert all(t >= 32 and t & (t - 1) == 0 for t in tails)


def test_solve_waves_stats_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tk.solve_waves_stats(problem_from_arrays(_frag_problem()))


def _fill_slab_inputs(seed, p_dim, c=6, n=40, r=2, u=5):
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 9, (n, r)).astype(np.float32)
    pair_dem = np.vstack([np.zeros((1, r)), rng.integers(1, 4, (u - 1, r))]).astype(np.float32)
    pair_cap = np.concatenate([[0], rng.integers(1, 7, u - 1)]).astype(np.int32)
    uidx = rng.integers(1, u, (c, p_dim)).astype(np.int32)
    uidx[0, :] = 0  # a gang masked out by the pending filter
    starts = rng.integers(0, n, c)
    ends = np.minimum(n, starts + rng.integers(0, 16, c))
    starts[1], ends[1] = 0, n  # the whole cluster
    starts[2] = ends[2] = 0  # nothing
    return free, pair_dem, pair_cap, uidx, starts.astype(np.int32), ends.astype(np.int32)


@pytest.mark.parametrize("p_dim", [1, 3])
def test_fill_slab_pair_matches(p_dim):
    """The slab fill alone: group 0 from the shared prefix row, groups
    1..P-1 through one fill call without free_after."""
    free, pair_dem, pair_cap, uidx, starts, ends = _fill_slab_inputs(p_dim, p_dim)
    fit = np.asarray(jnp.minimum(
        jnp.stack([jp._pods_fit_per_node(jnp.asarray(free), jnp.asarray(d)) for d in pair_dem]),
        jnp.asarray(pair_cap)[:, None]))
    cs_pair = np.concatenate(
        [np.zeros((fit.shape[0], 1), np.int32), np.cumsum(fit, 1, dtype=np.int32)], 1)
    demand, count = pair_dem[uidx], pair_cap[uidx]

    def jax_one(s, e, dem, cnt, eff):
        g = jp.GangInputs(dem, cnt, cnt, jnp.int32(-1), jnp.int32(-1))
        return jp._fill_slab_pair(jnp.asarray(free), s, e, g, jnp.asarray(cs_pair), eff)

    want = [[np.asarray(x) for x in jax_one(jnp.int32(s), jnp.int32(e), jnp.asarray(d),
                                            jnp.asarray(k), jnp.asarray(i))]
            for s, e, d, k, i in zip(starts, ends, demand, count, uidx)]
    calls = []

    def recording_fill(*args, with_free_after=True):
        calls.append(with_free_after)
        return fill_batch(*args, with_free_after=with_free_after)

    t = torch.from_numpy
    gang = tp.GangInputs(t(demand), t(count), t(count), None, None)
    alloc, placed = tp._fill_slab_pair(t(free), t(starts).long(), t(ends).long(), gang,
                                       t(cs_pair), t(uidx).long(), recording_fill)
    assert calls == ([] if p_dim == 1 else [False])
    np.testing.assert_array_equal(alloc.numpy(), np.stack([w[0] for w in want]))
    np.testing.assert_array_equal(placed.numpy(), np.stack([w[1] for w in want]))
    assert placed.dtype == torch.int32 and placed[2].sum() == 0 and placed[1].sum() > 0
