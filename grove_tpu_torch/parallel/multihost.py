"""Multi-process solver deployment over ``torch.distributed``.

Counterpart of ``grove_tpu/parallel/multihost.py`` (``jax.distributed``).
Every process calls :func:`initialize`, builds the same mesh
(:func:`global_solver_mesh`) and runs the sharded solve SPMD style
(``parallel/sharded.py``): the node axis is sharded over the ranks, and
every rank calls the same collectives in the same order.

The backend is chosen explicitly and printed, never by a silent fallback:
``gloo`` on the CPU; ``nccl`` when every rank has a card of its own;
``gloo`` when ranks share a card (NCCL refuses two ranks on one device),
its collectives staged through host memory.

:func:`run_ranks` spawns N local worker processes
(``python -m grove_tpu_torch.parallel.multihost``), one torch thread each,
that join one process group through a ``FileStore`` under a fresh
temporary directory (no port to collide), run jobs (:data:`JOBS`, or a
``module:function`` of the same signature) and hand their results back as
``.npz`` files; :func:`spawn_local_cluster` is the JAX module's harness on
top of it. The workers import neither JAX nor the JAX package.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from grove_tpu_torch.utils.platform import resolve_device, strict_fp32

REPO = Path(__file__).resolve().parents[2]


def choose_backend(device: torch.device, world_size: int,
                   local_world_size: Optional[int] = None) -> str:
    """``gloo`` for CPU tensors; ``nccl`` when each of the host's ranks has
    a card of its own (``device`` names no card index, and the host has at
    least as many cards as ranks; or one rank); ``gloo`` when ranks share a
    card (an explicit index with more than one rank on the host, or fewer
    cards than ranks)."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no process-group backend for {device}")
    local = local_world_size or world_size
    if local == 1:
        return "nccl"
    if device.index is None and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout: float = 120.0,
) -> dict:
    """Join the process group. Arguments default to torchrun's env
    (``MASTER_ADDR``/``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); explicit arguments
    win. ``device`` is this rank's device (default: the card, and raises
    without one; ``cuda`` with no index gives rank r the card of its local
    rank). `timeout` (seconds) bounds every collective, so a rank out of
    step raises instead of hanging. The backend is :func:`choose_backend`'s;
    prints the choice and returns {rank, world_size, backend, device,
    reason}."""
    world_size = int(world_size if world_size is not None else os.environ["WORLD_SIZE"])
    rank = int(rank if rank is not None else os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    device = resolve_device(device)
    backend = choose_backend(device, world_size, local_world)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))
    reason = ("CPU tensors" if device.type == "cpu" else
              f"ranks share {device}" if backend == "gloo" else f"a card per rank ({device})")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
    )
    print(f"[multihost] rank {rank}/{world_size}: backend {backend} ({reason}), device {device}",
          flush=True)
    return {"rank": rank, "world_size": world_size, "backend": backend, "device": device,
            "reason": reason}


def global_solver_mesh():
    """The (dp, tp) mesh over every rank of the process group — the same
    call on every rank after :func:`initialize`."""
    from grove_tpu_torch.parallel.sharded import make_solver_mesh

    return make_solver_mesh(dist.get_world_size())


# ---------------------------------------------------------------------------
# jobs a spawned rank runs (every rank of the group runs the same list)
# ---------------------------------------------------------------------------


def _job_stress(device, n_nodes, n_gangs, chunk_size=128, max_waves=32, seed=0, warmup=False):
    """``solve_stress_sharded`` of ``build_stress_problem(n_nodes,
    n_gangs)`` over the 1-axis node mesh (after one untimed solve with
    `warmup`), with its wall time, the fill
    launches on this rank, the collectives it called, the group's backend,
    and the kernel sources this process compiled (0: it loaded the builds
    it found)."""
    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.ops import _build
    from grove_tpu_torch.ops.fill import fill_batch
    from grove_tpu_torch.parallel.sharded import make_node_mesh, solve_stress_sharded

    problem = build_stress_problem(n_nodes, n_gangs, seed=seed)
    mesh = make_node_mesh()
    if warmup:
        solve_stress_sharded(mesh, problem, chunk_size=chunk_size, max_waves=max_waves,
                             device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    fill_batch.launches = 0
    t0 = time.perf_counter()
    out = solve_stress_sharded(mesh, problem, chunk_size=chunk_size, max_waves=max_waves,
                               device=device)
    out["seconds"] = time.perf_counter() - t0
    out["fill_launches"] = fill_batch.launches
    out["backend"] = dist.get_backend()
    out["compiled_kernels"] = len(_build.BUILD_LOGS)
    return out


def _job_ring(device, n_nodes, n_gangs, gang=0, seed=0):
    """``domain_aggregates_ring`` for one gang of the stress problem."""
    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.parallel.ring import domain_aggregates_ring
    from grove_tpu_torch.parallel.sharded import make_node_mesh

    p = build_stress_problem(n_nodes, n_gangs, seed=seed)
    K, free_agg = domain_aggregates_ring(make_node_mesh(), p.capacity, p.topo, p.seg_starts,
                                         p.seg_ends, p.demand[gang], p.count[gang], device=device)
    return {"K": K, "free_agg": free_agg}


def _job_batch(device, n_scenarios, n_nodes=32, n_gangs=16):
    """``batch_solve_sharded`` on ``make_example_batch`` over the (dp, tp)
    solver mesh, with the exact kernel's launches during it."""
    from grove_tpu_torch.ops.exact import exact_scan
    from grove_tpu_torch.parallel.sharded import (
        batch_solve_sharded,
        make_example_batch,
        make_solver_mesh,
    )

    mesh = make_solver_mesh()
    batch = make_example_batch(n_scenarios, n_nodes, n_gangs)
    exact_scan.launches = 0
    out = batch_solve_sharded(mesh, *batch, device=device)
    out["exact_launches"] = exact_scan.launches
    out["mesh"] = np.asarray(mesh.mesh.shape)
    return out


def _job_fill(device):
    """The sharded fill and slab fill on ``sharded.fill_cases()``: this
    rank's columns of each result."""
    from grove_tpu_torch.parallel.sharded import fill_cases, run_fill_case, node_axis_of

    out = {}
    for name, case in fill_cases().items():
        axis = node_axis_of(case["n"])
        for key, value in run_fill_case(case, axis, device).items():
            out[f"{name}/{key}"] = value
    return out


def _gather_ranks(device) -> torch.Tensor:
    """``[size, 4]`` on the CPU: every rank's ``rank + 1``, gathered from a
    tensor on ``device`` (NCCL takes tensors on the card only; gloo's are
    staged through host memory)."""
    from grove_tpu_torch.ops.nodeaxis import all_gather_stack

    x = torch.full((4,), dist.get_rank() + 1, dtype=torch.int32, device=device)
    return all_gather_stack(x, None, dist.get_backend() == "gloo").cpu()


def _job_cluster(device, n_nodes=0, n_gangs=0):
    """The JAX module's worker: the global mesh over every rank, one
    cross-process collective, then the node-sharded stress solve held bit
    for bit to this rank's own single-device solve."""
    from grove_tpu_torch.models.scenarios import build_stress_problem
    from grove_tpu_torch.parallel.sharded import solve_stress_sharded, solve_stress_single

    size = dist.get_world_size()
    mesh = global_solver_mesh()
    assert mesh.mesh.numel() == size, mesh
    parts = _gather_ranks(device)
    assert parts[:, 0].tolist() == list(range(1, size + 1)), parts
    problem = build_stress_problem(n_nodes or 16 * size, n_gangs or 32)
    sharded = solve_stress_sharded(mesh, problem, chunk_size=16, max_waves=8, device=device)
    local = solve_stress_single(problem, chunk_size=16, max_waves=8, device=device)
    assert sharded["admitted"].any(), "cross-process solve placed nothing"
    for key in ("admitted", "placed", "score", "chosen_level", "free_after", "pending", "waves"):
        np.testing.assert_array_equal(sharded[key], local[key], err_msg=key)
    print("MULTIHOST_OK", tuple(mesh.mesh.shape), int(sharded["admitted"].sum()), "/",
          len(sharded["admitted"]), flush=True)
    return {"ok": True}


JOBS = {
    "stress": _job_stress,
    "ring": _job_ring,
    "batch": _job_batch,
    "fill": _job_fill,
    "cluster": _job_cluster,
}


def _job(name: str):
    """A job of :data:`JOBS`, or the function a ``module:function`` names."""
    if name in JOBS:
        return JOBS[name]
    module, _, fn = name.partition(":")
    return getattr(importlib.import_module(module), fn)


def _worker(spec_path: str) -> int:
    spec = json.loads(Path(spec_path).read_text())
    rank = int(os.environ["GROVE_RANK"])
    torch.set_num_threads(1)
    initialize(spec["init_method"], spec["world_size"], rank, spec["device"], spec["pg_timeout"])
    strict_fp32()
    results = {}
    try:
        for label, name, params in spec["jobs"]:
            for key, value in _job(name)(_rank_device(spec["device"]), **params).items():
                results[f"{label}/{key}"] = np.asarray(value)
        results["worker/blocked_modules"] = np.asarray(sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "grove_tpu")
        ), dtype=str)
        np.savez(Path(spec["out_dir"]) / f"rank{rank}.npz", **results)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _rank_device(device: str) -> torch.device:
    """The device a rank computes on: ``device``, or its local card for a
    bare ``cuda``."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def run_ranks(
    jobs: Sequence, world_size: int, device=None, timeout: float = 300.0,
    pg_timeout: float = 120.0,
) -> List[Dict[str, Dict[str, np.ndarray]]]:
    """Spawn `world_size` local ranks that run ``jobs`` (a list of ``(name,
    params)``, or ``(label, name, params)``; a name is a key of
    :data:`JOBS` or a ``module:function``) in order, SPMD, on ``device``
    (default: the card; raises without one). Each rank joins the group
    through a ``FileStore`` in a fresh temporary directory, with ``pg_timeout``
    seconds per collective and one torch thread. Returns one dict
    per rank: job label (default its name) → {result key → numpy array}. Raises
    ``RuntimeError`` (with the ranks' output) when a rank fails or the
    ranks are not done within ``timeout`` seconds; every rank still running
    is killed."""
    device = str(resolve_device(device))
    tmp = Path(tempfile.mkdtemp(prefix="grove-ranks-"))
    spec = {
        "init_method": f"file://{tmp / 'store'}", "world_size": world_size, "device": device,
        "pg_timeout": pg_timeout, "out_dir": str(tmp),
        "jobs": [list(job) if len(job) == 3 else [job[0], *job] for job in jobs],
    }
    (tmp / "spec.json").write_text(json.dumps(spec))
    env = dict(os.environ)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + paths)
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world_size):
            log = open(tmp / f"rank{rank}.log", "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "grove_tpu_torch.parallel.multihost",
                 str(tmp / "spec.json")],
                env={**env, "GROVE_RANK": str(rank)}, cwd=str(REPO), stdout=log,
                stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + timeout
        failed = []
        for rank, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} still running after {timeout} s")
                break
            if proc.returncode != 0:
                failed.append(f"rank {rank} exited {proc.returncode}")
                break
        if failed:
            raise RuntimeError("; ".join(failed) + "\n" + _tails(logs))
        results = []
        for rank in range(world_size):
            with np.load(tmp / f"rank{rank}.npz") as data:
                per_job: Dict[str, Dict[str, np.ndarray]] = {}
                for key in data.files:
                    job, _, name = key.partition("/")
                    per_job.setdefault(job, {})[name] = data[key]
            results.append(per_job)
        return results
    finally:
        # never leak a rank: a hung peer would hold its collective forever
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _tails(logs, limit: int = 4000) -> str:
    out = []
    for rank, log in enumerate(logs):
        log.flush()
        log.seek(0)
        text = log.read()
        out.append(f"--- rank {rank} ---\n{text[-limit:]}")
    return "\n".join(out)


def spawn_local_cluster(
    num_processes: int = 2,
    n_nodes: int = 0,
    n_gangs: int = 0,
    timeout: float = 120.0,
    device=None,
) -> bool:
    """Spawn ``num_processes`` local ranks that form one process group on
    ``device`` (default: the card; raises without one); each asserts the
    global mesh, one cross-process collective, and a node-sharded stress
    solve bit-equal to its own single-device solve (``n_nodes``/``n_gangs``
    override the tiny default shape). True when every rank passes; False
    (with the ranks' output printed) when one fails or the ranks run past
    ``timeout``."""
    device = resolve_device(device)
    try:
        ranks = run_ranks([("cluster", {"n_nodes": n_nodes, "n_gangs": n_gangs})],
                          num_processes, device=device, timeout=timeout,
                          pg_timeout=min(timeout, 120.0))
    except RuntimeError as err:
        print(err)
        return False
    return all(bool(r["cluster"]["ok"]) for r in ranks)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
