"""The exact sequential greedy as one hand-written Hopper kernel, and its plain version.

Replaces the XLA program ``grove_tpu/ops/packing.py::solve_packing``: its
``lax.scan`` over the gangs (``:897``), whose step is
``gang_select_and_fill``, for every flag set (per-group packs, recovery
pins, spreads). ``exact_scan`` launches ``csrc/exact.cu`` for CUDA tensors,
one thread block per problem walking its G gangs in order with the
capacity in shared memory, and runs ``exact_scan_ref``
(``ops.packing.solve_packing``'s host loop with the plain fill, problem by
problem) for CPU tensors; a build or launch failure raises (no fallback).

Every array carries a leading batch axis B of independent problems (B = 1
from ``solver.kernel.solve``, the scenarios of
``parallel.sharded.batch_solve_sharded``). The results are the host loop's,
bit for bit, under the contract ``check_inputs`` states and while the float
sums are exact (the kernel chains them in order, see ``csrc/exact.cu``):
the CPU tests (``tests/test_torch_exact_scan.py``) hold the kernel's order
of work, written there as a numpy model, to the JAX package, and the card
tests hold the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.ops.fill import _scan_segments, fill_batch_ref
from grove_tpu_torch.ops.packing import _level_weights, solve_packing

THREADS = 512  # threads of the block per problem (csrc/exact.cu's kThreads)
# dynamic shared memory a block may opt into (227 KB) less the kernel's
# static shared memory (under 1 KB) and a margin
_MAX_SMEM = 227 * 1024 - 2 * 1024
# a problem's arrays, in the order of csrc/exact.cu's Layout
ARRAYS = ("capacity", "work", "cs_k", "cs_free", "pods", "gk", "tk", "kq", "load")
# the constraint arrays after the nine of every problem, in argument order
CONSTRAINTS = ("group_req", "group_pin", "gang_pin", "spread_level", "spread_min",
               "spread_required", "spread_seed")


def _align(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def launch_plan(n: int, p: int, r: int, d: int = 1, grouped: bool = False,
                spread: bool = False) -> dict:
    """Where the kernel keeps a problem's arrays. ``small``: the gang's
    demands, the joint floor less its tolerance, the scan's segment
    offsets, a zero row, the counts, floors, a fill's counts, the groups'
    placed counts and placed floors, the signed-zero flags and each group's
    mask, always in shared memory. ``big``: capacity ``[N,R]`` f32, the
    working capacity of a candidate ``[N,R]`` f32, the capped-fit prefix
    tables ``[P,N+1]`` i32, the capacity prefix ``[N+1,R]`` f32 and the pods
    per node ``[N+1]`` i32, all in shared memory when they fit beside
    ``small``, else all in a global scratch buffer of ``scratch`` bytes per
    problem (L2-resident at the sizes the solver meets); then the arrays a
    flag needs, each in shared memory while it fits, else in scratch: for
    spreads the quota ``kq [D]`` and the load ``load [D]``, which every
    step of their bisections reads, then the fill's prefix table
    ``gk [N+1]`` (group packs and spreads) and for spreads the take prefix
    ``tk [N+1]``. Returns ``{"threads", "small", "big", "use_smem", "smem",
    "scratch", "offsets", "sizes", "smem_mask"}``: ``use_smem`` for the
    first five, ``offsets`` and ``sizes`` the bytes of each of ``ARRAYS``
    (in shared memory where its bit of ``smem_mask`` is set, else in the
    problem's scratch; a size 0 where the flags need no such array)."""
    small = _align(4 * (p * r + 9 * p + 67 * r))
    sizes = dict(capacity=_align(4 * n * r), work=_align(4 * n * r),
                 cs_k=_align(4 * p * (n + 1)), cs_free=_align(4 * (n + 1) * r),
                 pods=_align(4 * (n + 1)),
                 gk=_align(4 * (n + 1)) if grouped or spread else 0,
                 kq=_align(4 * d) if spread else 0, load=_align(4 * d) if spread else 0,
                 tk=_align(4 * (n + 1)) if spread else 0)
    core = ARRAYS[:5]
    use_smem = small + sum(sizes[a] for a in core) <= _MAX_SMEM
    offsets, mask = {}, 0
    smem, scratch = small, 0
    for name in core + ("kq", "load", "gk", "tk"):
        if (use_smem if name in core else smem + sizes[name] <= _MAX_SMEM):
            offsets[name], smem = smem, smem + sizes[name]
            mask |= 1 << ARRAYS.index(name)
        else:
            offsets[name], scratch = scratch, scratch + sizes[name]
    return {
        "threads": THREADS,
        "small": small,
        "big": sum(sizes.values()),
        "use_smem": use_smem,
        "smem": smem,
        "scratch": scratch,
        "offsets": tuple(offsets[a] for a in ARRAYS),
        "sizes": tuple(sizes[a] for a in ARRAYS),
        "smem_mask": mask,
    }


def slab_levels(topo: torch.Tensor, seg_starts: torch.Tensor, seg_ends: torch.Tensor):
    """``[B, L]`` uint8: 1 where every domain of the level is the contiguous
    node range its boundary tables give (node n's id d lies in ``[0, D)``
    with ``starts[d] <= n < ends[d]``, and each range holds exactly the
    nodes of its id), so the mask ``topo[:, l] == best`` of a level fill is
    that range. The encoder's topology-sorted nodes give 1 everywhere; the
    kernel scans the whole node axis against ``topo`` where a level has 0.
    Device tensors in, a device tensor out (no host read)."""
    b, n, n_levels = topo.shape
    d = seg_starts.shape[-1]
    ids = topo.transpose(1, 2).long()  # [B, L, N]
    valid = (ids >= 0) & (ids < d)
    safe = ids.clamp(0, max(d - 1, 0))
    starts, ends = seg_starts.long(), seg_ends.long()
    node = torch.arange(n, device=topo.device)
    inside = valid & (starts.gather(2, safe) <= node) & (node < ends.gather(2, safe))
    counts = torch.zeros((b, n_levels, d), dtype=torch.long, device=topo.device)
    counts.scatter_add_(2, safe, valid.long())
    spans = (ends - starts).clamp(min=0)
    return (inside.all(2) & (counts == spans).all(2)).to(torch.uint8)


def check_inputs(count: np.ndarray, min_count: np.ndarray, pref_level: np.ndarray,
                 demand: np.ndarray, n_levels: int, group_req: Optional[np.ndarray] = None,
                 spread_level: Optional[np.ndarray] = None,
                 spread_seed: Optional[np.ndarray] = None, n_domains: int = 0) -> None:
    """The kernel's input contract, checked on the host arrays before the
    upload (the encoder's problems always meet it): counts and floors >= 0,
    preferred levels, group packs and spread levels in [-1, L), finite
    demands, and survivor seeds >= 0 of width 0 or D (``n_domains``).
    Raises ``ValueError``."""
    if (count < 0).any() or (min_count < 0).any():
        raise ValueError("exact_scan: counts and floors must be >= 0")
    for name, levels in (("preferred levels", pref_level), ("group packs", group_req),
                         ("spread levels", spread_level)):
        if levels is not None and ((levels < -1) | (levels >= n_levels)).any():
            raise ValueError(f"exact_scan: {name} must lie in [-1, {n_levels})")
    if not np.isfinite(demand).all():
        raise ValueError("exact_scan: demands must be finite")
    if spread_seed is not None:
        if spread_seed.shape[-1] not in (0, n_domains):
            raise ValueError(f"exact_scan: survivor seeds of width {spread_seed.shape[-1]};"
                             f" the kernel takes 0 or {n_domains}")
        if (spread_seed < 0).any():
            raise ValueError("exact_scan: survivor seeds must be >= 0")


def exact_scan_ref(capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
                   pref_level, group_req=None, group_pin=None, gang_pin=None, spread_level=None,
                   spread_min=None, spread_required=None, spread_seed=None,
                   with_alloc: bool = True, grouped: bool = False, pinned: bool = False,
                   spread: bool = False, uniform: bool = False,
                   level_widths: Optional[tuple] = None) -> dict:
    """Plain PyTorch version: ``ops.packing.solve_packing`` with the plain
    fill (``fill_batch_ref``) for each problem of the batch, the results
    stacked. Same arguments and results as :func:`exact_scan`."""
    constraints = (group_req, group_pin, gang_pin, spread_level, spread_min, spread_required,
                   spread_seed)
    outs = [
        solve_packing(
            capacity[i], topo[i], seg_starts[i], seg_ends[i], demand[i], count[i],
            min_count[i], req_level[i], pref_level[i],
            *(None if t is None else t[i] for t in constraints),
            with_alloc=with_alloc, grouped=grouped, pinned=pinned, spread=spread,
            uniform=uniform, level_widths=level_widths, fill=fill_batch_ref,
        )
        for i in range(capacity.shape[0])
    ]
    return {
        key: None if outs[0][key] is None else torch.stack([o[key] for o in outs])
        for key in ("admitted", "placed", "score", "chosen_level", "alloc", "free_after")
    }


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"exact_scan: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"exact_scan: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"exact_scan: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"exact_scan: {name} must be contiguous")


_ARGTYPES = (
    [ctypes.c_void_p] * 16 + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)]
    + [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 16
    + [ctypes.c_longlong, ctypes.c_void_p]
)
MAX_LEVELS = 16  # csrc/exact.cu's kMaxLevels


def _kernel():
    lib = _build.load("exact")
    fn = lib.grove_exact_scan
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.grove_exact_error_string.argtypes = [ctypes.c_int]
        lib.grove_exact_error_string.restype = ctypes.c_char_p
    return lib, fn


def pack_args(capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
              pref_level, group_req=None, group_pin=None, gang_pin=None, spread_level=None,
              spread_min=None, spread_required=None, spread_seed=None, level_widths=None):
    """The kernel's inputs: on the problem's device, the batch arrays as the
    kernel takes them (int32 tables and constraints, spread_required as
    uint8, contiguous; a constraint left None stays None) and the slab flags
    ``[B,L]`` u8 (:func:`slab_levels`); on the host, the level widths (the
    padded width D where ``level_widths`` is None) and the level weights
    (``ops.packing._level_weights``, float32 values), which the launch
    passes by value, and the scan's segment count S. Builds nothing on the
    device from host data, so nothing waits for the card. Returns a dict."""
    n_levels, d = seg_starts.shape[-2:]
    widths = tuple(level_widths) if level_widths is not None else (d,) * n_levels
    if len(widths) != n_levels or any(not 0 <= w <= d for w in widths):
        raise ValueError(f"exact_scan: level widths {widths} do not fit {n_levels} levels of {d}")
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"exact_scan: {n_levels} levels; the kernel takes 1 to {MAX_LEVELS}")
    as_i32 = lambda t: None if t is None else t.to(torch.int32).contiguous()  # noqa: E731
    constraints = dict(zip(CONSTRAINTS, (group_req, group_pin, gang_pin, spread_level,
                                         spread_min, spread_required, spread_seed)))
    args = {name: as_i32(t) for name, t in constraints.items()}
    if spread_required is not None:
        args["spread_required"] = spread_required.to(torch.uint8).contiguous()
    return {
        "capacity": capacity.contiguous(), "topo": as_i32(topo),
        "seg_starts": as_i32(seg_starts), "seg_ends": as_i32(seg_ends),
        "demand": demand.contiguous(), "count": as_i32(count), "min_count": as_i32(min_count),
        "req_level": as_i32(req_level), "pref_level": as_i32(pref_level), **args,
        "widths": widths,
        "weights": tuple(_level_weights(n_levels, "cpu").tolist()),
        "slab": slab_levels(topo, seg_starts, seg_ends).contiguous(),
        "segments": _scan_segments(capacity.shape[1]),
    }


def _exact_scan_cuda(args, with_alloc, grouped, pinned, spread, uniform):
    device = args["demand"].device
    b, g, p_dim, r = args["demand"].shape
    n = args["capacity"].shape[1]
    n_levels, d = args["seg_starts"].shape[-2:]
    seed = args["spread_seed"]
    seed_width = 0 if seed is None else seed.shape[-1]
    for name, dtype, shape in (
        ("capacity", torch.float32, (b, n, r)), ("topo", torch.int32, (b, n, n_levels)),
        ("seg_starts", torch.int32, (b, n_levels, d)), ("seg_ends", torch.int32, (b, n_levels, d)),
        ("demand", torch.float32, (b, g, p_dim, r)), ("count", torch.int32, (b, g, p_dim)),
        ("min_count", torch.int32, (b, g, p_dim)), ("req_level", torch.int32, (b, g)),
        ("pref_level", torch.int32, (b, g)), ("slab", torch.uint8, (b, n_levels)),
        ("group_req", torch.int32, (b, g, p_dim)), ("group_pin", torch.int32, (b, g, p_dim)),
        ("gang_pin", torch.int32, (b, g)), ("spread_level", torch.int32, (b, g)),
        ("spread_min", torch.int32, (b, g)), ("spread_required", torch.uint8, (b, g)),
        ("spread_seed", torch.int32, (b, g, seed_width)),
    ):
        if args[name] is not None:
            _check(name, args[name], dtype, shape, device)
    if seed_width not in (0, d):
        raise ValueError(f"exact_scan: survivor seeds of width {seed_width}; the kernel takes"
                         f" 0 or {d}")
    plan = launch_plan(n, p_dim, r, d, grouped, spread)
    admitted = torch.empty((b, g), dtype=torch.uint8, device=device)
    placed = torch.empty((b, g, p_dim), dtype=torch.int32, device=device)
    score = torch.empty((b, g), dtype=torch.float32, device=device)
    chosen = torch.empty((b, g), dtype=torch.int32, device=device)
    free_after = torch.empty((b, n, r), dtype=torch.float32, device=device)
    # the kernel writes an admitted gang's takes only
    alloc = torch.zeros((b, g, p_dim, n), dtype=torch.int32, device=device) if with_alloc else None
    scratch = (torch.empty((b * plan["scratch"],), dtype=torch.uint8, device=device)
               if plan["scratch"] else None)
    lib, fn = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            *(ptr(args[k]) for k in ("capacity", "topo", "seg_starts", "seg_ends", "demand",
                                     "count", "min_count", "req_level", "pref_level")
              + CONSTRAINTS),
            (ctypes.c_int * n_levels)(*args["widths"]),
            (ctypes.c_float * n_levels)(*args["weights"]),
            ptr(args["slab"]), ptr(admitted), ptr(placed), ptr(score), ptr(chosen),
            ptr(free_after), ptr(alloc), ptr(scratch),
            (ctypes.c_longlong * len(ARRAYS))(*plan["offsets"]), plan["smem_mask"],
            b, g, p_dim, n, r, n_levels, d, args["segments"], seed_width, int(grouped),
            int(pinned), int(spread), int(uniform), plan["threads"], plan["smem"],
            plan["scratch"], stream,
        )
    if err != 0:
        raise RuntimeError(
            "exact_scan kernel launch failed: " + lib.grove_exact_error_string(err).decode()
        )
    exact_scan.launches += 1
    return {"admitted": admitted.view(torch.bool), "placed": placed, "score": score,
            "chosen_level": chosen, "alloc": alloc, "free_after": free_after}


def exact_scan(capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
               pref_level, group_req=None, group_pin=None, gang_pin=None, spread_level=None,
               spread_min=None, spread_required=None, spread_seed=None,
               with_alloc: bool = True, grouped: bool = False, pinned: bool = False,
               spread: bool = False, uniform: bool = False,
               level_widths: Optional[tuple] = None) -> dict:
    """The exact sequential greedy of B independent problems on the
    tensors' device: the CUDA kernel (one launch) for CUDA tensors,
    :func:`exact_scan_ref` for CPU tensors.

    ``capacity [B,N,R]`` f32, ``topo [B,N,L]``, ``seg_starts`` /
    ``seg_ends [B,L,D]``, ``demand [B,G,P,R]`` f32, ``count`` /
    ``min_count [B,G,P]``, ``req_level`` / ``pref_level [B,G]``; the
    constraints ``group_req`` / ``group_pin [B,G,P]``, ``gang_pin``,
    ``spread_level``, ``spread_min``, ``spread_required [B,G]`` and
    ``spread_seed [B,G,D]`` (or the ``[B,G,0]`` placeholder), each None for
    none (integer tensors of any width, bool for ``spread_required``); the
    flags ``grouped``, ``pinned``, ``spread``, ``uniform`` and
    ``level_widths`` as in ``ops.packing.solve_packing``. Returns a dict of
    ``admitted [B,G]`` bool, ``placed [B,G,P]`` i32, ``score [B,G]`` f32,
    ``chosen_level [B,G]`` i32, ``alloc [B,G,P,N]`` i32 (None without
    `with_alloc`) and ``free_after [B,N,R]`` f32."""
    arrays = (capacity, topo, seg_starts, seg_ends, demand, count, min_count, req_level,
              pref_level, group_req, group_pin, gang_pin, spread_level, spread_min,
              spread_required, spread_seed)
    flags = dict(grouped=grouped, pinned=pinned, spread=spread, uniform=uniform)
    if demand.device.type == "cpu":
        return exact_scan_ref(*arrays, with_alloc=with_alloc, level_widths=level_widths, **flags)
    if demand.device.type != "cuda":
        raise ValueError(f"exact_scan: unsupported device {demand.device}")
    return _exact_scan_cuda(pack_args(*arrays, level_widths=level_widths), with_alloc, **flags)


# kernel launches since the last reset (the plain CPU path never counts)
exact_scan.launches = 0
