"""The batched gang fill: a hand-written Hopper kernel and its plain version.

Replaces the TPU kernel ``grove_tpu/ops/pallas_fill.py::pallas_fill_batch``
(``_fill_kernel``), whose function is ``grove_tpu/ops/packing.py::_fill``,
batched over a chunk of C gangs. ``fill_batch`` launches
``csrc/fill.cu`` for CUDA tensors and runs ``fill_batch_ref`` for CPU
tensors; a build or launch failure raises (no fallback). Both return
``(alloc [C,P,N] i32, placed [C,P] i32, free_after [C,N,R] f32)`` — the
Pallas kernel has no ``free_after``, the port chains fills through it; a
caller that does not chain passes ``with_free_after=False`` and gets None
(the kernel then writes nothing there). The kernel runs one thread-block
cluster per gang; ``_launch_shape`` picks its size.

This module also holds the two primitives the fill shares with
``ops.packing``: the capped per-node fit count and the fixed-association
prefix sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from grove_tpu_torch.ops import _build

_INT_CAP = 1 << 20  # cap on pods-per-node fit counts (avoid inf→int wrap)

# Segment count of the fixed-association prefix sums (the JAX package picks
# 64 so every mesh shard owns whole segments).
_SCAN_SEGMENTS = 64


def _scan_segments(n: int) -> int:
    """Segment count S of the fixed-association prefix sum over an axis of
    n: the largest power of two ≤ 64 dividing n (1: a plain scan)."""
    s = _SCAN_SEGMENTS
    while s > 1 and n % s:
        s //= 2
    return s


def _segment_scan(parts: torch.Tensor):
    """(inclusive prefix inside each segment, segment totals) of ``parts
    [..., S, n/S]``."""
    # a one-element segment is its own prefix; skipping the scan matters
    # on CUDA: scanning the commit's [N, R, 32, 1] rows took ~0.6 ms a
    # call on an H100 (scripts/torch_solve_profile.py)
    local = parts if parts.shape[-1] == 1 else torch.cumsum(parts, -1, dtype=parts.dtype)
    return local, parts.sum(-1, dtype=parts.dtype)


def _segment_offsets(totals: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix of the segment totals ``[..., S]``: the same
    strictly-upper-triangular product as
    ``grove_tpu/ops/packing.py::_seg_cumsum`` for floats; for integers an
    exclusive cumsum (integer matmul has no CUDA kernel, and integers are
    exact under any association)."""
    if totals.dtype.is_floating_point:
        s = totals.shape[-1]
        tri = torch.triu(torch.ones((s, s), dtype=totals.dtype, device=totals.device), diagonal=1)
        return totals @ tri
    return torch.cumsum(totals, -1, dtype=totals.dtype) - totals


def _seg_cumsum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum with the JAX package's association: the axis is
    cut into S ≤ 64 equal segments (``_scan_segments``), each is scanned
    locally, and the segment offsets come from the segment totals
    (``_segment_offsets``). Integer inputs are exact under any association
    (and wrap like int32). ``ops/nodeaxis.py`` computes the same bits
    with the node axis sharded."""
    a = a.movedim(dim, -1)
    n = a.shape[-1]
    s = _scan_segments(n)
    if s <= 1:
        out = torch.cumsum(a, -1, dtype=a.dtype)
    else:
        local, totals = _segment_scan(a.reshape(a.shape[:-1] + (s, n // s)))
        out = (local + _segment_offsets(totals).unsqueeze(-1)).reshape(a.shape)
    return out.movedim(-1, dim)


def _pods_fit_per_node(free: torch.Tensor, demand: torch.Tensor) -> torch.Tensor:
    """k[..., n] = pods of one group that fit on node n: ``free [..., N, R]``
    against ``demand [..., R]`` (broadcast), min over resources with demand
    > 0 of floor(free / demand), clipped to [0, _INT_CAP] before the int32
    cast (``inf`` for all-zero demand)."""
    positive = demand > 0
    safe = torch.where(positive, demand, torch.ones_like(demand))
    ratio = torch.floor(free / safe.unsqueeze(-2))
    ratio = torch.where(positive.unsqueeze(-2), ratio, torch.inf)
    k = ratio.amin(-1)
    return k.clamp(0, _INT_CAP).to(torch.int32)


def fill_batch_ref(free, mask, demand, count, with_free_after=True):
    """Plain PyTorch fill of C gangs: ``free`` shared ``[N,R]`` or per-gang
    ``[C,N,R]``, ``mask [C,N]`` bool, ``demand [C,P,R]`` f32, ``count
    [C,P]`` i32. Each group in order takes pods node by node inside the
    mask (exclusive prefix of capped fits) and debits free. With
    ``with_free_after=False`` the third result is None."""
    c, p_dim, r = demand.shape
    n = mask.shape[-1]
    free_c = free.expand(c, n, r) if free.dim() == 2 else free
    mask = mask.to(torch.bool)
    allocs, placed = [], []
    for p in range(p_dim):
        d = demand[:, p]  # [C, R]
        cnt = count[:, p : p + 1]  # [C, 1]
        k = _pods_fit_per_node(free_c, d)  # [C, N]
        # cap at the group's own count: bounds the int32 prefix sum below
        # at count*N (a zero-demand group would otherwise contribute
        # _INT_CAP per node and wrap it negative)
        k = torch.minimum(torch.where(mask, k, 0), cnt)
        cum = _seg_cumsum(k) - k  # exclusive prefix
        take = torch.minimum(torch.clamp(cnt - cum, min=0), k)
        free_c = free_c - take.unsqueeze(-1).to(free_c.dtype) * d.unsqueeze(1)
        allocs.append(take)
        placed.append(take.sum(-1, dtype=torch.int32))
    free_after = free_c.contiguous() if with_free_after else None
    return torch.stack(allocs, 1), torch.stack(placed, 1), free_after


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"fill_batch: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fill_batch: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fill_batch: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"fill_batch: {name} must be contiguous")


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong]
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 7
    + [ctypes.c_void_p]
)

# Launch shape of the kernel (csrc/fill.cu): one cluster of K CTAs per gang.
_SMS = 132  # streaming multiprocessors of an H100 (and an H200)
_CTAS_PER_SM = 2  # CTAs of one launch an SM takes at once
_MAX_CLUSTER = 8  # the largest portable cluster size
# dynamic shared memory a CTA may opt into (227 KB), less the kernel's
# static shared memory (at most 4 KB) and a margin
_MAX_SMEM = 227 * 1024 - 5 * 1024
_NODES_PER_THREAD = 2
_MAX_RUN = 16  # nodes per thread the kernel is built for


@functools.lru_cache(maxsize=1024)
def _launch_shape(c, p, n, r, sms=_SMS):
    """(cluster size K, threads per CTA, slice, shared bytes per CTA) of the
    fill kernel for C gangs of P groups over N nodes and R resources. K is
    the largest of 1, 2, 4, 8 with C*K CTAs still running at once, two to
    an SM (one wave of CTAs, each gang's prefix spread over K CTAs), raised
    where a CTA's slice (a multiple of 4 nodes) would need more than 16
    nodes per thread or more shared memory than a CTA has; a thread owns
    about 2 nodes. Raises ``ValueError`` when even K=8 does not do."""
    k = 1
    while k < _MAX_CLUSTER and 2 * k * c <= _CTAS_PER_SM * sms:
        k *= 2
    while True:
        per_cta = -(-n // k)
        slice_ = -(-per_cta // 4) * 4
        smem = slice_ * (4 * r + 1) + p * (48 + 4 * r)
        if smem <= _MAX_SMEM and slice_ <= 1024 * _MAX_RUN:
            break
        if k == _MAX_CLUSTER:
            raise ValueError(
                f"fill_batch: N={n} nodes with R={r} resources and P={p} groups need"
                f" {smem} bytes of shared memory and {-(-slice_ // 1024)} nodes per"
                f" thread per CTA even at {k} CTAs per gang; the CUDA kernel takes at"
                f" most {_MAX_SMEM} bytes and {_MAX_RUN} nodes per thread"
            )
        k *= 2
    threads = min(1024, max(32, -(-slice_ // (32 * _NODES_PER_THREAD)) * 32))
    return k, threads, slice_, smem


_SM_COUNTS = {}


def _sm_count(device):
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SM_COUNTS:
        _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNTS[index]


def _kernel():
    lib = _build.load("fill")
    fn = lib.grove_fill_batch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.grove_cuda_error_string.argtypes = [ctypes.c_int]
        lib.grove_cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def _fill_batch_cuda(free, mask, demand, count, with_free_after):
    c, p_dim, r = demand.shape
    n = mask.shape[-1]
    device = demand.device
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    shared = free.dim() == 2
    _check("free", free, torch.float32, (n, r) if shared else (c, n, r), device)
    _check("mask", mask, torch.uint8, (c, n), device)
    _check("demand", demand, torch.float32, (c, p_dim, r), device)
    _check("count", count, torch.int32, (c, p_dim), device)
    cluster, threads, slice_, _ = _launch_shape(c, p_dim, n, r, _sm_count(device))
    alloc = torch.empty((c, p_dim, n), dtype=torch.int32, device=device)
    placed = torch.empty((c, p_dim), dtype=torch.int32, device=device)
    free_after = (
        torch.empty((c, n, r), dtype=torch.float32, device=device) if with_free_after else None
    )
    lib, fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            free.data_ptr(), 0 if shared else n * r,
            mask.data_ptr(), demand.data_ptr(), count.data_ptr(),
            alloc.data_ptr(), placed.data_ptr(),
            free_after.data_ptr() if with_free_after else None,
            c, p_dim, n, r, cluster, threads, slice_, stream,
        )
    if err != 0:
        raise RuntimeError(
            "fill_batch kernel launch failed: "
            + lib.grove_cuda_error_string(err).decode()
        )
    fill_batch.launches += 1
    fill_batch.rows += c
    return alloc, placed, free_after


@torch.library.custom_op("grove_tpu_torch::fill_batch", mutates_args=())
def _fill_op(
    free: torch.Tensor,
    mask: torch.Tensor,
    demand: torch.Tensor,
    count: torch.Tensor,
    with_free_after: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fill_batch`` as an operator, so that ``torch.func.vmap`` reaches it
    through :func:`_fill_vmap` (vmap cannot trace the kernel's ctypes
    launch). Without ``free_after`` its third result is an empty tensor."""
    if demand.device.type == "cuda":
        alloc, placed, free_after = _fill_batch_cuda(free, mask, demand, count, with_free_after)
    else:
        alloc, placed, free_after = fill_batch_ref(free, mask, demand, count, with_free_after)
    if free_after is None:
        free_after = demand.new_empty((0,))
    return alloc, placed, free_after


def _lane_first(t, dim, b):
    """`t` with the vmapped lane axis first: moved there, or broadcast to
    `b` lanes where `t` is shared by every lane (``dim`` None)."""
    return t.expand((b,) + t.shape) if dim is None else t.movedim(dim, 0)


@_fill_op.register_vmap
def _fill_vmap(info, in_dims, free, mask, demand, count, with_free_after):
    """The fill over B lanes of C gangs is one fill of B·C gangs: the lane
    axis folds into the gang axis (mask ``[B,C,N]`` → ``[B·C,N]``, demand
    ``[B,C,P,R]`` → ``[B·C,P,R]``, count ``[B,C,P]`` → ``[B·C,P]``), so one
    launch serves every lane. A capacity snapshot ``[N,R]`` per lane is
    expanded to one row per gang, ``[B·C,N,R]`` (the kernel takes a row
    stride of 0 or N·R only); one shared by every lane stays shared."""
    b = info.batch_size
    free_dim, mask_dim, demand_dim, count_dim, _ = in_dims
    demand = _lane_first(demand, demand_dim, b)
    _, c, p_dim, r = demand.shape
    mask = _lane_first(mask, mask_dim, b)
    n = mask.shape[-1]
    rows = b * c
    if free_dim is not None or free.dim() == 3:
        free = _lane_first(free, free_dim, b)
        if free.dim() == 3:  # one [N,R] snapshot per lane
            free = free.unsqueeze(1).expand(b, c, n, r)
        free = free.reshape(rows, n, r).contiguous()
    alloc, placed, free_after = _fill_op(
        free,
        mask.reshape(rows, n).contiguous(),
        demand.reshape(rows, p_dim, r).contiguous(),
        _lane_first(count, count_dim, b).reshape(rows, p_dim).contiguous(),
        with_free_after,
    )
    alloc = alloc.view(b, c, p_dim, n)
    placed = placed.view(b, c, p_dim)
    if not with_free_after:
        return (alloc, placed, free_after), (0, 0, None)
    return (alloc, placed, free_after.view(b, c, n, r)), (0, 0, 0)


def fill_batch(free, mask, demand, count, with_free_after=True):
    """The fill of C gangs on the tensors' device: the CUDA kernel for CUDA
    tensors, :func:`fill_batch_ref` for CPU tensors. Same arguments and
    results as :func:`fill_batch_ref`. Under ``torch.func.vmap`` the lanes
    fold into the gang axis and one launch serves them all
    (:func:`_fill_vmap`)."""
    if demand.device.type not in ("cuda", "cpu"):
        # before the operator: a meta tensor would reach its fake kernel
        raise ValueError(f"fill_batch: unsupported device {demand.device}")
    alloc, placed, free_after = _fill_op(free, mask, demand, count, with_free_after)
    return alloc, placed, free_after if with_free_after else None


# kernel launches since the last reset, and the gang rows they took (the
# plain CPU path never counts)
fill_batch.launches = 0
fill_batch.rows = 0
