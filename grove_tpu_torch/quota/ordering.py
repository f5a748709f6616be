"""DRF fair-share ordering: a hand-written CUDA scan and its plain twin.

Counterpart of ``grove_tpu/quota/ordering.py``, whose ``fair_order`` runs a
jitted ``lax.scan``. Each step picks the active queue with the lowest
dominant share and emits its next pending gang, charging that gang's demand
to that queue's row before the next step:

    share[q,r] = U[q,r]/D[q,r] where D > 0, else U[q,r]*BIG
    dom[q]     = max_r share[q,r]
    pick       = argmin over queues of (dom if active else +inf), ties to
                 the lowest queue index (queues are sorted by name)
    emit (pick, taken[pick]); U[pick] += demand[pick, taken[pick]]

Steps after every queue drains emit (-1, -1). ``fair_order_scan`` launches
``csrc/drf.cu`` for CUDA tensors and runs ``fair_order_ref`` (a step loop
of the same float32 operations in the same order) for CPU tensors; both are
bit-equal to the JAX scan and to ``quota/oracle.py``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from grove_tpu_torch.ops import _build
from grove_tpu_torch.utils.platform import resolve_device

# float32-safe "worse than any entitled share" multiplier for zero-deserved
# queues (overflow to inf is the same everywhere)
BIG = np.float32(1e18)

MAX_QUEUES = 1024  # one thread per queue in one CTA


def fair_order_ref(deserved, usage, demand, counts, steps: int) -> torch.Tensor:
    """The scan in plain PyTorch: ``steps`` steps over deserved/usage
    ``[Q,R]`` f32, demand ``[Q,G,R]`` f32 and counts ``[Q]`` i32, returning
    ``[steps, 2]`` i32 (queue, slot) rows."""
    q_dim, g_dim = demand.shape[0], demand.shape[1]
    big = torch.tensor(BIG, dtype=torch.float32, device=deserved.device)
    one = torch.ones((), dtype=torch.float32, device=deserved.device)
    entitled = deserved > 0
    safe = torch.where(entitled, deserved, one)
    u = usage.clone()
    taken = torch.zeros((q_dim,), dtype=torch.int32, device=deserved.device)
    out = torch.full((steps, 2), -1, dtype=torch.int32, device=deserved.device)
    for t in range(steps):
        share = torch.where(entitled, u / safe, u * big)
        dom = share.amax(1)
        active = taken < counts
        if not bool(active.any()):
            break
        key = torch.where(active, dom, torch.inf)
        q = int(torch.argmin(key))
        slot = int(taken[q])
        out[t, 0] = q
        out[t, 1] = slot
        u[q] = u[q] + demand[q, min(slot, g_dim - 1)]
        taken[q] += 1
    return out


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"fair_order: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fair_order: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"fair_order: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"fair_order: {name} must be contiguous")


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _kernel():
    lib = _build.load("drf")
    fn = lib.grove_drf_order
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.grove_drf_error_string.argtypes = [ctypes.c_int]
        lib.grove_drf_error_string.restype = ctypes.c_char_p
    return lib, fn


def _fair_order_cuda(deserved, usage, demand, counts, steps):
    q_dim, g_dim, r_dim = demand.shape
    device = demand.device
    if q_dim > MAX_QUEUES:
        raise ValueError(
            f"fair_order: {q_dim} queues; the CUDA kernel takes at most {MAX_QUEUES}"
        )
    _check("deserved", deserved, torch.float32, (q_dim, r_dim), device)
    _check("usage", usage, torch.float32, (q_dim, r_dim), device)
    _check("demand", demand, torch.float32, (q_dim, g_dim, r_dim), device)
    _check("counts", counts, torch.int32, (q_dim,), device)
    u = usage.clone()  # the kernel charges demand into its own copy
    out = torch.empty((steps, 2), dtype=torch.int32, device=device)
    lib, fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            deserved.data_ptr(), u.data_ptr(), demand.data_ptr(), counts.data_ptr(),
            out.data_ptr(), q_dim, g_dim, r_dim, steps, stream,
        )
    if err != 0:
        raise RuntimeError(
            "fair_order kernel launch failed: " + lib.grove_drf_error_string(err).decode()
        )
    fair_order_scan.launches += 1
    return out


def fair_order_scan(deserved, usage, demand, counts, steps: int) -> torch.Tensor:
    """``steps`` steps of the scan on the tensors' device: the CUDA kernel
    for CUDA tensors, :func:`fair_order_ref` for CPU tensors."""
    if demand.device.type == "cuda":
        return _fair_order_cuda(deserved, usage, demand, counts, steps)
    if demand.device.type == "cpu":
        return fair_order_ref(deserved, usage, demand, counts, steps)
    raise ValueError(f"fair_order: unsupported device {demand.device}")


# kernel launches since the last reset (the plain CPU path never counts)
fair_order_scan.launches = 0


def fair_order(
    deserved: np.ndarray,  # [Q, R] float32
    usage: np.ndarray,  # [Q, R] float32
    demand: np.ndarray,  # [Q, G, R] float32, queue-local priority order
    counts: np.ndarray,  # [Q] int32 pending gangs per queue
    device=None,
) -> np.ndarray:
    """The ordering pass on ``device`` (default: the card; raises without
    one). Returns ``[T, 2]`` int32 (queue, slot) rows, T = counts.sum(),
    in solve order: the first T steps of the scan, which are the JAX
    scan's rows trimmed to T."""
    device = resolve_device(device)
    q_dim = deserved.shape[0]
    r_dim = deserved.shape[1] if deserved.ndim == 2 else 0
    g_dim = demand.shape[1] if demand.ndim == 3 else 0
    total = int(counts.sum())
    if total == 0 or q_dim == 0:
        return np.zeros((0, 2), dtype=np.int32)
    if r_dim == 0:
        # degenerate: no resources anywhere -> every share is 0, ordering
        # degrades to deterministic queue-index round-robin via zero tensors
        r_dim = 1
        deserved = np.zeros((q_dim, 1), np.float32)
        usage = np.zeros((q_dim, 1), np.float32)
        demand = np.zeros((q_dim, max(g_dim, 1), 1), np.float32)

    def upload(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    order = fair_order_scan(
        upload(deserved, np.float32),
        upload(usage, np.float32),
        upload(demand, np.float32),
        upload(counts, np.int32),
        total,
    )
    return order.cpu().numpy()
